"""Image-domain generation metrics: Fréchet distance, KID, PSNR, SSIM.

Counterpart of ``meanflow_audio_codec_tpu/evaluators/metrics.py``: the same
numpy code on the host, so the same float results. FID takes the PSD matrix
square root by an eigendecomposition, KID is the unbiased polynomial-kernel
MMD estimator over random subsets, PSNR infers the data range, SSIM is
windowed per channel.
"""

from __future__ import annotations

import numpy as np


def _psd_sqrtm(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a PSD matrix via eigh, clipping tiny negatives."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(features_a: np.ndarray,
                     features_b: np.ndarray) -> float:
    """Fréchet distance between Gaussian fits of two feature sets [N, D].

    d^2 = ||mu_a - mu_b||^2 + tr(Ca + Cb - 2 (Ca Cb)^1/2)
    """
    features_a = np.asarray(features_a, dtype=np.float64)
    features_b = np.asarray(features_b, dtype=np.float64)
    mu_a, mu_b = features_a.mean(0), features_b.mean(0)
    cov_a = np.cov(features_a, rowvar=False)
    cov_b = np.cov(features_b, rowvar=False)
    cov_a = np.atleast_2d(cov_a)
    cov_b = np.atleast_2d(cov_b)
    # (Ca Cb)^1/2 computed symmetrically: S = Ca^1/2; sqrtm(S Cb S)
    sqrt_a = _psd_sqrtm(cov_a)
    middle = _psd_sqrtm(sqrt_a @ cov_b @ sqrt_a)
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b)
                 - 2.0 * np.trace(middle))


#: alias used throughout the tools layer
fid = frechet_distance


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Polynomial kernel (x.y / d + 1)^3 (standard KID kernel)."""
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def kernel_inception_distance(features_a: np.ndarray, features_b: np.ndarray,
                              num_subsets: int = 10, subset_size: int = 100,
                              seed: int = 0) -> float:
    """Unbiased MMD^2 estimate averaged over random subsets [N, D]."""
    features_a = np.asarray(features_a, dtype=np.float64)
    features_b = np.asarray(features_b, dtype=np.float64)
    rng = np.random.default_rng(seed)
    n = min(subset_size, len(features_a), len(features_b))
    if n < 2:
        raise ValueError("KID needs at least 2 samples per set")
    estimates = []
    for _ in range(num_subsets):
        x = features_a[rng.choice(len(features_a), n, replace=False)]
        y = features_b[rng.choice(len(features_b), n, replace=False)]
        k_xx = _poly_kernel(x, x)
        k_yy = _poly_kernel(y, y)
        k_xy = _poly_kernel(x, y)
        np.fill_diagonal(k_xx, 0.0)
        np.fill_diagonal(k_yy, 0.0)
        mmd = (k_xx.sum() / (n * (n - 1)) + k_yy.sum() / (n * (n - 1))
               - 2.0 * k_xy.mean())
        estimates.append(mmd)
    return float(np.mean(estimates))


kid = kernel_inception_distance


def _infer_data_range(*arrays: np.ndarray) -> float:
    """Data range heuristic: [-1,1] -> 2, [0,1] -> 1, uint8-like -> 255."""
    lo = min(float(a.min()) for a in arrays)
    hi = max(float(a.max()) for a in arrays)
    if hi > 10.0:
        return 255.0
    if lo < -0.5:
        return 2.0
    return 1.0


def psnr(reference: np.ndarray, test: np.ndarray,
         data_range: float | None = None) -> float:
    """Peak signal-to-noise ratio in dB."""
    reference = np.asarray(reference, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    if data_range is None:
        data_range = _infer_data_range(reference, test)
    mse = np.mean((reference - test) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    window = np.outer(g, g)
    return window / window.sum()


def _filter2d(image: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Valid-mode 2-d correlation via stride tricks (no scipy dependency in
    the hot path)."""
    k = window.shape[0]
    h, w = image.shape
    windows = np.lib.stride_tricks.sliding_window_view(image, (k, k))
    return np.einsum("ijkl,kl->ij", windows, window)


def ssim(reference: np.ndarray, test: np.ndarray,
         data_range: float | None = None, window_size: int = 11,
         sigma: float = 1.5) -> float:
    """Mean structural similarity with a Gaussian window, per channel."""
    reference = np.asarray(reference, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    if reference.shape != test.shape:
        raise ValueError(f"shape mismatch {reference.shape} vs {test.shape}")
    if data_range is None:
        data_range = _infer_data_range(reference, test)
    if reference.ndim == 2:
        reference, test = reference[..., None], test[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    window = _gaussian_window(window_size, sigma)
    values = []
    for ch in range(reference.shape[-1]):
        x, y = reference[..., ch], test[..., ch]
        mu_x = _filter2d(x, window)
        mu_y = _filter2d(y, window)
        mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sigma_x = _filter2d(x * x, window) - mu_xx
        sigma_y = _filter2d(y * y, window) - mu_yy
        sigma_xy = _filter2d(x * y, window) - mu_xy
        ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
            (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
        values.append(ssim_map.mean())
    return float(np.mean(values))


def batch_psnr(reference: np.ndarray, test: np.ndarray, **kwargs) -> float:
    """Mean PSNR over a batch of images [N, ...]."""
    return float(np.mean([psnr(r, t, **kwargs)
                          for r, t in zip(reference, test)]))


def batch_ssim(reference: np.ndarray, test: np.ndarray, **kwargs) -> float:
    """Mean SSIM over a batch of images [N, H, W(, C)]."""
    return float(np.mean([ssim(r, t, **kwargs)
                          for r, t in zip(reference, test)]))
