"""The IMDCT kernel's decomposition (csrc/imdct.cu, csrc/tile_core.cuh),
emulated in plain PyTorch on the CPU, against the JAX package's Pallas IMDCT
in interpret mode, its direct path and the port's plain ``imdct``.

The emulation repeats the kernel's index arithmetic: all rows' hop-sized
output chunks numbered g = r*chunks + c as one GEMM whose A operand reads
"frame" u = g - j as X[u // chunks, u % chunks] (zeros when u % chunks >= nf
or u lies outside [0, rows*chunks)); blocks of bm chunks x bn samples; K
walked in stages of bk coefficients x jb slices (slice block by slice
block, coefficients inner) with the jb slices reading one staged frame
window as shifted views; each stage's coefficients split
over `groups` partial tiles summed in group order; masked stores. Tile sizes
include ones that divide nothing in the shapes. Tolerance: rtol 1e-4 / atol
1e-3, the transform contract (float32, another summation order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.ops.imdct_pallas import imdct_pallas
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    imdct,
    imdct_scale,
    output_length,
    windowed_basis,
)

jmdct = importlib.import_module("meanflow_audio_codec_tpu.ops.mdct")

RTOL, ATOL = 1e-4, 1e-3
KERNEL_TILES = (32, 64, 32, 4, 8)  # kBM, kBN, kBK, kJB, kGroups


def imdct_tiled(X: torch.Tensor, cfg: MDCTConfig, bm: int, bn: int, bk: int,
                jb: int, groups: int) -> torch.Tensor:
    """[rows, nf, W] -> [rows, out_len] by the kernel's tiling."""
    rows, nf, w = X.shape
    hop = cfg.hop_size
    kf = -(-2 * w // hop)
    chunks = nf + kf - 1
    total = rows * chunks
    out_len = output_length(nf, w, hop)
    wbt = windowed_basis(w, transposed=True)
    frames = X.reshape(rows * nf, w)
    k_steps, j_blocks = -(-w // bk), -(-kf // jb)
    out = torch.full((rows, out_len), float("nan"))
    g0 = torch.arange(0, total, bm)  # every block's first chunk at once
    for n0 in range(0, hop, bn):
        part = torch.zeros(groups, len(g0), bm, bn)
        for step in range(k_steps * j_blocks):
            j0, k0 = (step // k_steps) * jb, (step % k_steps) * bk
            k = k0 + torch.arange(bk)
            # A window: frame u = g0 - j0 - (jb-1) + row, row < bm + jb - 1
            u = g0[:, None] - j0 - (jb - 1) + torch.arange(bm + jb - 1)
            r = torch.div(u, chunks, rounding_mode="floor")
            f = u - r * chunks
            ok_a = ((u >= 0) & (u < total) & (f < nf))[..., None] & (k < w)
            src = (r * nf + f).clamp(0, rows * nf - 1)
            a = torch.where(ok_a, frames[src][..., k.clamp(max=w - 1)], 0.0)
            # B: slice j0 + jj, coefficient k, sample n0 + n
            jj = torch.arange(jb)[:, None, None]
            n = n0 + torch.arange(bn)[None, None, :]
            col = (j0 + jj) * hop + n
            ok_b = (k[None, :, None] < w) & (n < hop) & (col < 2 * w)
            b = torch.where(ok_b, wbt[k.clamp(max=w - 1)[None, :, None],
                                      col.clamp(max=2 * w - 1)], 0.0)
            per = bk // groups
            for q in range(groups):
                ks = slice(q * per, (q + 1) * per)
                for s in range(jb):  # tile chunk cl reads row cl + jb-1-s
                    rows_s = slice(jb - 1 - s, jb - 1 - s + bm)
                    part[q] += a[:, rows_s, ks] @ b[s, ks]
        tile = part[0]
        for q in range(1, groups):
            tile = tile + part[q]
        g = g0[:, None, None] + torch.arange(bm)[None, :, None]
        n = n0 + torch.arange(bn)[None, None, :]
        r = torch.div(g, chunks, rounding_mode="floor")
        s = (g - r * chunks) * hop + n
        ok = (g < total) & (n < hop) & (s < out_len)
        ok, r, s = torch.broadcast_tensors(ok, r, s)
        out[r[ok], s[ok]] = tile[ok] * imdct_scale(cfg)
    return out


CASES = [
    # rows, nf, W, hop, normalize
    (2, 6, 512, 256, False),   # the codec's W and hop
    (2, 4, 576, 100, False),   # kf = 12: hop does not divide 2W
    (3, 1, 64, 32, False),     # one frame
    (2, 9, 64, 32, True),      # normalize
]
TILES = [
    KERNEL_TILES,
    (5, 24, 12, 3, 4),         # divides none of the shapes
    (7, 40, 8, 5, 2),
]


@pytest.mark.parametrize("bm,bn,bk,jb,groups", TILES, ids=str)
@pytest.mark.parametrize("rows,nf,window,hop,normalize", CASES, ids=str)
def test_kernel_tiling_matches_jax_and_plain(rows, nf, window, hop, normalize,
                                             bm, bn, bk, jb, groups):
    X = np.random.default_rng(nf + hop).standard_normal(
        (rows, nf, window)).astype(np.float32)
    cfg = MDCTConfig(window, hop, normalize)
    got = imdct_tiled(torch.from_numpy(X), cfg, bm, bn, bk, jb, groups)
    assert not torch.isnan(got).any(), "a sample was written by no block"
    got = got.numpy()
    direct = np.asarray(jmdct.imdct_direct(jnp.asarray(X), window, hop))
    if normalize:
        direct = direct * (hop / window)
    pallas = np.asarray(imdct_pallas(
        jnp.asarray(X), config=jmdct.MDCTConfig(window, hop,
                                                normalize=normalize),
        interpret=True))
    plain = imdct(torch.from_numpy(X), cfg).numpy()
    for ref in (pallas, direct, plain):
        assert got.shape == ref.shape == (rows, output_length(nf, window, hop))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
