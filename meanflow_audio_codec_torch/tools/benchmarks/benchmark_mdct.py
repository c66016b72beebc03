"""MDCT benchmark: the NumPy baseline, the plain direct transform (framing +
one matmul), the MDCT kernel on the card and (on the CPU) the FFT path,
across signal/window configurations.

Counterpart of ``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_mdct.py``.
``kernel`` is the column of the TPU's path: the tokenizer takes the Pallas
kernel there and ``ops/mdct_cuda`` (``csrc/mdct.cu``, launches counted) on
the card; each kernel column is first held against the direct transform
(rtol 1e-4 / atol 1e-3), and a disagreement is an error row. One JSON row
per configuration::

    {"T", "W", "numpy_ms", "direct_ms", "speedup", "kernel_ms",
     "kernel_max_abs_err"}                          # card
    {..., "fft_ms"}                                 # CPU

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_mdct
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    mdct_direct,
    mdct_fft,
)
from meanflow_audio_codec_torch.ops.mdct_cuda import mdct_cuda
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    start,
    sweep,
    time_calls,
)

CONFIGS = [  # (signal_length, window_size)
    (2048, 512), (16384, 512), (65536, 1024), (65536, 4096),
]
ITERS = 10
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-3


def _numpy_baseline(x: np.ndarray, window: int, hop: int) -> np.ndarray:
    w = np.sin(np.pi * (np.arange(2 * window) + 0.5) / (2 * window))
    n = np.arange(2 * window)[:, None]
    k = np.arange(window)[None, :]
    basis = np.cos(np.pi / window * (n + window / 2 + 0.5) * (k + 0.5))
    nf = (x.shape[-1] - window) // hop + 1
    need = (nf - 1) * hop + 2 * window
    x = np.pad(x, ((0, 0), (0, max(0, need - x.shape[-1]))))
    return np.stack([(x[:, i * hop:i * hop + 2 * window] * w) @ basis
                     for i in range(nf)], 1)


def bench_config(length: int, window: int, batch: int, device: torch.device,
                 fft: bool, rng: np.random.Generator) -> dict:
    hop = window // 2
    cfg = MDCTConfig(window, hop)
    x_np = rng.standard_normal((batch, length)).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)
    t0 = time.perf_counter()
    for _ in range(2):
        _numpy_baseline(x_np, window, hop)
    t_np = (time.perf_counter() - t0) / 2
    t_direct = time_calls(lambda: mdct_direct(x, cfg), device, ITERS)
    row = {"T": length, "W": window, "numpy_ms": round(t_np * 1e3, 2),
           "direct_ms": round(t_direct * 1e3, 3),
           "speedup": round(t_np / t_direct, 1)}
    if device.type == "cuda":
        got, ref = mdct_cuda(x, cfg), mdct_direct(x, cfg)
        row["kernel_max_abs_err"] = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        t_kernel = time_calls(lambda: mdct_cuda(x, cfg), device, ITERS)
        row["kernel_ms"] = round(t_kernel * 1e3, 3)
    elif fft:
        row["fft_ms"] = round(time_calls(lambda: mdct_fft(x, cfg), device,
                                         ITERS) * 1e3, 3)
    return row


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--skip-fft", action="store_true",
                        help="skip the FFT path (timed on the CPU only, as "
                             "the JAX script times it off the TPU)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    rng = np.random.default_rng(0)
    return sweep(({"T": length, "W": window},
                  lambda length=length, window=window: bench_config(
                      length, window, args.batch, device, not args.skip_fft,
                      rng))
                 for length, window in CONFIGS)


if __name__ == "__main__":
    raise SystemExit(main())
