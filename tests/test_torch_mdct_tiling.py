"""The MDCT kernel's decomposition (csrc/mdct.cu, csrc/tile_core.cuh),
emulated in plain PyTorch on the CPU, against the JAX package's Pallas MDCT
in interpret mode, its direct path and the port's plain ``mdct``.

The emulation repeats the kernel's index arithmetic: all rows' frame slots
numbered g = r*chunks + f (chunks = nf + kf - 1) as one GEMM whose A operand
reads hop-sized chunk u = g + j as x[u // chunks, (u % chunks)*hop + t]
(zeros at or past the row's end T, for t >= hop and for u outside
[0, rows*chunks)); blocks of bm slots x bn coefficients; K walked in stages
of bk samples x jb slices (slice block by slice block, samples inner) with
the jb slices reading one staged chunk window as shifted views; each stage's
samples split over `groups` partial tiles summed in group order; stores
masked to f < nf. Tile sizes include ones that divide nothing in the shapes.
Tolerance: rtol 1e-4 / atol 1e-3, the transform contract (float32, another
summation order).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.ops.mdct_pallas import mdct_pallas
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    mdct,
    num_frames_for_length,
    windowed_basis,
)

jmdct = importlib.import_module("meanflow_audio_codec_tpu.ops.mdct")

RTOL, ATOL = 1e-4, 1e-3
KERNEL_TILES = (32, 64, 32, 4, 8)  # kBM, kBN, kBK, kJB, kGroups


def mdct_tiled(x: torch.Tensor, cfg: MDCTConfig, bm: int, bn: int, bk: int,
               jb: int, groups: int) -> torch.Tensor:
    """[rows, T] -> [rows, nf, W] by the kernel's tiling."""
    rows, length = x.shape
    w, hop = cfg.window_size, cfg.hop_size
    nf = num_frames_for_length(length, w, hop)
    kf = -(-2 * w // hop)
    chunks = nf + kf - 1
    total = rows * chunks
    wb = windowed_basis(w)
    flat = x.reshape(-1)
    t_steps, j_blocks = -(-hop // bk), -(-kf // jb)
    out = torch.full((rows, nf, w), float("nan"))
    g0 = torch.arange(0, total, bm)  # every block's first slot at once
    for n0 in range(0, w, bn):
        part = torch.zeros(groups, len(g0), bm, bn)
        for step in range(t_steps * j_blocks):
            j0, t0 = (step // t_steps) * jb, (step % t_steps) * bk
            t = t0 + torch.arange(bk)
            # A window: chunk u = g0 + j0 + row, row < bm + jb - 1
            u = g0[:, None] + j0 + torch.arange(bm + jb - 1)
            r = torch.div(u, chunks, rounding_mode="floor")
            s = ((u - r * chunks) * hop)[..., None] + t  # sample in row r
            ok_a = (u < total)[..., None] & (t < hop) & (s < length)
            src = (r[..., None] * length + s).clamp(0, rows * length - 1)
            a = torch.where(ok_a, flat[src], 0.0)
            # B: slice j0 + jj, sample t, coefficient n0 + n
            jj = torch.arange(jb)[:, None, None]
            n = n0 + torch.arange(bn)[None, None, :]
            row = (j0 + jj) * hop + t[None, :, None]
            ok_b = (t[None, :, None] < hop) & (row < 2 * w) & (n < w)
            b = torch.where(ok_b, wb[row.clamp(max=2 * w - 1),
                                     n.clamp(max=w - 1)], 0.0)
            per = bk // groups
            for q in range(groups):
                ks = slice(q * per, (q + 1) * per)
                for sl in range(jb):  # tile slot cl reads row cl + sl
                    part[q] += a[:, sl:sl + bm, ks] @ b[sl, ks]
        tile = part[0]
        for q in range(1, groups):
            tile = tile + part[q]
        g = g0[:, None, None] + torch.arange(bm)[None, :, None]
        n = n0 + torch.arange(bn)[None, None, :]
        r = torch.div(g, chunks, rounding_mode="floor")
        f = g - r * chunks
        ok = (g < total) & (f < nf) & (n < w)
        ok, r, f, n = torch.broadcast_tensors(ok, r, f, n)
        out[r[ok], f[ok], n[ok]] = tile[ok]
    return out


CASES = [
    # rows, T, W, hop
    (2, 2000, 512, 256),   # the codec's W and hop
    (2, 1000, 576, 100),   # kf = 12: hop does not divide 2W, 3 slice blocks
    (3, 50, 64, 32),       # T < W: one zero-padded frame
    (2, 1001, 64, 24),     # T not a multiple of hop (nor of 4)
]
TILES = [
    KERNEL_TILES,
    (5, 24, 12, 3, 4),     # divides none of the shapes
    (7, 40, 8, 5, 2),
]


@functools.cache
def _references(rows, length, window, hop):
    """(signal, [Pallas interpret, direct, plain]) for one case."""
    x = np.random.default_rng(length + hop).standard_normal(
        (rows, length)).astype(np.float32)
    pallas = np.asarray(mdct_pallas(
        jnp.asarray(x), config=jmdct.MDCTConfig(window, hop), interpret=True))
    direct = np.asarray(jmdct._mdct_direct(jnp.asarray(x), window, hop))
    plain = mdct(torch.from_numpy(x), MDCTConfig(window, hop)).numpy()
    return x, (pallas, direct, plain)


@pytest.mark.parametrize("bm,bn,bk,jb,groups", TILES, ids=str)
@pytest.mark.parametrize("rows,length,window,hop", CASES, ids=str)
def test_kernel_tiling_matches_jax_and_plain(rows, length, window, hop, bm, bn,
                                             bk, jb, groups):
    x, refs = _references(rows, length, window, hop)
    got = mdct_tiled(torch.from_numpy(x), MDCTConfig(window, hop), bm, bn, bk,
                     jb, groups)
    assert not torch.isnan(got).any(), "a coefficient was written by no block"
    nf = num_frames_for_length(length, window, hop)
    for ref in refs:
        assert got.shape == ref.shape == (rows, nf, window)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
