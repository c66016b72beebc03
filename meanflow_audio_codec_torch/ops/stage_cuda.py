"""The ConvNeXt stage's normalisation segments through the hand-written CUDA
kernels of ``csrc/stage.cu``.

Counterpart of the Pallas kernels ``_ln_film_pallas``, ``_ln_norm_pallas`` and
``_gelu_grn_pallas`` in ``meanflow_audio_codec_tpu/ops/stage_pallas.py``. A CPU
tensor goes to the plain version (``ops/stage_ref.py``); a CUDA tensor goes to
the kernel, or the wrapper raises. ``launches`` counts kernel launches per
wrapper. Unlike the TPU kernels, these take any shape: nothing here tiles
by the TPU's (8, 128) layout. GELU+GRN has two kernels, chosen by shape
alone (``gelu_grn_variant``); ``gelu_grn_variants`` counts each one's
launches, and ``launches["gelu_grn_cuda"]`` counts both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from meanflow_audio_codec_torch.ops import _build
from meanflow_audio_codec_torch.ops import stage_ref

#: kernel launches per wrapper since the counts were last set to 0
launches = {"ln_film_cuda": 0, "ln_norm_cuda": 0, "gelu_grn_cuda": 0}
#: GELU+GRN launches per kernel since the counts were last set to 0
gelu_grn_variants = {"single_read": 0, "two_pass": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # kF32 / kBF16 in csrc/stage.cu
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


@functools.cache
def _kernels():
    lib = _build.library("stage")
    signatures = {
        # x, scale, shift, y, mu, r, rows, P, C, dtype, stream
        "ln_film_forward": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P],
        # x, y, mu, r, rows, C, dtype, stream
        "ln_norm_forward": [_P, _P, _P, _P, _I64, _I32, _I32, _P],
        # x, gamma, beta, y, gx, N, P, C, dtype, stream
        "gelu_grn_single_read_forward": [_P, _P, _P, _P, _P, _I64, _I32, _I32,
                                         _I32, _P],
        "gelu_grn_two_pass_forward": [_P, _P, _P, _P, _P, _I64, _I32, _I32,
                                      _I32, _P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, x3: torch.Tensor, *others: tuple[str, torch.Tensor,
                                                        tuple[int, ...]]) -> int:
    """Validate a CUDA call's tensors; return the dtype code of ``x3``."""
    if x3.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x3.device}")
    if x3.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x3.dtype}")
    if x3.ndim != 3:
        raise ValueError(f"{name} takes x of shape [N, P, C], got "
                         f"{tuple(x3.shape)}")
    if max(x3.shape[1:]) >= 2**31:
        raise ValueError(f"{name}: P and C must each be below 2**31")
    for label, t, shape in ((("x", x3, tuple(x3.shape)),) + others):
        if t.device != x3.device:
            raise ValueError(f"{name}: {label} is on {t.device}, x on "
                             f"{x3.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    return _DTYPES[x3.dtype]


_ERR_GRID = -1  # kErrGrid in csrc/stage.cu
_ERR_SHAPE = -3  # kErrShape
# the single-read GELU+GRN kernel: g values a thread holds, threads a block
# has (kGrnHeld, kGrnSingleThreads in csrc/stage.cu)
_GRN_HELD, _GRN_THREADS = 64, 512

def _raise_on(err: int, name: str) -> None:
    if err == _ERR_GRID:
        raise ValueError(f"{name}: more rows than one launch grid holds")
    if err == _ERR_SHAPE:
        raise ValueError(f"{name}: the slice does not fit the single-read "
                         "kernel")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def ln_film_cuda(x3: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over C + FiLM: [N,P,C], [N,C], [N,C] -> (y, mu [N,P], r [N,P]).

    ``scale`` and ``shift`` have ``x3``'s dtype; ``mu`` and ``r`` are float32.
    """
    if x3.device.type == "cpu":
        return stage_ref._ln_film_ref(x3, scale, shift)
    n, p, c = x3.shape
    code = _check("ln_film_cuda", x3, ("scale", scale, (n, c)),
                  ("shift", shift, (n, c)))
    if scale.dtype != x3.dtype or shift.dtype != x3.dtype:
        raise TypeError("ln_film_cuda takes scale and shift in x's dtype, got "
                        f"{scale.dtype}, {shift.dtype} for {x3.dtype}")
    y = torch.empty_like(x3)
    mu = torch.empty((n, p), dtype=torch.float32, device=x3.device)
    r = torch.empty_like(mu)
    if y.numel() == 0:
        return y, mu, r
    with torch.cuda.device(x3.device):
        err = _kernels().ln_film_forward(
            x3.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            mu.data_ptr(), r.data_ptr(), n * p, p, c, code, _stream(x3))
    _raise_on(err, "ln_film")
    launches["ln_film_cuda"] += 1
    return y, mu, r


def ln_norm_cuda(x3: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over C: [N,P,C] -> (y, mu [N,P], r [N,P]); stats float32."""
    if x3.device.type == "cpu":
        return stage_ref._ln_norm_ref(x3)
    code = _check("ln_norm_cuda", x3)
    n, p, c = x3.shape
    y = torch.empty_like(x3)
    mu = torch.empty((n, p), dtype=torch.float32, device=x3.device)
    r = torch.empty_like(mu)
    if y.numel() == 0:
        return y, mu, r
    with torch.cuda.device(x3.device):
        err = _kernels().ln_norm_forward(
            x3.data_ptr(), y.data_ptr(), mu.data_ptr(), r.data_ptr(), n * p,
            c, code, _stream(x3))
    _raise_on(err, "ln_norm")
    launches["ln_norm_cuda"] += 1
    return y, mu, r


def gelu_grn_variant(x3: torch.Tensor) -> str:
    """Which GELU+GRN kernel takes ``x3`` [N, P, C]: ``"single_read"`` when
    each thread of one block can hold its share of a [P, C] slice in
    registers (as ``single_read_plan`` in csrc/stage.cu decides), else
    ``"two_pass"``."""
    _, p, c = x3.shape
    v = 16 // x3.element_size()
    if c % v or x3.data_ptr() % 16:  # y is a fresh, aligned allocation
        v = 1
    vectors = c // v
    if p < 1 or vectors > _GRN_THREADS:
        return "two_pass"
    groups = min(_GRN_THREADS // vectors, p)
    return "single_read" if -(-p // groups) * v <= _GRN_HELD else "two_pass"


def gelu_grn_cuda(x3: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tanh-GELU + GRN: [N,P,C], [C], [C] -> (y, gx [N,C] float32).

    ``gamma`` and ``beta`` are read as float32 (the model keeps its
    parameters in float32).
    """
    if x3.device.type == "cpu":
        return stage_ref._gelu_grn_ref(x3, gamma, beta)
    n, p, c = x3.shape
    gamma32 = gamma.float().contiguous()
    beta32 = beta.float().contiguous()
    code = _check("gelu_grn_cuda", x3, ("gamma", gamma32, (c,)),
                  ("beta", beta32, (c,)))
    y = torch.empty_like(x3)
    gx = torch.empty((n, c), dtype=torch.float32, device=x3.device)
    if n * c == 0:
        return y, gx
    variant = gelu_grn_variant(x3)
    with torch.cuda.device(x3.device):
        err = getattr(_kernels(), f"gelu_grn_{variant}_forward")(
            x3.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), y.data_ptr(),
            gx.data_ptr(), n, p, c, code, _stream(x3))
    _raise_on(err, f"gelu_grn ({variant})")
    launches["gelu_grn_cuda"] += 1
    gelu_grn_variants[variant] += 1
    return y, gx
