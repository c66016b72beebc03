"""The ConvNeXt stage's normalisation segments through the hand-written CUDA
kernels of ``csrc/stage.cu``.

Counterpart of the Pallas kernels ``_ln_film_pallas``, ``_ln_norm_pallas`` and
``_gelu_grn_pallas`` in ``meanflow_audio_codec_tpu/ops/stage_pallas.py``. A CPU
tensor goes to the plain version (``ops/stage_ref.py``); a CUDA tensor goes to
the kernel, or the wrapper raises. ``launches`` counts kernel launches per
wrapper. Unlike the TPU kernels, these take any shape: nothing here tiles
by the TPU's (8, 128) layout. GELU+GRN has three kernels, chosen by shape
alone (``gelu_grn_variant``): the single read, the single read spread over
a thread-block cluster (``gelu_grn_split`` blocks a row) and the two-pass
kernel; ``gelu_grn_variants`` counts each one's launches, and
``launches["gelu_grn_cuda"]`` counts all three.
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
gelu_grn_variants = {"single_read": 0, "cluster": 0, "two_pass": 0}

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
        "gelu_grn_cluster_forward": [_P, _P, _P, _P, _P, _I64, _I32, _I32,
                                     _I32, _P],
        "gelu_grn_two_pass_forward": [_P, _P, _P, _P, _P, _I64, _I32, _I32,
                                      _I32, _P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


#: P and C of a launch stay below this (the kernels index them as int)
_MAX_EXTENT = 2**31


def takes(positions: int, channels: int, dtype: torch.dtype) -> bool:
    """Whether the wrappers take a CUDA tensor ``[N, positions, channels]``
    of ``dtype``: float32 or bfloat16, both extents below 2**31. ``_check``
    raises exactly where this is False. A tensor with an empty extent is
    taken and launches nothing; the grid's row limit (``kErrGrid``)
    depends on N as well and is checked at launch."""
    return dtype in _DTYPES and max(positions, channels) < _MAX_EXTENT


def _check(name: str, x3: torch.Tensor, *others: tuple[str, torch.Tensor,
                                                        tuple[int, ...]]) -> int:
    """Validate a CUDA call's tensors; return the dtype code of ``x3``."""
    if x3.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x3.device}")
    if x3.ndim != 3:
        raise ValueError(f"{name} takes x of shape [N, P, C], got "
                         f"{tuple(x3.shape)}")
    if not takes(x3.shape[1], x3.shape[2], x3.dtype):
        raise (ValueError if x3.dtype in _DTYPES else TypeError)(
            f"{name} takes float32 or bfloat16 with P and C below 2**31, "
            f"got {x3.dtype} of shape {tuple(x3.shape)}")
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
_ERR_CLUSTER = -4  # kErrCluster
_ERR_TENSOR_MAP = -5  # kErrTensorMap
# the single-read GELU+GRN kernel: g values a thread holds, threads a block
# has (kGrnHeld, kGrnSingleThreads in csrc/stage.cu), blocks a row may be
# spread over (up to kGrnMaxSplit), bytes a cluster chunk's rows come in
# (kGrnBoxAlign)
_GRN_HELD, _GRN_THREADS = 64, 512
_GRN_SPLITS, _GRN_BOX_ALIGN = (1, 2, 4, 8), 128

def _raise_on(err: int, name: str) -> None:
    if err == _ERR_GRID:
        raise ValueError(f"{name}: more rows than one launch grid holds")
    if err == _ERR_SHAPE:
        raise ValueError(f"{name}: the shape belongs to another GELU+GRN "
                         "kernel")
    if err == _ERR_CLUSTER:
        raise RuntimeError(f"{name}: no cluster of the planned size can be "
                           "resident on this card")
    if err == _ERR_TENSOR_MAP:
        raise RuntimeError(f"{name}: the driver refused the TMA tensor map")
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


def single_read_groups(positions: int, channels: int, v: int) -> int:
    """The single-read kernel's position groups PG for a [positions,
    channels] slice read ``v`` values at a time, or 0 when some thread of a
    512-thread block would hold more than 64 values of it
    (``single_read_plan`` in csrc/stage.cu)."""
    if positions < 1 or channels % v or channels // v > _GRN_THREADS:
        return 0
    groups = min(_GRN_THREADS // (channels // v), positions)
    return groups if -(-positions // groups) * v <= _GRN_HELD else 0


def gelu_grn_split(x3: torch.Tensor) -> int:
    """How many blocks the single-read GELU+GRN kernel spreads a batch row
    of ``x3`` [N, P, C] over: the smallest of 1, 2, 4, 8 whose chunk of C/k
    channels fits one block (``single_read_groups``), where k > 1 needs
    16-byte loads (x aligned) and C/k values a multiple of 128 bytes (the
    kernel's TMA boxes); 0 when none fits. Mirrors ``grn_plan`` in
    csrc/stage.cu."""
    _, p, c = x3.shape
    vec = 16 // x3.element_size()
    v = 1 if c % vec or x3.data_ptr() % 16 else vec  # y is fresh and aligned
    for k in _GRN_SPLITS:
        if k > 1 and (v == 1 or c % (k * _GRN_BOX_ALIGN // x3.element_size())):
            break
        if single_read_groups(p, c // k, v):
            return k
    return 0


def gelu_grn_variant(x3: torch.Tensor) -> str:
    """Which GELU+GRN kernel takes ``x3`` [N, P, C]: ``"single_read"`` when
    one block's threads hold a whole [P, C] slice in registers,
    ``"cluster"`` when a cluster of 2, 4 or 8 blocks holds it
    (``gelu_grn_split``), else ``"two_pass"``."""
    k = gelu_grn_split(x3)
    return {0: "two_pass", 1: "single_read"}.get(k, "cluster")


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
