"""PyTorch port on the card: the CUDA MDCT/IMDCT kernels against their plain
versions (TF32 off) at the tests/test_mdct_pallas.py geometries, the stage
kernels against theirs at the train shape and ragged shapes (GELU+GRN's
single-read kernel) and a long-P shape (its two-pass kernel), the stage ops'
tangents and gradients, and the wrappers' checks. Skips without CUDA. Runs
on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have). Tolerances: rtol 1e-4 / atol 1e-3 for the transforms (their
contract); for the stage kernels, float32 outputs and every statistic at
rtol 1e-4 / atol 1e-5 (the same f32 arithmetic summed in another order),
bf16 outputs at rtol / atol 1e-2 (one bf16 rounding step, 2**-7 relative,
flips where the f32 values differ in their last bits).
"""

import pytest
import torch

from meanflow_audio_codec_torch.ops import imdct_cuda as imdct_cuda_mod
from meanflow_audio_codec_torch.ops import mdct_cuda as mdct_cuda_mod
from meanflow_audio_codec_torch.ops.imdct_cuda import imdct_cuda
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    imdct,
    mdct,
    num_frames_for_length,
)
from meanflow_audio_codec_torch.ops.mdct_cuda import mdct_cuda
from meanflow_audio_codec_torch.ops import stage, stage_cuda

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-4, 1e-3
GEOMETRIES = [
    (8, 48000, 576, 288),
    (3, 10000, 256, 128),
    (2, 5000, 576, 100),
    (1, 2000, 128, 64),
    (5, 300, 512, 256),     # shorter than W: one zero-padded frame
    (8, 32768, 512, 256),   # the codec shape
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,length,window,hop", GEOMETRIES)
def test_mdct_kernel_matches_plain(device, rows, length, window, hop):
    x = torch.randn(rows, length, device=device,
                    generator=torch.Generator(device).manual_seed(rows))
    cfg = MDCTConfig(window, hop)
    before = mdct_cuda_mod.launches
    got = mdct_cuda(x, cfg)
    torch.cuda.synchronize()
    assert mdct_cuda_mod.launches == before + 1
    torch.testing.assert_close(got, mdct(x, cfg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("rows,length,window,hop", GEOMETRIES)
def test_imdct_kernel_matches_plain(device, rows, length, window, hop,
                                    normalize):
    nf = num_frames_for_length(length, window, hop)
    X = torch.randn(rows, nf, window, device=device,
                    generator=torch.Generator(device).manual_seed(hop))
    cfg = MDCTConfig(window, hop, normalize)
    before = imdct_cuda_mod.launches
    got = imdct_cuda(X, cfg)
    torch.cuda.synchronize()
    assert imdct_cuda_mod.launches == before + 1
    torch.testing.assert_close(got, imdct(X, cfg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows,nf,window,hop", [
    (2, 1721, 512, 256),   # the decoder's IMDCT of a stereo 10 s clip
    (2, 40, 126, 50),      # W and hop not multiples of 4: 4-byte copies
    (3, 1, 64, 32),        # one frame
])
def test_imdct_kernel_matches_plain_at_more_shapes(device, rows, nf, window,
                                                   hop):
    X = torch.randn(rows, nf, window, device=device,
                    generator=torch.Generator(device).manual_seed(nf))
    cfg = MDCTConfig(window, hop)
    before = imdct_cuda_mod.launches
    got = imdct_cuda(X, cfg)
    torch.cuda.synchronize()
    assert imdct_cuda_mod.launches == before + 1
    torch.testing.assert_close(got, imdct(X, cfg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows,length,window,hop", [
    (2, 441000, 512, 256),  # the encoder's MDCT of a stereo 10 s clip
    (32, 32768, 512, 256),  # the train step's tokenize of 16 stereo clips
    (2, 5001, 126, 50),     # T, W and hop not multiples of 4: 4-byte copies
    (2, 1001, 64, 24),      # T not a multiple of hop
])
def test_mdct_kernel_matches_plain_at_more_shapes(device, rows, length, window,
                                                  hop):
    x = torch.randn(rows, length, device=device,
                    generator=torch.Generator(device).manual_seed(length))
    cfg = MDCTConfig(window, hop)
    before = mdct_cuda_mod.launches
    got = mdct_cuda(x, cfg)
    torch.cuda.synchronize()
    assert mdct_cuda_mod.launches == before + 1
    torch.testing.assert_close(got, mdct(x, cfg), rtol=RTOL, atol=ATOL)


def test_mdct_kernel_is_bitwise_stable(device):
    x = torch.randn(8, 32768, device=device)
    cfg = MDCTConfig(512)
    assert torch.equal(mdct_cuda(x, cfg), mdct_cuda(x, cfg))


def test_imdct_kernel_is_bitwise_stable(device):
    X = torch.randn(4, 127, 512, device=device)
    cfg = MDCTConfig(512)
    assert torch.equal(imdct_cuda(X, cfg), imdct_cuda(X, cfg))


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    cfg = MDCTConfig(64)
    with pytest.raises(TypeError):
        mdct_cuda(torch.zeros(2, 1000, device=device, dtype=torch.bfloat16),
                  cfg)
    with pytest.raises(ValueError):
        mdct_cuda(torch.zeros(1000, 2, device=device).t(), cfg)
    with pytest.raises(TypeError):
        imdct_cuda(torch.zeros(2, 5, 64, device=device, dtype=torch.float16),
                   cfg)
    with pytest.raises(ValueError):
        imdct_cuda(torch.zeros(2, 5, 32, device=device), cfg)
    with pytest.raises(ValueError):
        mdct_cuda(torch.zeros(2, 1000, device=device), MDCTConfig(64, 80))


@pytest.mark.parametrize("transform,window,hop", [
    # at W = hop = 2048 a span of 32 frames, 31 hops + 2W floats (264 KiB),
    # exceeds the 227 KiB of shared memory a Hopper block may have; the
    # tiled kernels' shared memory does not grow with W or hop
    ("mdct", 2048, 2048),
    ("mdct", 4096, 1024),
    ("imdct", 4096, 1024),
])
def test_kernels_take_windows_past_the_shared_memory_of_one_span(
        device, transform, window, hop):
    gen = torch.Generator(device).manual_seed(0)
    cfg = MDCTConfig(window, hop)
    if transform == "mdct":
        x = torch.randn(1, 4 * window, device=device, generator=gen)
        torch.testing.assert_close(mdct_cuda(x, cfg), mdct(x, cfg), rtol=RTOL,
                                   atol=ATOL)
    else:
        X = torch.randn(1, 2, window, device=device, generator=gen)
        torch.testing.assert_close(imdct_cuda(X, cfg), imdct(X, cfg),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# stage kernels (csrc/stage.cu)
# ---------------------------------------------------------------------------

STAGE_SHAPES = [
    (2032, 64, 256),  # the frontier-v2 train shape (LN; GRN runs at 2C)
    (3, 9, 40),       # ragged, 16-byte loads
    (3, 9, 41),       # ragged, scalar loads
    (1, 1, 1),
    (4, 256, 256),    # long P: GRN takes its two-pass kernel
]
STAGE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


def _stage_inputs(device, n, p, c, dtype, seed=0):
    gen = torch.Generator(device).manual_seed(seed)
    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=device)
                ).to(dtype)
    return (rand(n, p, c, scale=2.0), rand(n, c, scale=0.3),
            rand(n, c, scale=0.3))


def _launched(name, fn):
    before = stage_cuda.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert stage_cuda.launches[name] == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p,c", STAGE_SHAPES)
def test_ln_kernels_match_plain(device, n, p, c, dtype):
    x, s, b = _stage_inputs(device, n, p, c, dtype)
    got = _launched("ln_film_cuda", lambda: stage_cuda.ln_film_cuda(x, s, b))
    ref = stage._ln_film_ref(x, s, b)
    torch.testing.assert_close(got[0], ref[0], **STAGE_TOL[dtype])
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r, **STATS_TOL)
    got = _launched("ln_norm_cuda", lambda: stage_cuda.ln_norm_cuda(x))
    ref = stage._ln_norm_ref(x)
    torch.testing.assert_close(got[0], ref[0], **STAGE_TOL[dtype])
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r, **STATS_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p,c", STAGE_SHAPES)
def test_gelu_grn_kernel_matches_plain(device, n, p, c, dtype):
    c = 2 * c if n == 2032 else c
    x, _, _ = _stage_inputs(device, n, p, c, dtype)
    gen = torch.Generator(device).manual_seed(1)
    gamma = 0.5 * torch.randn(c, generator=gen, device=device)
    beta = 0.1 * torch.randn(c, generator=gen, device=device)
    variant = "two_pass" if p == 256 else "single_read"
    assert stage_cuda.gelu_grn_variant(x) == variant
    before = dict(stage_cuda.gelu_grn_variants)
    got = _launched("gelu_grn_cuda",
                    lambda: stage_cuda.gelu_grn_cuda(x, gamma, beta))
    assert stage_cuda.gelu_grn_variants == {
        k: v + (k == variant) for k, v in before.items()}
    ref = stage._gelu_grn_ref(x, gamma, beta)
    torch.testing.assert_close(got[0], ref[0], **STAGE_TOL[dtype])
    torch.testing.assert_close(got[1], ref[1], **STATS_TOL)


def _chain(fn):
    """The plain version's ``y`` as a function PyTorch differentiates."""
    return lambda *args: fn(*args)[0]


@pytest.mark.parametrize("op,ref", [
    (stage.fused_ln_film, stage._ln_film_ref),
    (stage.fused_ln_norm, stage._ln_norm_ref),
    (stage.fused_gelu_grn, stage._gelu_grn_ref),
])
def test_stage_ops_tangent_and_gradient_match_plain_autograd(device, op, ref):
    import torch.autograd.forward_ad as fwAD

    n, p, c = 4, 16, 96
    x, s, b = _stage_inputs(device, n, p, c, torch.float32, seed=2)
    tx, ts, tb = _stage_inputs(device, n, p, c, torch.float32, seed=3)
    if op is stage.fused_gelu_grn:
        s, b, ts, tb = s[0], b[0], ts[0], tb[0]
    args, tangents = ((x, s, b), (tx, ts, tb))
    if op is stage.fused_ln_norm:
        args, tangents = (x,), (tx,)
    outs = []
    for fn in (op, _chain(ref)):
        with fwAD.dual_level():
            duals = [fwAD.make_dual(a, t) for a, t in zip(args, tangents)]
            y, ty = fwAD.unpack_dual(fn(*duals))
        leaves = [a.clone().requires_grad_() for a in args]
        grads = torch.autograd.grad(torch.sin(fn(*leaves)).sum(), leaves)
        outs.append((y, ty, grads))
    torch.testing.assert_close(outs[0][0], outs[1][0], **STATS_TOL)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-4, atol=1e-4)
    for g, r in zip(outs[0][2], outs[1][2]):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


def test_stage_wrappers_reject_what_the_kernels_do_not_take(device):
    x = torch.zeros(2, 4, 8, device=device)
    s = torch.zeros(2, 8, device=device)
    with pytest.raises(TypeError):
        stage_cuda.ln_norm_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        stage_cuda.ln_norm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError):
        stage_cuda.ln_film_cuda(x.bfloat16(), s, s)
    with pytest.raises(ValueError, match="shape"):
        stage_cuda.ln_film_cuda(x, s[:1], s)
    with pytest.raises(ValueError, match="shape"):
        stage_cuda.gelu_grn_cuda(x, s[0, :4], s[0])
