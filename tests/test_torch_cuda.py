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
flips where the f32 values differ in their last bits). The full-width
corpus config (configs/corpus_rehearsal.json, channels 512) takes one bf16
step on a batch the native loader reads from a FLAC corpus, and one float32
step against the CPU's (relative L2 1e-5 of Adam's first moments). The MLP,
MLP-Mixer and simple-conv flows take one bf16 step on the card against the
same step on the CPU (loss rtol 2e-2, Adam's first moments within relative
L2 5e-2: both devices round every product's inputs and outputs to bf16,
~4e-3 each, but accumulate in other orders, through the JVP's tangents
too); the FFT MDCT/IMDCT (cuFFT) at W 4096 against the CPU's at the
transforms' rtol 1e-4 / atol 1e-3. ``ComprehensiveEvaluator`` on the card
evaluates a float32 frontier-geometry run (W 512, a small ConvNeXt) as on
the CPU (decoded audio within relative L2 1e-5, the same start noise) and
launches the MDCT kernel once per evaluation and the IMDCT once per NFE.
The timing tools: a codec-geometry row launches one MDCT and one IMDCT a
call (and 72 int8 products a quantized call), a fused conv_mfu row the
three stage kernels (the unfused one none), and the profiler records an
int8 GEMM kernel for each of a quantized decoder call's 72 products.
Two gloo ranks on the one card (``tests/torch_ranks.py``) take a
data-parallel step equal to the one-process step (relative L2 1e-5).
``ConvNeXtBlock(drop_path=0.5)`` in training with the same ``keep`` on
the card and the CPU (float32, TF32 off: rtol 1e-4 / atol 1e-5), and one
float32 step of the audio autoencoder trial at its published widths on the
card against the CPU (loss rtol 1e-4, Adam's first moments within relative
L2 1e-5).
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


@pytest.mark.parametrize("op,ref", [
    (stage.fused_ln_film, stage._ln_film_ref),
    (stage.fused_ln_norm, stage._ln_norm_ref),
    (stage.fused_gelu_grn, stage._gelu_grn_ref),
])
def test_stage_ops_grad_of_jvp_matches_plain_autograd(device, op, ref):
    """Reverse mode through the tangent (the objectives without the
    stop-gradient): the kernel path's gradient of sum((u + 0.3 du)^2)
    with respect to x, the parameters and the tangent against autograd of
    the plain version's forward AD, each at rtol 1e-4 and an atol of 1e-4
    times its largest magnitude."""
    import torch.autograd.forward_ad as fwAD

    n, p, c = 4, 16, 96
    x, s, b = _stage_inputs(device, n, p, c, torch.float32, seed=4)
    tx = _stage_inputs(device, n, p, c, torch.float32, seed=5)[0]
    args = {stage.fused_ln_film: (x, s, b), stage.fused_ln_norm: (x,),
            stage.fused_gelu_grn: (x, s[0], b[0])}[op]
    outs = []
    for fn in (op, _chain(ref)):
        leaves = [a.clone().requires_grad_() for a in args]
        v = tx.clone().requires_grad_()
        with fwAD.dual_level(), stage.differentiable_tangents():
            u, du = fwAD.unpack_dual(fn(fwAD.make_dual(leaves[0], v),
                                        *leaves[1:]))
        outs.append(torch.autograd.grad((u + 0.3 * du).square().sum(),
                                        leaves + [v]))
    for g, r in zip(*outs):
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-4 * r.abs().max().item())


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


# ---------------------------------------------------------------------------
# the trainer's pieces on the card: device replay pool, chunk of steps,
# msgpack round trip of a card state
# ---------------------------------------------------------------------------

def _tiny_config():
    """A small float32 frontier-like codec config (W=64 stereo, two
    ConvNeXt stages, coeff_scale 4, gain_norm 0.05, EMA 0.9)."""
    from meanflow_audio_codec_torch.configs import config_from_dict

    return config_from_dict({
        "base": {"batch_size": 2, "n_steps": 10, "base_lr": 1e-3,
                 "weight_decay": 1e-2, "seed": 0, "grad_clip_norm": 1.0,
                 "warmup_steps": 1, "lr_schedule": "cosine"},
        "model": {"noise_dimension": 128, "condition_dimension": 16,
                  "latent_dimension": 8, "num_blocks": 2,
                  "architecture": "convnet",
                  "architecture_options": {"channels": 16, "spatial": 4,
                                           "lift_channels": 8,
                                           "bottleneck_dim": 32}},
        "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                    "tokenization_config": {"window_size": 64,
                                            "gain_norm": 0.05,
                                            "coeff_scale": 4.0}},
        "method": {"method": "improved_mean_flow",
                   "use_improved_mean_flow": True,
                   "time_sampling_full_proportion": 0.25},
        "training": {"ema_decay": 0.9},
        "tpu": {"precision": "float32"}})


def _tiny_train(device):
    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.ops.tokenize import (
        create_tokenization_strategy,
    )
    from meanflow_audio_codec_torch.training.adapter import adapter_from_config
    from meanflow_audio_codec_torch.training.objectives import (
        create_loss_strategy,
    )
    from meanflow_audio_codec_torch.training.optim import (
        TrainState,
        make_optimizer,
    )
    from meanflow_audio_codec_torch.training.train_step import make_multi_step

    cfg = _tiny_config()
    model = create_flow_model(cfg, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                       device=device)
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    return state, make_multi_step(create_loss_strategy(cfg), 2, adapter,
                                  skip_nonfinite=True)


def test_device_pool_on_the_card_equals_the_cpu(device):
    from meanflow_audio_codec_torch.data import audio, device_pool

    def source():
        return audio.synthetic_audio_pipeline(seed=1, frame_size=512,
                                              batch_size=4)

    pools = [device_pool.DeviceReplayPool(source(), pool_clips=12, seed=3,
                                          device=where)
             for where in ("cpu", device)]
    try:
        for k, batch in ((2, 4), (1, 3), (3, 2)):
            cpu, gpu = (pool.sample(k, batch) for pool in pools)
            assert gpu.device.type == "cuda"
            assert torch.equal(gpu.cpu(), cpu)
            assert all(pool.refresh(wait=True) for pool in pools)
            assert torch.equal(pools[1].pool.cpu(), pools[0].pool)
    finally:
        for pool in pools:
            pool.close()


def test_multi_step_on_the_card_matches_the_cpu(device):
    """K = 2 float32 steps in one chunk with the same draws: Adam's first
    moments on the card against the CPU's (relative L2 <= 1e-5, as the
    smoke's step check)."""
    gen = torch.Generator().manual_seed(4)
    t = torch.arange(2048) / 44100.0
    batches = (0.3 * torch.sin(2 * torch.pi * 330.0 * t)[None, None, :, None]
               + 0.2 * torch.randn(2, 2, 2048, 2, generator=gen))
    rows = 2 * ((2048 - 64) // 32 + 1)
    noise = torch.randn(2, rows, 128, generator=gen)
    tr = [torch.rand(2, rows, 1, generator=gen) for _ in range(2)]
    t_, r_ = torch.maximum(*tr), torch.minimum(*tr)
    moments, losses = [], []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the 3x3 convolutions in f32
    try:
        for where in ("cpu", device):
            state, run = _tiny_train(where)
            state, metrics = run(state, batches.to(where),
                                 noise=noise.to(where), t=t_.to(where),
                                 r=r_.to(where))
            assert metrics["update_ok"].all()
            assert state.step == 2
            moments.append(torch.cat([m.reshape(-1).cpu()
                                      for m in state.mu]))
            losses.append(metrics["loss"].cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-4, atol=0)
    rel = ((moments[1] - moments[0]).norm() / moments[0].norm()).item()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("method,fused", [
    (dict(method="flow_matching", use_improved_mean_flow=False), False),
    (dict(method="mean_flow", use_improved_mean_flow=False,
          use_stop_gradient=False), False),
    (dict(method="autoencoder", use_improved_mean_flow=False,
          qat_bits=8), False),
    (dict(use_stop_gradient=False), True),
    (dict(loss_weighting="learned", qat_step_frac=0.5), False),
], ids=["fm", "mf_no_stop_gradient", "ae_qat_bits", "imf_no_stop_gradient_"
        "fused", "imf_learned_qat"])
def test_each_objective_steps_on_the_card_as_on_the_cpu(device, method,
                                                        fused):
    """One float32 train step of each objective with the same draws, with
    both remat switches on: loss rtol 1e-4, Adam's first moments within
    relative L2 1e-5 of the CPU's."""
    import dataclasses

    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.ops.tokenize import (
        create_tokenization_strategy,
    )
    from meanflow_audio_codec_torch.training.adapter import (
        adapter_from_config,
    )
    from meanflow_audio_codec_torch.training.objectives import (
        create_loss_strategy,
    )
    from meanflow_audio_codec_torch.training.optim import (
        TrainState,
        make_optimizer,
    )
    from meanflow_audio_codec_torch.training.train_step import (
        make_train_step,
    )

    base = _tiny_config()
    cfg = dataclasses.replace(
        base, remat=True, architecture_options=dict(
            base.architecture_options, fused_stage=fused, remat=True,
            remat_policy="dots_saveable"), **method)
    objective = create_loss_strategy(cfg)
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    gen = torch.Generator().manual_seed(6)
    audio = 0.3 * torch.randn(2, 2048, 2, generator=gen)
    results = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the 3x3 convolutions in f32
    try:
        for where in ("cpu", device):
            model = create_flow_model(cfg, torch.Generator().manual_seed(0))
            state = TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                               device=where)
            if not results:
                with torch.no_grad():
                    x = adapter.tokenize(audio)
                draws = objective.draw(state.model, x, gen)
            step = make_train_step(objective, adapter, remat=cfg.remat,
                                   skip_nonfinite=True)
            state, metrics = step(state, audio.to(where), **{
                k: v.to(where) for k, v in draws.items()})
            assert metrics["update_ok"]
            results.append((metrics["loss"].cpu(), torch.cat(
                [m.reshape(-1).cpu() for m in state.mu])))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lc, mc), (lg, mg) = results
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=0)
    rel = ((mg - mc).norm() / mc.norm()).item()
    assert rel <= 1e-5, rel


def test_card_state_msgpack_round_trip(device, tmp_path):
    from meanflow_audio_codec_torch import weights
    from meanflow_audio_codec_torch.training import checkpoints

    state, run = _tiny_train(device)
    batches = 0.1 * torch.randn(2, 2, 2048, 2, device=device,
                                generator=torch.Generator(device)
                                .manual_seed(5))
    state, _ = run(state, batches, torch.Generator(device).manual_seed(6))
    path = checkpoints.save_checkpoint(state, tmp_path / "step_00002.msgpack")
    other, _ = _tiny_train(device)
    checkpoints.load_checkpoint(path, other)
    assert other.step == state.step == 2
    for name in ("params", "mu", "nu", "ema"):
        for a, b in zip(getattr(state, name), getattr(other, name)):
            assert b.device.type == "cuda" and torch.equal(a, b), name
    tree = weights.train_state_to_flax(other)
    assert tree["step"] == 2 and tree["ema_params"] is not None


# ---------------------------------------------------------------------------
# serving on the card: the byte path, the rANS coder, streaming
# ---------------------------------------------------------------------------

def _tiny_codecs(device):
    """The same seeded float32 codec on the CPU and on the card."""
    from meanflow_audio_codec_torch.codec import AudioCodec
    from meanflow_audio_codec_torch.models.factories import create_flow_model

    cfg = _tiny_config()
    model = create_flow_model(cfg, generator=torch.Generator().manual_seed(0))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    return (AudioCodec(model, None, cfg, device="cpu"),
            AudioCodec(create_flow_model(cfg), weights, cfg, device=device))


def _clip(batch=2, length=4096, seed=1):
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(length) / 44100.0
    return (0.3 * torch.sin(2 * torch.pi * 440.0 * t)[None, :, None]
            + 0.2 * torch.randn(batch, length, 2, generator=gen))


@pytest.mark.parametrize("kwargs", [dict(bits=8), dict(bits=4),
                                    dict(step_frac=0.5)],
                         ids=["v1-8bit", "v1-4bit", "v2-ecsq"])
def test_byte_path_on_the_card_matches_the_cpu(device, kwargs):
    """encode_bytes / decode_bytes through the MDCT and IMDCT kernels
    against the same float32 codec on the CPU (cuDNN's TF32 off): codes
    within one step at under 1% of positions, and the same bytes decoded
    with the same noise within rtol / atol 1e-3 (the smoke's card-vs-CPU
    codec tolerance)."""
    from meanflow_audio_codec_torch.ops import latent_quant as lq

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu, gpu = _tiny_codecs(device)
        audio = _clip()
        before = (mdct_cuda_mod.launches, imdct_cuda_mod.launches)
        data = gpu.encode_bytes(audio, **kwargs)
        want = cpu.encode_bytes(audio, **kwargs)
        noise = torch.randn(2 * ((4096 - 64) // 32 + 1), 128,
                            generator=torch.Generator().manual_seed(2))
        decoded = gpu.decode_bytes(want, noise=noise)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert mdct_cuda_mod.launches > before[0]
    assert imdct_cuda_mod.launches > before[1]
    assert decoded.device.type == device.type
    a, b = lq.unpack_bitstream(data), lq.unpack_bitstream(want)
    diff = (a.codes.int() - b.codes.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() < 0.01
    torch.testing.assert_close(a.gains, b.gains, rtol=0.03, atol=0)
    torch.testing.assert_close(decoded.cpu(),
                               cpu.decode_bytes(want, noise=noise),
                               rtol=1e-3, atol=1e-3)
    stream = gpu.encode_packed(audio, **kwargs)
    gen = torch.Generator(device).manual_seed(3)
    in_memory = gpu.decode_packed(stream, generator=gen)
    gen = torch.Generator(device).manual_seed(3)
    assert torch.equal(in_memory, gpu.decode_bytes(
        lq.pack_bitstream(stream), generator=gen))
    assert torch.equal(gpu.decode_bytes(data), gpu.decode_bytes(data))


def test_the_rans_coder_builds_into_the_package(device):
    import numpy as np

    from meanflow_audio_codec_torch.ops import _build, entropy

    codes = np.clip(np.round(np.random.default_rng(0).laplace(0, 12, 50_000)),
                    -127, 127).astype(np.int8)
    data = entropy.entropy_encode(codes)
    path = _build.library_path("entropy")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert len(data) < codes.size
    assert (entropy.entropy_decode(data, codes.size) == codes).all()


def test_streaming_on_the_card_matches_batch(device):
    """Chunked encode against batch encode and decode under two chunkings
    on the card: the model's products may take other algorithms at other
    row counts, so rtol / atol 1e-4 rather than bit for bit."""
    from meanflow_audio_codec_torch.streaming import (
        StreamingDecoder,
        StreamingEncoder,
    )

    _, gpu = _tiny_codecs(device)
    audio = _clip(length=8192, seed=4).to(device)
    latents, gains = gpu.encode_with_gains(audio)
    enc = StreamingEncoder(gpu)
    before = (mdct_cuda_mod.launches, imdct_cuda_mod.launches)
    parts = [enc.push(audio[:, i:i + 512]) for i in range(0, 8192, 512)]
    streamed = torch.cat(parts + [enc.flush()], dim=1)
    torch.testing.assert_close(streamed, latents, rtol=1e-4, atol=1e-4)
    assert mdct_cuda_mod.launches - before[0] == 17  # 16 pushes + flush

    def decode(step):
        dec = StreamingDecoder(gpu, seed=5)
        nf = latents.shape[1]
        out = [dec.push(latents[:, i:i + step], gains=gains[:, i:i + step])
               for i in range(0, nf, step)]
        return torch.cat(out + [dec.flush()], dim=1)

    one, chunked = decode(latents.shape[1]), decode(16)
    torch.cuda.synchronize()
    assert imdct_cuda_mod.launches > before[1]
    assert torch.isfinite(one).all()
    torch.testing.assert_close(chunked, one, rtol=1e-4, atol=1e-4)


def _corpus_rehearsal(device, precision):
    """(config, train state, step) at configs/corpus_rehearsal.json's full
    width (channels 512, 8 blocks), ``precision`` compute, seeded weights."""
    import dataclasses
    from pathlib import Path

    from meanflow_audio_codec_torch.configs import load_config
    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.ops.tokenize import (
        create_tokenization_strategy,
    )
    from meanflow_audio_codec_torch.training.adapter import adapter_from_config
    from meanflow_audio_codec_torch.training.objectives import (
        create_loss_strategy,
    )
    from meanflow_audio_codec_torch.training.optim import (
        TrainState,
        make_optimizer,
    )
    from meanflow_audio_codec_torch.training.train_step import make_train_step

    path = Path(__file__).resolve().parents[1] / "configs" / (
        "corpus_rehearsal.json")
    cfg = dataclasses.replace(load_config(path), precision=precision)
    model = create_flow_model(cfg, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                       device=device)
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    step = make_train_step(create_loss_strategy(cfg), adapter,
                           remat=cfg.remat,
                           skip_nonfinite=cfg.skip_nonfinite_updates)
    return cfg, state, step


def test_full_width_corpus_step_on_the_card(device, tmp_path):
    """One bf16 step of corpus_rehearsal.json (114,472,384 parameters) on a
    batch the native loader reads from a FLAC corpus written by
    make_corpus: a finite loss and an accepted update."""
    from meanflow_audio_codec_torch.data.audio import build_audio_pipeline
    from meanflow_audio_codec_torch.tools.make_corpus import make_corpus

    make_corpus(tmp_path, "mixed", num_clips=3, seconds=1.0, fmt="flac")
    cfg, state, step = _corpus_rehearsal(device, "bfloat16")
    assert sum(p.numel() for p in state.params) == 114_472_384
    frame = cfg.tokenization_config["frame_size"]
    loader = build_audio_pipeline(tmp_path, seed=cfg.seed, frame_size=frame,
                                  batch_size=cfg.batch_size)
    try:
        batch = torch.from_numpy(next(loader)).to(device)
    finally:
        loader.close()
    assert batch.shape == (cfg.batch_size, frame, 2)
    state, metrics = step(state, batch,
                          generator=torch.Generator(device).manual_seed(1))
    assert torch.isfinite(metrics["loss"]) and bool(metrics["update_ok"])


def test_full_width_corpus_step_on_the_card_matches_the_cpu(device):
    """One float32 step at corpus_rehearsal.json's width (its remat
    honoured) on one 4096-sample clip with the same draws: loss and
    grad_norm rtol 1e-4, Adam's first moments within relative L2 1e-5 of
    the CPU's (the frontier-v2 check of chip_smoke.py, at channels 512)."""
    from meanflow_audio_codec_torch.ops.mdct import num_frames_for_length
    from meanflow_audio_codec_torch.training.objectives import (
        create_loss_strategy,
    )

    gen = torch.Generator().manual_seed(7)
    t = torch.arange(4096) / 44100.0
    audio = (0.3 * torch.sin(2 * torch.pi * 220.0 * t)[None, :, None]
             + 0.1 * torch.randn(1, 4096, 2, generator=gen))
    results = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for where in ("cpu", device):
            cfg, state, step = _corpus_rehearsal(torch.device(where),
                                                 "float32")
            if not results:
                rows = num_frames_for_length(4096, 512, 256)
                draws = (torch.randn(rows, 1024, generator=gen),
                         *create_loss_strategy(cfg).time_sampling
                         .sample_time_pair(rows, gen))
            noise, t_, r_ = (d.to(where) for d in draws)
            state, metrics = step(state, audio.to(where), noise=noise,
                                  t=t_, r=r_)
            assert bool(metrics["update_ok"])
            results.append((metrics["loss"].cpu(),
                            metrics["grad_norm"].cpu(),
                            torch.cat([m.reshape(-1).cpu()
                                       for m in state.mu])))
            del state
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lc, gc, mc), (lg, gg, mg) = results
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=0)
    torch.testing.assert_close(gg, gc, rtol=1e-4, atol=0)
    rel = ((mg - mc).norm() / mc.norm()).item()
    assert rel <= 1e-5, rel


# ---------------------------------------------------------------------------
# the other model families and the FFT MDCT
# ---------------------------------------------------------------------------

FAMILY_CONFIGS = {
    "mlp": ("mlp", {}, "mnist", "reshape", {}),
    "mlp_mixer": ("mlp_mixer", {"token_mix_dim": 64, "channel_mix_dim": 32,
                                "num_channels": 8, "num_latent_tokens": 4,
                                "encoder_context_tokens": 8},
                  "audio", "mdct", {"frame_size": 4096, "window_size": 64,
                                    "coeff_scale": 4.0, "gain_norm": 0.05}),
    "simple_conv": ("simple_conv", {}, "mnist", "reshape", {}),
}


def _family_step(where, family):
    from meanflow_audio_codec_torch.configs import config_from_dict
    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.ops.tokenize import (
        compute_token_shape,
        create_tokenization_strategy,
    )
    from meanflow_audio_codec_torch.training.adapter import (
        adapter_from_config,
        resolve_flatten_mode,
    )
    from meanflow_audio_codec_torch.training.objectives import (
        create_loss_strategy,
    )
    from meanflow_audio_codec_torch.training.optim import (
        TrainState,
        make_optimizer,
    )
    from meanflow_audio_codec_torch.training.train_step import make_train_step
    from meanflow_audio_codec_torch.training.trainer import (
        input_example_shape,
    )

    architecture, options, dataset, tokenization, tok_cfg = (
        FAMILY_CONFIGS[family])
    data = {"base": {"batch_size": 4, "n_steps": 1, "base_lr": 1e-3,
                     "weight_decay": 1e-4, "seed": 0},
            "model": {"noise_dimension": 1, "condition_dimension": 64,
                      "latent_dimension": 16, "num_blocks": 2,
                      "architecture": architecture,
                      "architecture_options": options},
            "dataset": {"dataset": dataset,
                        "tokenization_strategy": tokenization,
                        "tokenization_config": tok_cfg},
            "method": {"method": "improved_mean_flow",
                       "use_improved_mean_flow": True},
            "tpu": {"precision": "bfloat16"}}
    cfg = config_from_dict(data)
    strategy = create_tokenization_strategy(tokenization, tok_cfg)
    n, d = compute_token_shape(strategy, input_example_shape(cfg))
    data["model"]["noise_dimension"] = (
        d if resolve_flatten_mode(cfg) == "frames" else n * d)
    cfg = config_from_dict(data)
    model = create_flow_model(cfg, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(cfg), None,
                       device=torch.device(where))
    adapter = adapter_from_config(cfg, strategy)
    step = make_train_step(create_loss_strategy(cfg), adapter)
    return cfg, state, step, adapter


@pytest.mark.parametrize("family", list(FAMILY_CONFIGS))
def test_new_family_bf16_step_on_the_card_matches_the_cpu(device, family):
    from meanflow_audio_codec_torch.training.objectives import (
        create_loss_strategy,
    )

    gen = torch.Generator().manual_seed(3)
    out = []
    for where in ("cpu", device):
        cfg, state, step, adapter = _family_step(where, family)
        if not out:
            shape = ((4, 784) if cfg.dataset == "mnist"
                     else (4, cfg.tokenization_config["frame_size"], 2))
            batch = torch.rand(shape, generator=gen) * 2 - 1
            x = adapter.tokenize(batch)
            draws = (torch.randn(x.shape, generator=gen),
                     *create_loss_strategy(cfg).time_sampling
                     .sample_time_pair(x.shape[0], gen))
        noise, t, r = (d.to(where) for d in draws)
        state, metrics = step(state, batch.to(where), noise=noise, t=t, r=r)
        out.append((float(metrics["loss"]), torch.cat(
            [m.reshape(-1).float().cpu() for m in state.mu])))
    (loss_cpu, mu_cpu), (loss_card, mu_card) = out
    assert abs(loss_card - loss_cpu) <= 2e-2 * abs(loss_cpu)
    rel = float((mu_card - mu_cpu).norm() / mu_cpu.norm())
    assert rel <= 5e-2, rel


@pytest.mark.parametrize("hop,normalize", [(None, False), (1024, True)])
def test_fft_mdct_on_the_card_matches_the_cpu(device, hop, normalize):
    from meanflow_audio_codec_torch.ops.mdct import imdct_fft, mdct_fft

    cfg = MDCTConfig(4096, hop, normalize)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(3, 5 * 4096 + 77, generator=gen)
    coeffs = mdct_fft(x.to(device), cfg)
    torch.testing.assert_close(coeffs.cpu(), mdct_fft(x, cfg), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(mdct(x.to(device), cfg).cpu(),
                               coeffs.cpu())  # W 4096: mdct takes the FFT
    X = torch.randn(3, 4, 4096, generator=gen)
    torch.testing.assert_close(imdct_fft(X.to(device), cfg).cpu(),
                               imdct_fft(X, cfg), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the evaluator on the card
# ---------------------------------------------------------------------------

#: frontier-v2's geometry (MDCT W 512 stereo, gain-normalised) at a small
#: ConvNeXt, float32, trained 2 steps on the CPU
EVAL_RUN = {
    "base": {"batch_size": 2, "n_steps": 2, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 3},
    "model": {"noise_dimension": 1024, "condition_dimension": 16,
              "latent_dimension": 8, "num_blocks": 2,
              "architecture": "convnet",
              "architecture_options": {"channels": 16, "bottleneck_dim": 32,
                                       "spatial": 4, "lift_channels": 8}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {
                    "frame_size": 4096, "window_size": 512,
                    "coeff_scale": 4.0, "gain_norm": 0.05,
                    "device_pool_clips": 4, "synthetic_family": "mixed"}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True},
    "training": {"sample_every": 1000, "sample_seed": 1, "sample_steps": 1,
                 "checkpoint_step": 2, "ema_decay": 0.99},
    "tpu": {"precision": "float32", "steps_per_call": 2},
}


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """(config, checkpoint) of a run the port's trainer writes on the CPU."""
    import copy

    from meanflow_audio_codec_torch.configs import config_from_dict
    from meanflow_audio_codec_torch.training.checkpoints import (
        find_latest_checkpoint,
    )
    from meanflow_audio_codec_torch.training.trainer import train_flow

    data = copy.deepcopy(EVAL_RUN)
    workdir = tmp_path_factory.mktemp("eval_run")
    data["training"]["workdir"] = str(workdir)
    config = config_from_dict(data)
    train_flow(config, device="cpu")
    return config, find_latest_checkpoint(workdir / "checkpoints")


def _clips(batch=2, length=4096):
    gen = torch.Generator().manual_seed(21)
    t = torch.arange(length) / 44100.0
    tone = 0.3 * torch.sin(2 * torch.pi * 440.0 * t)[None, :, None]
    return (tone + 0.1 * torch.randn(batch, length, 2,
                                     generator=gen)).numpy()


def test_evaluator_on_the_card_matches_the_cpu(device, eval_run):
    """Float32 NFE 1 on 2 clips of 4096 samples, the same start noise: the
    decoded audio on the card within relative L2 1e-5 of the CPU's, and the
    MSE within rtol 1e-4."""
    from meanflow_audio_codec_torch.evaluators import ComprehensiveEvaluator

    config, checkpoint = eval_run
    rows = 2 * num_frames_for_length(4096, 512, 256)
    noise = {1: torch.randn(rows, 1024,
                            generator=torch.Generator().manual_seed(22))}
    decoded, results = [], []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the 3x3 convolutions in f32
    try:
        for where in (device, torch.device("cpu")):
            evaluator = ComprehensiveEvaluator(checkpoint, config,
                                               nfe_list=[1], timing_runs=0,
                                               device=where)
            quality = evaluator._quality

            def keep(real, generated, quality=quality):
                decoded.append(torch.from_numpy(generated).double())
                return quality(real, generated)

            evaluator._quality = keep
            results.append(evaluator.evaluate(_clips(), noise=noise))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    got, ref = decoded
    assert got.shape == ref.shape == (2, 4608, 2)
    assert float((got - ref).norm() / ref.norm()) <= 1e-5
    mse = [r["nfe_sweep"]["1"]["mse"] for r in results]
    assert mse[0] == pytest.approx(mse[1], rel=1e-4)


def test_evaluator_launches_the_transform_kernels(device, eval_run):
    """On the card the evaluator tokenizes through the MDCT kernel (once per
    evaluation) and decodes through the IMDCT kernel (once per NFE)."""
    from meanflow_audio_codec_torch.evaluators import ComprehensiveEvaluator

    config, checkpoint = eval_run
    evaluator = ComprehensiveEvaluator(checkpoint, config, nfe_list=[1, 2],
                                       timing_runs=1, latent_step=0.5,
                                       device=device)
    mdct_cuda_mod.launches = imdct_cuda_mod.launches = 0
    results = evaluator.evaluate(_clips())
    assert (mdct_cuda_mod.launches, imdct_cuda_mod.launches) == (1, 2)
    assert results["bitstream_kbps_measured"] > 0
    assert set(results["nfe_sweep"]) == {"1", "2"}


# ---------------------------------------------------------------------------
# gradients through the transform kernels; W8A8 int8 serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transform", ["mdct", "imdct"])
@pytest.mark.parametrize("rows,length,window,hop", [
    (3, 10000, 256, 128), (2, 5000, 576, 100), (5, 300, 512, 256),
    (8, 32768, 512, 256)])
def test_transform_gradients_on_the_card_match_plain_autograd(
        device, transform, rows, length, window, hop):
    """x.grad through the kernel (its backward launches the other kernel)
    against the plain version's autograd on the card, at the transforms'
    rtol 1e-4 / atol 1e-3; not zero."""
    gen = torch.Generator(device).manual_seed(rows)
    cfg = MDCTConfig(window, hop)
    nf = num_frames_for_length(length, window, hop)
    x = (torch.randn(rows, length, device=device, generator=gen)
         if transform == "mdct" else
         torch.randn(rows, nf, window, device=device, generator=gen))
    kernel, plain = ((mdct_cuda, mdct) if transform == "mdct"
                     else (imdct_cuda, imdct))
    other = imdct_cuda_mod if transform == "mdct" else mdct_cuda_mod
    grads = []
    for fn in (kernel, plain):
        a = x.clone().requires_grad_(True)
        y = fn(a, cfg)
        cot = torch.randn(y.shape, device=device,
                          generator=torch.Generator(device).manual_seed(7))
        before = other.launches
        (y * cot).sum().backward()
        torch.cuda.synchronize()
        grads.append(a.grad)
        if fn is kernel:
            assert other.launches == before + 1
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=RTOL, atol=ATOL)


def test_mdct_layers_on_the_card_carry_gradients(device):
    from meanflow_audio_codec_torch.ops.mdct_layers import IMDCTLayer, MDCTLayer

    stereo = torch.randn(2, 32768, 2, device=device, requires_grad=True)
    before = (mdct_cuda_mod.launches, imdct_cuda_mod.launches)
    IMDCTLayer(512, 256)(MDCTLayer(512, 256)(stereo)).square().sum().backward()
    torch.cuda.synchronize()
    assert (mdct_cuda_mod.launches - before[0],
            imdct_cuda_mod.launches - before[1]) == (2, 2)
    assert torch.isfinite(stereo.grad).all() and stereo.grad.abs().max() > 0


@pytest.mark.parametrize("rows,k,n", [(1, 1024, 512), (5, 2304, 256),
                                      (16, 32, 2048), (17, 256, 32),
                                      (1721, 2304, 256), (3, 20, 7)])
def test_int_mm_on_the_card_pads_and_is_exact(device, rows, k, n):
    """``torch._int_mm`` through the padding (rows to 17, K and N to
    multiples of 8) against the plain exact product on the CPU, bit for
    bit; the count moves for the card's product."""
    from meanflow_audio_codec_torch.ops import quant

    gen = torch.Generator().manual_seed(rows + k + n)
    a = torch.randint(-127, 128, (rows, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    before = quant.int8_products
    got = quant._int_product(a.to(device), w.to(device))
    assert quant.int8_products == before + 1
    assert torch.equal(got.cpu(), quant.int_product_plain(a, w))


@pytest.mark.parametrize("op", ["linear", "conv3x3", "conv3x3-stride2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_ops_on_the_card_match_the_cpu(device, op, dtype):
    """The card's int8 ops against the plain path on the CPU on the same
    inputs: the same codes and int32 sums, so the outputs agree to the last
    bit of the dequantize (rtol 1e-6 in float32, one bf16 rounding)."""
    from meanflow_audio_codec_torch.ops import quant

    gen = torch.Generator().manual_seed(3)
    if op == "linear":
        x = torch.randn(1721, 2304, generator=gen).to(dtype)
        w = (0.05 * torch.randn(256, 2304, generator=gen)).to(dtype)
        b = torch.randn(256, generator=gen).to(dtype)
        run = quant.int8_linear
    else:
        stride = 2 if op.endswith("stride2") else 1
        x = torch.randn(64, 8, 8, 256, generator=gen).to(dtype)
        w = (0.05 * torch.randn(256, 256, 3, 3, generator=gen)).to(dtype)
        b = torch.randn(256, generator=gen).to(dtype)
        pad = ((1, 1), (1, 1)) if stride == 1 else ((0, 1), (0, 1))

        def run(x, w, b):
            return quant.int8_conv2d(x, w, b, stride=stride, padding=pad)
    before = quant.int8_products
    got = run(x.to(device), w.to(device), b.to(device))
    torch.cuda.synchronize()
    assert quant.int8_products == before + 1
    want = run(x, w, b)
    assert got.dtype == want.dtype == dtype
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(
        rtol=2 ** -7, atol=2 ** -7)
    torch.testing.assert_close(got.cpu(), want, **tol)


def test_quantized_decoder_runs_72_int8_products_on_the_card(device):
    """Frontier-v2's decoder (8 stages) served int8 on the card: 72 int8
    products per call (4 Dense + 5 convs a stage), within 0.05 of the bf16
    decode of the same weights, at a streaming push's few rows too."""
    from meanflow_audio_codec_torch.models.conv_flow import (
        ConditionalConvFlow,
    )
    from meanflow_audio_codec_torch.ops import quant

    kw = dict(channels=256, bottleneck_dim=512, spatial=8, lift_channels=32,
              compute_dtype=torch.bfloat16)
    bf16 = ConditionalConvFlow(1024, 512, 8, 256, **kw)
    int8 = ConditionalConvFlow(1024, 512, 8, 256, quantized=True, **kw)
    int8.load_state_dict(bf16.state_dict(), strict=True)
    bf16, int8 = bf16.to(device), int8.to(device)
    for rows in (1721, 3):
        gen = torch.Generator(device).manual_seed(rows)
        x = torch.randn(rows, 1024, device=device, generator=gen)
        time = torch.ones(rows, 2, device=device)
        with torch.no_grad():
            latents = bf16.encode(x)
            want = bf16(x, time, latents).float()
            quant.int8_products = 0
            got = int8(x, time, latents).float()
            torch.cuda.synchronize()
        assert quant.int8_products == 72
        assert float((got - want).norm() / want.norm()) < 0.05


def _zero_counts():
    from meanflow_audio_codec_torch.ops import quant

    mdct_cuda_mod.launches = imdct_cuda_mod.launches = 0
    quant.int8_products = 0
    for name in stage_cuda.launches:
        stage_cuda.launches[name] = 0


@pytest.mark.parametrize("quantized", [False, True])
def test_codec_geometry_row_launches_one_transform_each_a_call(device,
                                                               quantized):
    """benchmark_codec_geometry at frontier-v2 width (1 clip of 0.5 s):
    each codec call launches one MDCT and one IMDCT, and the int8 decoder
    72 int8 products; the row's times are finite and positive."""
    import math

    from meanflow_audio_codec_torch.ops import quant
    from meanflow_audio_codec_torch.tools.benchmarks import (
        benchmark_codec_geometry as geometry,
    )

    _zero_counts()
    row = geometry.bench_geometry(
        "ch256_s8_lift32", batch_clips=1, clip_seconds=0.5, iters=2,
        groups=1, quantized=quantized, device=device,
        **geometry.CONFIGS["ch256_s8_lift32"])
    torch.cuda.synchronize()
    calls = 1 + 2  # warm-up, timed
    assert mdct_cuda_mod.launches == imdct_cuda_mod.launches == calls
    assert quant.int8_products == (72 * calls if quantized else 0)
    assert row["params_m"] == 36.3
    for key in ("wall_ms", "rtf"):
        assert math.isfinite(row[key]) and row[key] > 0


@pytest.mark.parametrize("fused", [False, True])
def test_conv_mfu_row_launches_the_stage_kernels_only_when_fused(device,
                                                                 fused):
    """benchmark_conv_mfu's ch512 bn1024 row at batch 64, one step: the
    ``_fused`` row launches all three stage kernels, the other none; the
    MFU is against the card's bf16 peak."""
    from meanflow_audio_codec_torch.tools.benchmarks import (
        benchmark_conv_mfu as conv_mfu,
    )

    name = "ch512_s8_lift64_bn1024_b2048_dots" + ("_fused" if fused else "")
    kwargs = dict(conv_mfu.CONFIGS[name])
    kwargs.pop("batch"), kwargs.pop("scan_k")
    _zero_counts()
    row = conv_mfu.bench_config(name, batch=64, scan_k=1, iters=1,
                                device=device, **kwargs)
    torch.cuda.synchronize()
    counts = [stage_cuda.launches[k] for k in ("ln_film_cuda", "ln_norm_cuda",
                                               "gelu_grn_cuda")]
    assert min(counts) > 0 if fused else max(counts) == 0
    assert row["params_m"] == 118.0 and row["step_gflop"] > 0
    assert 0 < row["mfu"] < 1 and row["steps_per_sec"] > 0


def test_profiler_counts_the_int8_gemm_kernels_of_one_decoder_call(device):
    """probe_hlo's kernel report for one W8A8 decoder call at frontier-v2
    width: 72 ``aten::_int_mm`` calls, each launching an int8 GEMM kernel
    the profiler records."""
    from torch.profiler import ProfilerActivity, profile

    from meanflow_audio_codec_torch.models.conv_flow import (
        ConditionalConvFlow,
    )
    from meanflow_audio_codec_torch.tools.probes.probe_hlo import (
        kernel_report,
    )

    model = ConditionalConvFlow(1024, 512, 8, 256, channels=256,
                                bottleneck_dim=512, spatial=8,
                                lift_channels=32, quantized=True,
                                compute_dtype=torch.bfloat16).to(device)
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn(1721, 1024, device=device, generator=gen)
    time = torch.ones(1721, 2, device=device)
    with torch.no_grad():
        latents = model.encode(x)
        model(x, time, latents)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x, time, latents)
            torch.cuda.synchronize()
    report = kernel_report(prof)
    assert report["int_mm_calls"] == 72
    assert report["int8_gemm_kernels"] >= 72, report["int8_gemm_kernel_names"]


def test_two_gloo_ranks_on_the_card_step_as_one_process(device, tmp_path):
    """Data parallelism on one card: 2 ranks (tests/torch_ranks.py) over
    gloo, each holding its half of the batch on the card, take one step
    that equals the one-process step on the whole batch: relative L2 1e-5
    on the parameters, rtol 1e-5 on the loss (the gradient is averaged over
    the ranks, in another order; TF32 off). Each rank launches the MDCT
    kernel for its tokenization."""
    import torch_ranks

    from meanflow_audio_codec_torch.configs import config_from_dict
    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.ops.tokenize import (
        create_tokenization_strategy,
    )
    from meanflow_audio_codec_torch.training.adapter import (
        adapter_from_config,
    )
    from meanflow_audio_codec_torch.training.objectives import (
        create_loss_strategy,
    )
    from meanflow_audio_codec_torch.training.optim import (
        TrainState,
        make_optimizer,
    )
    from meanflow_audio_codec_torch.training.train_step import make_train_step

    config = {
        "config_version": "2.0",
        "base": {"batch_size": 4, "n_steps": 10, "base_lr": 1e-3,
                 "weight_decay": 1e-4, "seed": 0, "grad_clip_norm": 1.0},
        "model": {"noise_dimension": 256, "condition_dimension": 16,
                  "latent_dimension": 8, "num_blocks": 2,
                  "architecture": "convnet",
                  "architecture_options": {"channels": 32,
                                           "bottleneck_dim": 64,
                                           "spatial": 4, "lift_channels": 8}},
        "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                    "tokenization_config": {"frame_size": 4096,
                                            "window_size": 128,
                                            "coeff_scale": 4.0,
                                            "gain_norm": 0.05}},
        "method": {"method": "improved_mean_flow",
                   "use_improved_mean_flow": True},
        "training": {"sample_every": 100, "sample_seed": 0,
                     "sample_steps": 1, "workdir": "unused",
                     "ema_decay": 0.9},
        "tpu": {"precision": "float32"},
    }
    cfg = config_from_dict(config)
    model = create_flow_model(cfg, generator=torch.Generator().manual_seed(1))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    batch = 0.3 * torch.randn(4, 4096, 2,
                              generator=torch.Generator().manual_seed(2))
    torch.save({"config": config, "params": params, "batch": batch},
               tmp_path / "inputs.pt")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        adapter = adapter_from_config(cfg, create_tokenization_strategy(
            cfg.tokenization_strategy, cfg.tokenization_config))
        state = TrainState(model, make_optimizer(cfg), 0.9, device=device)
        state, metrics = make_train_step(create_loss_strategy(cfg), adapter)(
            state, batch.to(device),
            generator=torch.Generator(device).manual_seed(0))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch_ranks.launch(torch_ranks.card_step, 2, str(tmp_path / "inputs.pt"),
                       str(tmp_path / "rank{rank}.pt"), device="cuda")
    want = torch.cat([p.detach().reshape(-1).cpu() for p in state.params])
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["launches"] > 0
        flat = torch.cat([p.reshape(-1) for p in got["params"]])
        assert float((flat - want).norm() / want.norm()) <= 1e-5
        assert abs(got["loss"] - float(metrics["loss"])) <= 1e-5 * abs(
            float(metrics["loss"]))


def _interface_setup(device, fused: bool):
    """A small float32 convnet codec state on the card, its iMF objective
    and its MDCT token adapter (W 128)."""
    from meanflow_audio_codec_torch.configs import config_from_dict
    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.ops.tokenize import MDCTTokenization
    from meanflow_audio_codec_torch.training.adapter import (
        adapter_from_config,
    )
    from meanflow_audio_codec_torch.training.objectives import (
        create_loss_strategy,
    )
    from meanflow_audio_codec_torch.training.optim import (
        TrainState,
        make_optimizer,
    )

    config = config_from_dict({
        "base": {"batch_size": 2, "n_steps": 10, "base_lr": 1e-3,
                 "weight_decay": 0.0, "seed": 0},
        "model": {"noise_dimension": 256, "condition_dimension": 16,
                  "latent_dimension": 8, "num_blocks": 2,
                  "architecture": "convnet",
                  "architecture_options": {"channels": 32, "spatial": 4,
                                           "bottleneck_dim": 64,
                                           "lift_channels": 8,
                                           "fused_stage": fused}},
        "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                    "tokenization_config": {"window_size": 128}},
        "method": {"method": "improved_mean_flow",
                   "use_improved_mean_flow": True},
        "training": {"sample_every": 10, "sample_seed": 0,
                     "sample_steps": 1},
        "tpu": {"precision": "float32"}})
    model = create_flow_model(config, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(config), device=device)
    adapter = adapter_from_config(config, MDCTTokenization(128))
    return state, create_loss_strategy(config), adapter


def test_eval_step_launches_one_mdct_a_call(device):
    """``make_eval_step`` with an MDCT token adapter tokenizes through the
    MDCT kernel, once a call, and launches nothing else; its loss equals
    ``objective.loss`` on the same tokens and draws."""
    from meanflow_audio_codec_torch.training.train_step import make_eval_step

    state, objective, adapter = _interface_setup(device, fused=False)
    gen = torch.Generator(device).manual_seed(1)
    audio = torch.randn(2, 4096, 2, device=device, generator=gen)
    with torch.no_grad():
        x = adapter.tokenize(audio)
    draws = objective.draws_for(state, x, gen)
    step = make_eval_step(objective, adapter)
    _zero_counts()
    metrics = [step(state, None, audio, **draws) for _ in range(3)]
    torch.cuda.synchronize()
    assert mdct_cuda_mod.launches == 3 and imdct_cuda_mod.launches == 0
    assert max(stage_cuda.launches.values()) == 0
    with torch.no_grad():
        ref, _ = objective.loss(state.model, x, **draws)
    torch.testing.assert_close(metrics[-1]["loss"], ref, rtol=1e-5, atol=0)


def test_fused_compute_loss_launches_the_stage_kernels(device):
    """``compute_loss`` and ``train_step`` of a ``fused_stage`` model launch
    all three stage kernels; the unfused model's none."""
    from meanflow_audio_codec_torch.training.train_step import train_step

    for fused in (False, True):
        state, objective, adapter = _interface_setup(device, fused=fused)
        gen = torch.Generator(device).manual_seed(2)
        audio = torch.randn(2, 4096, 2, device=device, generator=gen)
        with torch.no_grad():
            x = adapter.tokenize(audio)
        _zero_counts()
        loss, grads = objective.compute_loss(state, gen, x)
        state, step_loss = train_step(state, gen, x, objective)
        torch.cuda.synchronize()
        counts = list(stage_cuda.launches.values())
        assert min(counts) > 0 if fused else max(counts) == 0
        assert len(grads) == len(state.params) and state.step == 1
        assert torch.isfinite(loss) and torch.isfinite(step_loss)


def test_device_time_returns_positive_seconds(device):
    """``training/profiling.device_time`` of the MDCT kernel: positive
    seconds a call, the kernel launched warmup + iters times."""
    from meanflow_audio_codec_torch.training.profiling import device_time

    cfg = MDCTConfig(512, 256)
    x = torch.randn(8, 32768, device=device)
    _zero_counts()
    seconds = device_time(mdct_cuda, x, cfg, iters=5, warmup=2)
    assert seconds > 0 and mdct_cuda_mod.launches == 7


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16], ids=str)
def test_stage_fusable_matches_the_launches(device, dtype):
    """Each stage op launches its kernel on ``[2, S*S, C]`` exactly where
    ``stage_fusable(S, C, dtype)`` says (float16: the wrappers' TypeError)."""
    for spatial, channels in [(8, 256), (4, 64), (3, 48)]:
        x = torch.randn(2, spatial * spatial, channels, device=device,
                        dtype=dtype)
        _zero_counts()
        try:
            stage.fused_ln_norm(x)
            launched = True
        except TypeError:
            launched = False
        assert launched == stage.stage_fusable(spatial, channels, dtype)
        assert stage_cuda.launches["ln_norm_cuda"] == int(launched)


def test_drop_path_block_on_the_card_matches_the_cpu(device, monkeypatch):
    """``ConvNeXtBlock(drop_path=0.5)`` in training, the same ``keep`` on
    both devices: float32 output within rtol 1e-4 / atol 1e-5; the mask
    the card's generator draws keeps whole rows."""
    from meanflow_audio_codec_torch.models.blocks import ConvNeXtBlock

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    block = ConvNeXtBlock(64, drop_path=0.5, layer_scale_init_value=1.0)
    x = torch.randn(8, 8, 8, 64, generator=torch.Generator().manual_seed(0))
    keep = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0])
    want = block(x, train=True, keep=keep)
    block.to(device)
    got = block(x.to(device), train=True, keep=keep.to(device))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    drawn = block(x.to(device), train=True,
                  generator=torch.Generator(device).manual_seed(1))
    same = (drawn == x.to(device)).reshape(8, -1)
    assert bool((same.all(dim=1) | ~same.any(dim=1)).all())


def test_audio_autoencoder_trial_step_on_the_card_matches_the_cpu(device):
    """One float32 step of the audio autoencoder trial at its published
    widths (W 256 stereo frame tokens, two 16384-sample clips) on the card
    against the CPU (``proj.step_against_cpu``, cuDNN's TF32 off): loss
    rtol 1e-4, Adam's first moments within relative L2 1e-5; the tokenize
    launches one MDCT."""
    from meanflow_audio_codec_torch.data.audio import synthetic_audio_pipeline
    from meanflow_audio_codec_torch.proj import audio_autoencoder
    from meanflow_audio_codec_torch.proj import step_against_cpu

    batch = torch.from_numpy(next(synthetic_audio_pipeline(
        frame_size=16384, batch_size=2)))
    _zero_counts()
    loss_cpu, loss_card, rel = step_against_cpu(
        audio_autoencoder.build_model,
        audio_autoencoder.build_step(audio_autoencoder.build_tokenizer()),
        batch, device)
    assert mdct_cuda_mod.launches == 1
    assert loss_card == pytest.approx(loss_cpu, rel=1e-4, abs=0)
    assert rel <= 1e-5, rel
