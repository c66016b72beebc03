"""The plain reference against the program, on the CPU in float32: the MDCT,
the codec's round trip and decode, one training step; at a tiny size and at
frontier-v2's widths on a few rows. And the FLOP arithmetic of work.py."""

from __future__ import annotations

import copy
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, program, work
from portbench.reference import family_convnet as conv
from portbench.reference import imf
from portbench.reference import mdct as ref_mdct
from portbench.reference.layers import FP8Ops
from portbench.tests import tiny

from meanflow_audio_codec_torch.ops.mdct import imdct, mdct


def _config(name: str, small: bool) -> dict:
    config = json.loads((harness.BENCH_DIR / "configs" / f"{name}.json").read_text())
    config = tiny.tiny_config(config) if small else config
    config["config"]["tpu"]["precision"] = "float32"
    return config["config"]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("window,hop,length", [(8, 4, 64), (512, 256, 4000), (512, 128, 3000)])
def test_mdct_matches_the_program(window, hop, length):
    x = torch.randn(3, length, generator=torch.Generator().manual_seed(1))
    coeffs = ref_mdct.mdct(x, window, hop)
    assert _rel(coeffs, mdct(x, window, hop)) < 1e-5
    assert _rel(ref_mdct.imdct(coeffs, window, hop), imdct(coeffs, window, hop)) < 1e-5


@pytest.mark.parametrize("name,small", [("frontier_v2", True), ("corpus_v2", True),
                                        ("frontier_v2", False)])
def test_roundtrip_and_decode_match_the_program(name, small):
    cfg = _config(name, small)
    geo = conv.Geometry.from_config(cfg)
    params = conv.draw(geo, 3, "cpu")
    codec = program.codec(program.port_config(cfg), params, conv.to_port, "cpu")
    tok = cfg["dataset"]["tokenization_config"]
    w, gain = tok["window_size"], tok.get("gain_norm", 0.0)
    length = 40 * w // 2 if small else 3 * w
    gen = torch.Generator().manual_seed(2)
    audio = 0.3 * torch.randn(2, length, 2, generator=gen)
    rows = 2 * ref_mdct.num_frames(length, w, w // 2)
    noise = torch.randn(rows, geo.noise_dim, generator=gen)
    out = codec.roundtrip(audio, noise=noise)
    ref = imf.roundtrip(conv, params, audio, noise, geo, w, w // 2, tok["coeff_scale"],
                        gain)
    assert out.shape == ref.shape
    assert _rel(out, ref) < 1e-4
    latents = torch.randn(1, rows, geo.latent_dim, generator=gen)
    gains = torch.rand(1, rows, 1, generator=gen) + 0.5
    out = codec.decode(latents, gains=gains, noise=noise)
    ref = imf.decode(conv, params, latents, gains, noise, geo, w, w // 2,
                     tok["coeff_scale"])
    assert _rel(out, ref) < 1e-4


@pytest.mark.parametrize("name,small", [("frontier_v2", True), ("frontier_v2", False)])
def test_one_train_step_matches_the_program(name, small):
    cfg = _config(name, small)
    geo = conv.Geometry.from_config(cfg)
    params = conv.draw(geo, 4, "cpu")
    tok = cfg["dataset"]["tokenization_config"]
    w = tok["window_size"]
    length = 40 * w // 2 if small else 3 * w
    cfg["dataset"]["tokenization_config"].update(frame_size=length, device_pool_clips=4)
    cfg["base"]["batch_size"] = 2
    gen = torch.Generator().manual_seed(5)
    clips = [(0.3 * torch.randn(2, length, 2, generator=gen)).numpy() for _ in range(4)]
    trainer = program.Trainer(program.port_config(cfg), params, conv.to_port,
                              iter(clips * 4), 0, "cpu")
    try:
        batch = trainer.pool.sample(1, 2)
        rows = 2 * ref_mdct.num_frames(length, w, w // 2)
        noise = torch.randn(1, rows, geo.noise_dim, generator=gen)
        t = torch.rand(1, rows, 1, generator=gen)
        r = t * torch.rand(1, rows, 1, generator=gen)
        trainer.state, series = trainer.chunk(1)(trainer.state, batch, None,
                                                 noise=noise, t=t, r=r)
        grad = {conv.ref_name(n): m / 0.1
                for n, m in zip(trainer.names(), trainer.state.mu)}
    finally:
        trainer.close()
    base = dict(cfg["base"])
    scale = dict(window=w, hop=w // 2, coeff_scale=tok["coeff_scale"],
                 gain_norm=tok.get("gain_norm", 0.0))
    ref = imf.train_steps(conv, params, [batch[0]], [(noise[0], t[0], r[0])],
                          geo, scale, base)
    losses, first = ref["losses"], ref["first_grad"]
    assert abs(float(series["loss"][0]) - losses[0]) < 1e-5
    assert abs(float(series["grad_norm"][0]) - ref["grad_norms"][0]) < 1e-4 * ref["grad_norms"][0]
    worst = max(_rel(grad[n], first[n]) for n in first if float(first[n].norm()) > 0)
    assert worst < 1e-3


def test_step_flops_are_the_objectives_mathematics():
    """work.py's counts are flop_counter's over the reference's forward
    passes, and a whole step counted by flop_counter differs from 3 F_enc +
    5 F_dec only by the tangent's product with the weights' zero tangents
    (one F_dec) that forward-mode AD materialises."""
    geo = conv.Geometry.from_config(_config("frontier_v2", True))
    enc, dec = work.model_flops_per_row(conv, geo)
    assert enc > 0 and dec > 0
    rows = 8
    p = {n: torch.randn(s, requires_grad=True) for n, s in conv.shapes(geo).items()}
    x = torch.randn(rows, geo.noise_dim)
    t = torch.rand(rows, 1)
    with FlopCounterMode(display=False) as counter:
        part, _ = imf.imf_loss_sum(conv, p, x, torch.randn_like(x), t, t * 0.5, geo)
        torch.autograd.grad(part, list(p.values()))
    counted = counter.get_total_flops()
    assert work.train_step_flops(conv, geo, rows) == pytest.approx(rows * (3 * enc + 5 * dec))
    assert counted == pytest.approx(work.train_step_flops(conv, geo, rows) + rows * dec,
                                    rel=0.02)


def test_frontier_v2_decoder_is_0_94_gflop_a_row():
    geo = conv.Geometry.from_config(_config("frontier_v2", False))
    enc, dec = work.model_flops_per_row(conv, geo)
    assert dec == pytest.approx(0.94175232e9)
    assert work.codec_call_flops(conv, geo, 10) == pytest.approx(10 * (enc + dec))


def test_mdct_bound_never_exceeds_the_dense_product():
    for window in (8, 256, 512, 4096):
        assert work.mdct_ops(1, window) <= 4.0 * window * window
        assert work.mdct_ops(1, window) > 0
    peaks = work.PEAKS["NVIDIA H100 80GB HBM3"]
    # one call of the round trip: 32 signal rows of 441,000 samples
    nbytes = work.mdct_bytes(32, 441000, 1721, 512)
    assert nbytes == 4.0 * 32 * (441000 + 1721 * 512)
    assert work.bound_seconds(work.mdct_ops(32 * 1721, 512), nbytes, peaks) == nbytes / 3.35e12


def test_weight_map_covers_every_parameter_both_ways():
    for name in ("frontier_v2", "corpus_v2"):
        cfg = _config(name, False)
        geo = conv.Geometry.from_config(cfg)
        with torch.device("meta"):
            from meanflow_audio_codec_torch.models.factories import create_flow_model

            model = create_flow_model(program.port_config(cfg))
        names = list(model.state_dict())
        assert sorted(conv.ref_name(n) for n in names) == sorted(conv.shapes(geo))
        for n, v in model.state_dict().items():
            assert tuple(v.shape) == conv.shapes(geo)[conv.ref_name(n)]
        count = sum(v.numel() for v in model.state_dict().values())
        assert count == {"frontier_v2": 33_813_696, "corpus_v2": 114_472_384}[name]


def test_fp8_products_round_their_operands():
    ops = FP8Ops()
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    q = ops.q(x)
    assert 0 < _rel(q, x) < 0.1
    assert len(torch.unique(q / (x.abs().amax() / 448.0))) <= 256


@pytest.mark.cuda
def test_reference_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = copy.deepcopy(_config("frontier_v2", False))
    geo = conv.Geometry.from_config(cfg)
    params = conv.draw(geo, 3, "cpu")
    x = torch.randn(64, geo.noise_dim)
    cpu = conv.encode(params, x, geo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = conv.encode({k: v.cuda() for k, v in params.items()}, x.cuda(), geo)
    assert _rel(card.cpu(), cpu) < 1e-5
