"""PyTorch port: both remat switches leave the loss and every gradient as they
are.

``architecture_options.remat`` (under ``dots_saveable`` each decoder stage
checkpoints its elementwise segments, under policy None the stage is
checkpointed whole) and ``tpu.remat`` (the whole loss checkpointed by the
train step) against the same model without remat, in
float32, for the iMF objective with and without the stop-gradient
(gradients through the JVP's tangent), plain and ``fused_stage``. The same
operations run again in the backward pass, so the tolerance is rtol 1e-5 /
atol 1e-7 (float32 re-association at most).
"""

import dataclasses

import pytest
import torch

from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models import blocks, conv_flow, remat
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.training.objectives import (
    ImprovedMeanFlowObjective,
    MeanFlowObjective,
)
from meanflow_audio_codec_torch.training.optim import TrainState, make_optimizer
from meanflow_audio_codec_torch.training.train_step import make_train_step

FLOW = dict(noise_dimension=64, condition_dimension=32, num_blocks=2,
            latent_dimension=16, channels=32, bottleneck_dim=32,
            spatial=4, lift_channels=8)
CLOSE = dict(rtol=1e-5, atol=1e-7)
SWITCHES = [("stage", "dots_saveable"), ("stage", None), ("loss", None)]


def _loss_and_grads(model, objective, x, draws, whole_loss):
    def loss_fn():
        return objective.loss(model, x, **draws)[0]

    loss = (torch.utils.checkpoint.checkpoint(loss_fn, use_reentrant=False)
            if whole_loss else loss_fn())
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("switch,policy", SWITCHES, ids=str)
@pytest.mark.parametrize("stop_gradient", [True, False],
                         ids=["stop_gradient", "grad_of_jvp"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_remat_leaves_the_gradients_unchanged(switch, policy, stop_gradient,
                                              fused):
    gen = torch.Generator().manual_seed(0)
    x = 0.3 * torch.randn(8, 64, generator=gen)
    model = conv_flow.ConditionalConvFlow(**FLOW, fused_stage=fused)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    objective = ImprovedMeanFlowObjective(use_stop_gradient=stop_gradient)
    draws = objective.draw(model, x, gen)
    want_loss, want = _loss_and_grads(model, objective, x, draws, False)

    remat_model = conv_flow.ConditionalConvFlow(
        **FLOW, fused_stage=fused, remat=switch == "stage",
        remat_policy=policy)
    remat_model.load_state_dict(model.state_dict())
    loss, grads = _loss_and_grads(remat_model, objective, x, draws,
                                  switch == "loss")
    torch.testing.assert_close(loss, want_loss, **CLOSE)
    for (name, _), g, w in zip(model.named_parameters(), grads, want):
        torch.testing.assert_close(g, w, **CLOSE, msg=name)


def test_both_switches_together_for_mean_flow_without_stop_gradient():
    gen = torch.Generator().manual_seed(1)
    x = 0.3 * torch.randn(8, 64, generator=gen)
    model = conv_flow.ConditionalConvFlow(**FLOW)
    both = conv_flow.ConditionalConvFlow(**FLOW, remat=True,
                                         remat_policy="dots_saveable")
    both.load_state_dict(model.state_dict())
    objective = MeanFlowObjective(use_stop_gradient=False)
    draws = objective.draw(model, x, gen)
    want_loss, want = _loss_and_grads(model, objective, x, draws, False)
    loss, grads = _loss_and_grads(both, objective, x, draws, True)
    torch.testing.assert_close(loss, want_loss, **CLOSE)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, **CLOSE)


def _config(remat_options: dict, tpu_remat: bool):
    return config_from_dict({
        "base": {"batch_size": 2, "n_steps": 4, "base_lr": 1e-3,
                 "weight_decay": 1e-2, "seed": 0, "grad_clip_norm": 1.0},
        "model": {"noise_dimension": 64, "condition_dimension": 32,
                  "latent_dimension": 16, "num_blocks": 2,
                  "architecture": "convnet",
                  "architecture_options": dict(
                      channels=32, bottleneck_dim=32, spatial=4,
                      lift_channels=8, **remat_options)},
        "method": {"method": "improved_mean_flow",
                   "use_improved_mean_flow": True,
                   "loss_weighting": "learned"},
        "training": {"ema_decay": 0.9},
        "tpu": {"precision": "float32", "remat": tpu_remat,
                "skip_nonfinite_updates": True}})


def test_train_step_with_both_switches_equals_the_plain_step():
    """``make_train_step(remat=True)`` on a stage-remat model from the
    factory: the state after two steps equals the plain step's (learned
    weighting on, so its polynomial trains in both)."""
    states = []
    for options, tpu_remat in (({}, False),
                               ({"remat": True,
                                 "remat_policy": "dots_saveable"}, True)):
        cfg = _config(options, tpu_remat)
        model = create_flow_model(cfg, torch.Generator().manual_seed(0))
        assert model.remat == bool(options)
        assert cfg.remat == tpu_remat
        state = TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                           device="cpu")
        step = make_train_step(ImprovedMeanFlowObjective(
            loss_weighting="learned"), remat=cfg.remat, skip_nonfinite=True)
        gen = torch.Generator().manual_seed(2)
        for _ in range(2):
            x = torch.randn(2, 64, generator=gen)
            state, metrics = step(state, x, generator=gen)
            assert metrics["update_ok"]
        states.append(state)
    plain, both = states
    assert plain.names == both.names and "loss_weighting.poly" in plain.names
    for p, q in zip(plain.params, both.params):
        torch.testing.assert_close(q, p, **CLOSE)
    torch.testing.assert_close(both.ema[-1], plain.ema[-1], **CLOSE)


def test_remat_runs_plainly_without_a_graph_and_checks_its_policy():
    model = conv_flow.ConditionalConvFlow(**FLOW, remat=True)
    x = torch.randn(2, 64, generator=torch.Generator().manual_seed(3))
    time = torch.rand(2, 2, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        out = model(x, time)
    plain = conv_flow.ConditionalConvFlow(**FLOW)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(out, plain(x, time), rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat_policy"):
        conv_flow.ConditionalConvFlow(**FLOW, remat=True,
                                      remat_policy="everything_saveable")
    for name in remat.POLICIES:
        remat.check_policy(name)


@pytest.mark.parametrize("policy,regions", [
    ("dots_saveable", ["_norm_film", "_norm", "_activation"]),
    ("checkpoint_dots", ["_norm_film", "_norm", "_activation"]),
    (None, ["ConvStage"]), ("nothing_saveable", ["ConvStage"])], ids=str)
def test_each_policy_checkpoints_its_regions(monkeypatch, policy, regions):
    """``dots_saveable`` checkpoints each stage's elementwise segments (the
    products' outputs are their inputs, so they are kept); policy None
    checkpoints each stage whole."""
    seen = []

    def recording(fn, *args):
        seen.append(getattr(fn, "__name__", type(fn).__name__))
        return remat.remat(fn, *args)

    monkeypatch.setattr(conv_flow, "remat", recording)
    monkeypatch.setattr(blocks, "remat", recording)
    model = conv_flow.ConditionalConvFlow(**FLOW, remat=True,
                                          remat_policy=policy)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 64, generator=gen)
    model(x, torch.rand(2, 2, generator=gen)).square().sum().backward()
    assert seen == regions * FLOW["num_blocks"]


def test_the_factory_keeps_the_remat_options():
    cfg = _config({"remat": True, "remat_policy": "dots_saveable"}, False)
    model = create_flow_model(cfg)
    assert model.remat and model.remat_policy == "dots_saveable"
    cfg = dataclasses.replace(cfg, architecture_options={
        **cfg.architecture_options, "remat_policy": "unknown"})
    with pytest.raises(ValueError, match="remat_policy"):
        create_flow_model(cfg)
