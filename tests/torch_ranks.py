"""Rank processes for the port's sharded CPU tests: a ``gloo`` group of a
few ranks on this host, one process each (``torch.multiprocessing``), as
``torchrun`` would start them. Imports neither JAX nor the JAX package, so a
rank starts in a few seconds. Each scenario runs in every rank and saves
what its test compares with ``torch.save``.
"""

from __future__ import annotations

import contextlib
import io
import json
import socket
from pathlib import Path

import torch
import torch.multiprocessing as mp


def free_address() -> str:
    """A ``tcp://`` rendezvous address on a free local port."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{sock.getsockname()[1]}"


def launch(fn, world: int, *args, device: str = "cpu",
           torchrun: bool = False) -> None:
    """Run ``fn(rank, *args)`` in ``world`` gloo ranks whose tensors live on
    ``device`` (every rank on card 0 for ``cuda``); raises when a rank
    fails. With ``torchrun`` each rank gets torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and no
    group: ``fn`` forms it, as the trainer does under torchrun."""
    mp.spawn(_entry, args=(world, free_address(), device, torchrun, fn,
                           args), nprocs=world)


def _entry(rank, world, address, device, torchrun, fn, args):
    import os

    torch.set_num_threads(1)
    from meanflow_audio_codec_torch.parallel import initialize_distributed

    if torchrun:
        host, port = address[len("tcp://"):].rsplit(":", 1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR=host,
                          MASTER_PORT=port)
    else:
        initialize_distributed(address, world, rank, backend="gloo",
                               device=device)
    try:
        fn(rank, *args)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# scenarios of tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def _state_out(state, metrics) -> dict:
    full = state.full()
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "params": {n: p.detach().clone() for n, p in
                       full.model.named_parameters()},
            "mu": [t.clone() for t in full.mu],
            "nu": [t.clone() for t in full.nu],
            "ema": [t.clone() for t in full.ema],
            "step": full.step}


def sharded_steps(rank: int, inputs: str, out: str) -> None:
    """The data-parallel chunk (mesh 2 x 1) and the tensor-parallel steps
    (mesh 1 x 2) of ``inputs``; this rank's results to ``out``."""
    from meanflow_audio_codec_torch.configs import config_from_dict
    from meanflow_audio_codec_torch.models.conv_flow import (
        ConditionalConvFlow,
    )
    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.ops.tokenize import (
        create_tokenization_strategy,
    )
    from meanflow_audio_codec_torch.parallel import create_mesh, shard_state
    from meanflow_audio_codec_torch.parallel.mesh import local_batch
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
        make_multi_step,
        make_train_step,
    )

    data = torch.load(inputs)
    results = {}

    # data parallel: the chunk on this rank's clips [K, B/2, ...]
    dp = data["dp"]
    cfg = config_from_dict(dp["config"])
    model = create_flow_model(cfg)
    model.load_state_dict(dp["params"])
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    mesh = create_mesh(data=2, model=1, device_type="cpu")
    state = shard_state(TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                                   device="cpu"), mesh)
    run = make_multi_step(create_loss_strategy(cfg), dp["batches"].shape[0],
                          adapter, skip_nonfinite=True)
    state, metrics = run(state, local_batch(dp["batches"], mesh, dim=1),
                         noise=dp["noise"], t=dp["t"], r=dp["r"])
    results["dp"] = _state_out(state, metrics)

    # tensor parallel: the step on the whole batch, the large leaves split
    tp = data["tp"]
    cfg = config_from_dict(tp["config"])
    model = ConditionalConvFlow(**tp["model"])
    model.load_state_dict(tp["params"])
    mesh = create_mesh(data=1, model=2, device_type="cpu")
    state = shard_state(TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                                   device="cpu"), mesh)
    placements = {name: getattr(placement[1], "dim", None)
                  for name, placement in zip(state.names, state.placements)}
    local_shapes = {name: tuple(d.to_local().shape) for name, d in
                    zip(state.names, state.dtensors("mu"))}
    whole = [d.full_tensor() for d in state.dtensors("params")]
    assert all(torch.equal(a, b) for a, b in zip(whole, state.params))
    step = make_train_step(create_loss_strategy(cfg), None,
                           skip_nonfinite=True)
    series = []
    for k in range(tp["batches"].shape[0]):
        state, m = step(state, tp["batches"][k], noise=tp["noise"][k],
                        t=tp["t"][k], r=tp["r"][k])
        series.append(m)
    metrics = {name: torch.stack([torch.as_tensor(m[name]) for m in series])
               for name in series[0]}
    results["tp"] = dict(_state_out(state, metrics), placements=placements,
                         local_shapes=local_shapes)
    torch.save(results, out.format(rank=rank))


# ---------------------------------------------------------------------------
# scenarios of tests/test_torch_trainer_sharded.py
# ---------------------------------------------------------------------------


def train_runs(rank: int, runs: str) -> None:
    """``train_flow`` on each config of ``runs`` (a JSON list), its printed
    lines and summary saved per rank next to the workdir; the first run
    forms the group from torchrun's variables."""
    from meanflow_audio_codec_torch.configs import config_from_dict
    from meanflow_audio_codec_torch.training.trainer import train_flow

    for config in json.loads(Path(runs).read_text()):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            summary = train_flow(config_from_dict(config), device="cpu")
        workdir = Path(config["training"]["workdir"])
        torch.save({"out": printed.getvalue(),
                    "final": summary["loss"]["final"]},
                   workdir.parent / f"{workdir.name}.rank{rank}.pt")


# ---------------------------------------------------------------------------
# the card scenario of tests/test_torch_cuda.py
# ---------------------------------------------------------------------------


def card_step(rank: int, inputs: str, out: str) -> None:
    """One data-parallel step (mesh 2 x 1) on card 0, tensors on the card,
    reduced over gloo; TF32 off. Every rank draws the global batch's noise,
    t and r from the same seed. Saves the full parameters, the loss and the
    MDCT kernel's launches."""
    from meanflow_audio_codec_torch.configs import config_from_dict
    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.ops import mdct_cuda
    from meanflow_audio_codec_torch.ops.tokenize import (
        create_tokenization_strategy,
    )
    from meanflow_audio_codec_torch.parallel import create_mesh, shard_state
    from meanflow_audio_codec_torch.parallel.mesh import local_batch
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = torch.load(inputs)
    cfg = config_from_dict(data["config"])
    model = create_flow_model(cfg)
    model.load_state_dict(data["params"])
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    mesh = create_mesh(data=2, model=1, device_type="cuda")
    state = shard_state(TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                                   device="cuda"), mesh)
    step = make_train_step(create_loss_strategy(cfg), adapter)
    before = mdct_cuda.launches
    state, metrics = step(state,
                          local_batch(data["batch"], mesh).to("cuda"),
                          generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.save({"params": [p.detach().cpu() for p in state.params],
                "loss": float(metrics["loss"]),
                "launches": mdct_cuda.launches - before},
               out.format(rank=rank))
