"""The reference's standalone trials on the port: counterparts of the JAX
repository's ``proj/*/train.py`` scripts, with the same flags, widths,
optimiser, data, steps and outputs, and a ``--device`` flag (``cuda`` by
default; raises without a card unless given ``cpu``).

    python -m meanflow_audio_codec_torch.proj.mnist_trial [--steps 2000]
    python -m meanflow_audio_codec_torch.proj.mnist_autoencoder [--steps 1000]
    python -m meanflow_audio_codec_torch.proj.audio_autoencoder [--steps 1000]

Each module builds its model and step with ``build_model`` and
``build_step``; ``training.simple_trainer.create_train_state`` gives the
state (Flax's init from a generator and optax's ``adamw(1e-4)``, whose
default decay is 1e-4), so a caller can drive a few steps with its own
weights and draws. :func:`train` runs the loop every trial shares, and
:func:`step_against_cpu` holds one of its steps on a card against the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from meanflow_audio_codec_torch.training.logging import plot_samples
from meanflow_audio_codec_torch.training.optim import TrainState
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)


def parser(doc: str, steps: int, batch_size: int,
           workdir: str) -> argparse.ArgumentParser:
    """The flags every trial shares: ``--steps``, ``--batch-size``,
    ``--workdir`` (the JAX scripts' defaults) and ``--device``."""
    out = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    out.add_argument("--steps", type=int, default=steps)
    out.add_argument("--batch-size", type=int, default=batch_size)
    out.add_argument("--workdir", type=Path, default=Path(workdir))
    out.add_argument("--device", default="cuda",
                     help="cuda (the default; raises without a card) or cpu")
    return out


def train(step, state: TrainState, batches, steps: int,
          generator: torch.Generator, log) -> tuple[TrainState, list[float]]:
    """``steps`` calls of ``step`` on batches from ``batches`` (numpy
    arrays), each moved to the state's device; ``log(i, metrics)`` prints
    every hundredth step, as the JAX scripts do. Returns the state and the
    per-step losses, read from the device after the loop."""
    losses = []
    for i in range(steps):
        batch = torch.from_numpy(next(batches)).to(state.device)
        state, metrics = step(state, batch, generator=generator)
        losses.append(metrics["loss"])
        if i % 100 == 0:
            log(i, metrics)
    return state, [float(v) for v in losses]


def save_png(samples, path: Path) -> None:
    """``plot_samples`` into ``path``, then ``wrote <path>`` where the PNG
    exists; otherwise ``plot_samples`` has printed why it is missing
    (matplotlib is not installed)."""
    path.unlink(missing_ok=True)
    plot_samples(samples, path)
    if path.exists():
        print(f"wrote {path}")


def step_against_cpu(build_model, step, batch: torch.Tensor,
                     device: torch.device,
                     **draws: torch.Tensor) -> tuple[float, float, float]:
    """One float32 step of a trial (``build_model``, ``step``) from the same
    seeded state on the CPU and on ``device``, with ``batch`` and ``draws``
    copied to each and cuDNN's TF32 off. Returns the CPU's loss, the
    device's loss and the relative L2 distance of Adam's first moments."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        for where in (torch.device("cpu"), torch.device(device)):
            state = create_train_state(
                build_model(compute_dtype=torch.float32),
                torch.Generator().manual_seed(0), len(batch), device=where)
            state, metrics = step(state, batch.to(where),
                                  **{k: v.to(where) for k, v in draws.items()})
            out.append((float(metrics["loss"]), state._mu.cpu()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (loss_cpu, mu_cpu), (loss_device, mu_device) = out
    rel = ((mu_device - mu_cpu).norm() / mu_cpu.norm()).item()
    return loss_cpu, loss_device, rel
