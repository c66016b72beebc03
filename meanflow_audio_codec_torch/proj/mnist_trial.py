"""MNIST trial: an improved-mean-flow ConvNeXt flow, sampled in one step.

Counterpart of the JAX repository's ``proj/mnist_trial/train.py``: the
same model (``ConditionalConvFlow(784, 128, 4, 128)``, bfloat16 compute),
``adamw(1e-4, weight_decay=1e-4)``, iMF steps on MNIST batches (synthetic
digits where no MNIST copy is at hand), then a 1-NFE decode of a held-out
batch's latents into ``samples_1nfe.png`` (which needs matplotlib).

    python -m meanflow_audio_codec_torch.proj.mnist_trial [--steps 2000] \\
        [--batch-size 128] [--workdir outputs/mnist_trial] [--device cuda]
"""

from __future__ import annotations

import sys

import torch

from meanflow_audio_codec_torch.data.mnist import load_mnist
from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow
from meanflow_audio_codec_torch.ops.sampling import sample_dual_time
from meanflow_audio_codec_torch.proj import parser, save_png, train
from meanflow_audio_codec_torch.training.objectives import (
    ImprovedMeanFlowObjective,
)
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

NOISE = 784
WIDTHS = dict(condition_dimension=128, num_blocks=4, latent_dimension=128)


def build_model(compute_dtype: torch.dtype = torch.bfloat16,
                **widths) -> ConditionalConvFlow:
    """The trial's flow (``widths`` override :data:`WIDTHS`), not yet
    initialised."""
    return ConditionalConvFlow(noise_dimension=NOISE, **{**WIDTHS, **widths},
                               compute_dtype=compute_dtype)


def build_step():
    return make_train_step(ImprovedMeanFlowObjective())


def _log(i: int, metrics: dict) -> None:
    print(f"step {i}: loss={float(metrics['loss']):.4f} "
          f"mse={float(metrics['mse']):.4f}")


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__, 2000, 128, "outputs/mnist_trial").parse_args(argv)
    device = resolve_device(args.device)
    state = create_train_state(build_model(),
                               torch.Generator().manual_seed(0),
                               args.batch_size, device=device)
    train_iter, test_iter = load_mnist(args.batch_size, seed=0)
    state, _ = train(build_step(), state, train_iter, args.steps,
                     torch.Generator(device).manual_seed(0), _log)

    # 1-NFE decode conditioned on held-out latents
    with torch.no_grad():
        test_batch = torch.from_numpy(next(test_iter)).to(device)
        latents = state.model.encode(test_batch)
        samples = sample_dual_time(
            state.model, NOISE, latents, n_steps=1,
            generator=torch.Generator(device).manual_seed(1))
    args.workdir.mkdir(parents=True, exist_ok=True)
    save_png(samples[:16].float().cpu().numpy(),
             args.workdir / "samples_1nfe.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
