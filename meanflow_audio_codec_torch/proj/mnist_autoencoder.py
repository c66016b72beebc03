"""MNIST autoencoder: an ``MLPMixerAutoencoder`` trained on reconstruction.

Counterpart of the JAX repository's ``proj/mnist_autoencoder/train.py``:
the same model (``MLPMixerAutoencoder(784, 16, 64, 64, 64, 256, 256)``,
bfloat16 compute), ``adamw(1e-4)``, ``AutoencoderObjective(direct_call=
True)`` steps on MNIST batches (synthetic digits where no MNIST copy is at
hand), then a held-out batch's reconstructions into
``reconstructions.png`` (which needs matplotlib) and their mean squared
error.

    python -m meanflow_audio_codec_torch.proj.mnist_autoencoder \\
        [--steps 1000] [--batch-size 128] \\
        [--workdir outputs/mnist_autoencoder] [--device cuda]
"""

from __future__ import annotations

import sys

import torch

from meanflow_audio_codec_torch.data.mnist import load_mnist
from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.models.mlp_mixer import MLPMixerAutoencoder
from meanflow_audio_codec_torch.proj import parser, save_png, train
from meanflow_audio_codec_torch.training.objectives import (
    AutoencoderObjective,
)
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

WIDTHS = dict(num_latent_tokens=16, latent_dim=64, num_context_tokens=64,
              num_output_tokens=64, token_mix_dim=256, channel_mix_dim=256)


def build_model(compute_dtype: torch.dtype = torch.bfloat16,
                **widths) -> MLPMixerAutoencoder:
    """The trial's autoencoder (``widths`` override :data:`WIDTHS`), not yet
    initialised."""
    return MLPMixerAutoencoder(784, **{**WIDTHS, **widths},
                               compute_dtype=compute_dtype)


def build_step():
    return make_train_step(AutoencoderObjective(direct_call=True))


def _log(i: int, metrics: dict) -> None:
    print(f"step {i}: mse={float(metrics['mse']):.5f}")


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__, 1000, 128,
                  "outputs/mnist_autoencoder").parse_args(argv)
    device = resolve_device(args.device)
    state = create_train_state(build_model(),
                               torch.Generator().manual_seed(0),
                               args.batch_size, device=device)
    train_iter, test_iter = load_mnist(args.batch_size, seed=0)
    state, _ = train(build_step(), state, train_iter, args.steps,
                     torch.Generator(device).manual_seed(0), _log)

    with torch.no_grad():
        test_batch = torch.from_numpy(next(test_iter)).to(device)
        recon = state.model(test_batch).float()
    args.workdir.mkdir(parents=True, exist_ok=True)
    save_png(recon[:16].cpu().numpy(), args.workdir / "reconstructions.png")
    final_mse = float(((recon - test_batch) ** 2).mean())
    print(f"held-out reconstruction mse: {final_mse:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
