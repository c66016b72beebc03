"""Audio autoencoder: an ``MLPMixerAutoencoder`` over MDCT frame tokens.

Counterpart of the JAX repository's ``proj/audio_autoencoder/train.py``:
stereo clips (``--data-dir``, or the synthetic audio source) are MDCT
tokenized (W 256, normalised; the MDCT kernel on the card) and each frame
of 2W coefficients is one example of ``MLPMixerAutoencoder(512, 8, 64, 32,
32, 256, 256)`` (bfloat16 compute), trained by
``AutoencoderObjective(direct_call=True)`` with ``adamw(1e-4)``. At the end
one held-out clip is reconstructed through the IMDCT (the IMDCT kernel on
the card) into ``reconstruction.wav``.

    python -m meanflow_audio_codec_torch.proj.audio_autoencoder \\
        [--data-dir DIR] [--steps 1000] [--batch-size 8] \\
        [--frame-size 16384] [--window-size 256] \\
        [--workdir outputs/audio_autoencoder] [--device cuda]
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from meanflow_audio_codec_torch.data.audio import (
    build_audio_pipeline,
    synthetic_audio_pipeline,
    write_wav,
)
from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.models.mlp_mixer import MLPMixerAutoencoder
from meanflow_audio_codec_torch.ops.mdct import MDCTConfig
from meanflow_audio_codec_torch.ops.tokenize import MDCTTokenization
from meanflow_audio_codec_torch.proj import parser, train
from meanflow_audio_codec_torch.training.objectives import (
    AutoencoderObjective,
)
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

WIDTHS = dict(num_latent_tokens=8, latent_dim=64, num_context_tokens=32,
              num_output_tokens=32, token_mix_dim=256, channel_mix_dim=256)


class FrameAdapter:
    """Tokenize audio and fold MDCT frames into the batch axis."""

    def __init__(self, tokenizer: MDCTTokenization):
        self.tokenizer = tokenizer

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.tokenizer.tokenize(x)
        return tokens.reshape(-1, tokens.shape[-1])


def build_tokenizer(window_size: int = 256) -> MDCTTokenization:
    return MDCTTokenization(config=MDCTConfig(window_size=window_size,
                                              normalize=True))


def build_model(window_size: int = 256,
                compute_dtype: torch.dtype = torch.bfloat16,
                **widths) -> MLPMixerAutoencoder:
    """The trial's autoencoder over stereo frames of ``window_size``
    coefficients (``widths`` override :data:`WIDTHS`), not yet
    initialised."""
    return MLPMixerAutoencoder(window_size * 2, **{**WIDTHS, **widths},
                               compute_dtype=compute_dtype)


def build_step(tokenizer: MDCTTokenization):
    return make_train_step(AutoencoderObjective(direct_call=True),
                           tokenizer=FrameAdapter(tokenizer), flatten=False)


def reconstruct(model, tokenizer: MDCTTokenization,
                clip: torch.Tensor) -> torch.Tensor:
    """``[B, T, 2]`` clips through tokenize, the autoencoder and the
    inverse: ``[B, T', 2]`` float32 audio."""
    with torch.no_grad():
        tokens = tokenizer.tokenize(clip)
        b, nf, width = tokens.shape
        recon = model(tokens.reshape(-1, width))
        return tokenizer.detokenize(recon.reshape(b, nf, width).float())


def _log(i: int, metrics: dict) -> None:
    print(f"step {i}: mse={float(metrics['mse']):.5f}")


def main(argv: list[str] | None = None) -> int:
    cli = parser(__doc__, 1000, 8, "outputs/audio_autoencoder")
    cli.add_argument("--frame-size", type=int, default=16384)
    cli.add_argument("--window-size", type=int, default=256)
    cli.add_argument("--data-dir", type=Path, default=None)
    args = cli.parse_args(argv)
    device = resolve_device(args.device)
    tokenizer = build_tokenizer(args.window_size)
    state = create_train_state(build_model(args.window_size),
                               torch.Generator().manual_seed(0),
                               args.batch_size, device=device)
    if args.data_dir and args.data_dir.exists():
        data = build_audio_pipeline(args.data_dir, frame_size=args.frame_size,
                                    batch_size=args.batch_size)
    else:
        print("using synthetic audio source")
        data = synthetic_audio_pipeline(frame_size=args.frame_size,
                                        batch_size=args.batch_size)
    state, _ = train(build_step(tokenizer), state, data, args.steps,
                     torch.Generator(device).manual_seed(0), _log)

    # reconstruct one held-out clip end-to-end through the codec
    clip = torch.from_numpy(next(data)).to(device)
    audio = reconstruct(state.model, tokenizer, clip)
    args.workdir.mkdir(parents=True, exist_ok=True)
    path = args.workdir / "reconstruction.wav"
    write_wav(path, audio[0].cpu().numpy())
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
