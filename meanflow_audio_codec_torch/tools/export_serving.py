"""Export a git-committable serving checkpoint from a finished run.

Counterpart of ``meanflow_audio_codec_tpu/tools/export_serving.py``: loads
the newest full checkpoint in ``<workdir>/checkpoints`` and writes
``serving_step_{N}.msgpack`` beside it — the sampling parameters (the EMA
when tracked) without optimiser state, the JAX package's file.
``AudioCodec.from_workdir`` serves it when no full checkpoint exists. Host
I/O only: it runs on the CPU, as the JAX tool does.

Usage:  python -m meanflow_audio_codec_torch.tools.export_serving \\
            --workdir outputs/imf_frontier_v2
"""

from __future__ import annotations

import argparse
from pathlib import Path

from meanflow_audio_codec_torch.configs import load_config
from meanflow_audio_codec_torch.training.checkpoints import (
    find_latest_checkpoint,
    save_serving_checkpoint,
)
from meanflow_audio_codec_torch.training.trainer import load_flow_state


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workdir", required=True)
    args = parser.parse_args(argv)

    workdir = Path(args.workdir)
    checkpoint_dir = workdir / "checkpoints"
    checkpoint = find_latest_checkpoint(checkpoint_dir)
    if checkpoint is None:
        print(f"no full checkpoint under {checkpoint_dir}")
        return 1
    config = load_config(workdir / "config.json")
    state, _ = load_flow_state(checkpoint, config, device="cpu")
    path = save_serving_checkpoint(state, checkpoint_dir)
    print(f"wrote {path} ({path.stat().st_size / 1e6:.1f} MB) "
          f"from {checkpoint.name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
