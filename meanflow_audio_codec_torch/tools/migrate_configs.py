"""Batch config migration CLI: v1 flat JSON -> v2 hierarchical, in place or
to an output directory.

Counterpart of ``meanflow_audio_codec_torch/tools/migrate_configs.py``, with
its files byte for byte.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from meanflow_audio_codec_torch.configs import (
    config_from_dict,
    migrate_config_v1_to_v2,
)


def migrate_file(path: Path, out_path: Path, validate: bool = True) -> bool:
    """Returns True if the file needed migration."""
    data = json.loads(path.read_text())
    is_flat = "base" not in data and any(
        k in data for k in ("batch_size", "n_steps", "base_lr"))
    if not is_flat:
        if out_path != path:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(data, indent=2, sort_keys=True))
        return False
    migrated = migrate_config_v1_to_v2(data)
    if validate:
        config_from_dict(migrated)  # raises on invalid configs
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(migrated, indent=2, sort_keys=True))
    return True


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Migrate v1 configs to v2")
    parser.add_argument("paths", nargs="+", type=Path,
                        help="config files or directories")
    parser.add_argument("--out-dir", type=Path, default=None,
                        help="write migrated copies here (default: in place)")
    parser.add_argument("--no-validate", action="store_true")
    args = parser.parse_args(argv)

    files: list[Path] = []
    for path in args.paths:
        files.extend(sorted(path.glob("*.json")) if path.is_dir() else [path])
    migrated = 0
    for path in files:
        out = (args.out_dir / path.name) if args.out_dir else path
        try:
            if migrate_file(path, out, validate=not args.no_validate):
                migrated += 1
                print(f"migrated {path}")
        except Exception as exc:
            print(f"FAILED {path}: {exc}")
    print(f"{migrated}/{len(files)} files migrated")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
