"""Checkpoints in the JAX package's two formats, msgpack and orbax, with
metadata sidecars, validation, retention and resume.

Counterpart of ``meanflow_audio_codec_tpu/training/checkpoints.py``, with
the same on-disk contract, so that either package resumes from the other's
files:

  * ``checkpoints/step_{N:05d}.msgpack``: the whole train state as the flax
    state dict of the JAX ``TrainState`` (``weights.train_state_to_flax``);
  * ``checkpoints/step_{N:05d}.orbax/`` (``checkpoint_format: "orbax"``):
    the directory orbax's ``PyTreeCheckpointer`` writes of the JAX state's
    ``step``, ``params``, ``opt_state`` (optax's tuples as lists, its empty
    states as None) and ``ema_params``, read and written by
    ``training/orbax`` without orbax;
  * ``step_{N:05d}.metadata.json``: step, timestamp, git commit, config
    SHA-256, torch version, device name, byte size, parameter count and the
    Flax parameter-shape map;
  * retention by ``max_checkpoints_to_keep``, keeping the final step;
  * corrupted checkpoints skipped on resume, newest to oldest;
  * ``serving_step_{N:05d}.msgpack``: the sampling parameters (EMA when
    tracked) and the step;
  * a params-only file (``save_params_only``): the Flax param tree alone.

Full checkpoints are matched by an anchored name pattern, so a
``serving_step_*`` file is never taken for one. A sharded run passes its
full state (``ShardedTrainState.full()``) and writes from rank 0 alone, so
the files are the same in either format.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from meanflow_audio_codec_torch import serialization, weights
from meanflow_audio_codec_torch.training.orbax import pytree

CHECKPOINT_RE = re.compile(r"^step_(\d+)\.(?:msgpack|orbax)$")
SERVING_RE = re.compile(r"^serving_step_(\d+)\.msgpack$")
MIN_CHECKPOINT_BYTES = 100
FORMATS = ("msgpack", "orbax")


def check_format(fmt: str | None) -> str:
    """The checkpoint format ``fmt`` names (None: msgpack); raises
    ``ValueError`` for another name."""
    fmt = fmt or "msgpack"
    if fmt not in FORMATS:
        raise ValueError(f"checkpoint_format {fmt!r}: expected one of "
                         f"{FORMATS}")
    return fmt


# ============================================================================
# Save / load primitives
# ============================================================================


def save_checkpoint(state, path: Path | str) -> Path:
    """Write the whole train state (device -> host -> disk)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(serialization.msgpack_serialize(
        weights.train_state_to_flax(state)))
    return path


def read_checkpoint(path: Path | str) -> Any:
    """The tree a msgpack checkpoint holds (arrays as CPU tensors)."""
    return serialization.msgpack_restore(Path(path).read_bytes())


def restore_train_state(tree: Any, state):
    """Write a checkpoint's tree into ``state`` (raises ``ValueError`` when
    its structure or a shape differs from the state's); returns ``state``."""
    contents = weights.train_state_from_flax(tree, state)
    with torch.no_grad():
        for name, param in zip(state.names, state.params):
            param.copy_(contents["params"][name])
        state.mu = [contents["mu"][n].to(state.device) for n in state.names]
        state.nu = [contents["nu"][n].to(state.device) for n in state.names]
        if state.ema is not None:
            state.ema = [contents["ema"][n].to(state.device)
                         for n in state.names]
            # as flax restores it: the checkpoint's decay wins
            state.ema_decay = contents["ema_decay"]
    state.step = contents["step"]
    return state


def load_checkpoint(path: Path | str, state):
    """Load a msgpack checkpoint into ``state``; returns ``state``."""
    return restore_train_state(read_checkpoint(path), state)


def save_params_only(state, path: Path | str) -> Path:
    """A params-only checkpoint for inference: the Flax param tree's msgpack
    bytes, as the JAX package's ``serialization.to_bytes(state.params)``
    writes them, so either package reads the other's file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(serialization.msgpack_serialize(weights.torch_to_flax(
        dict(zip(state.names, state.params)), state.model.architecture)))
    return path


def load_params_only(path: Path | str, model: torch.nn.Module
                     ) -> dict[str, torch.Tensor]:
    """The parameters of a params-only file by ``model``'s parameter names
    (a ``state_dict`` for ``model.load_state_dict``); raises
    ``ValueError`` where a name or a shape differs from ``model``'s."""
    params = weights.flax_to_torch(read_checkpoint(path), model.architecture)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != want:
        raise ValueError(f"params in {path} do not match the model: "
                         f"{sorted(set(got.items()) ^ set(want.items()))}")
    return params


# ---------------------------------------------------------------------------
# Orbax directories
# ---------------------------------------------------------------------------


def _state_arrays(state) -> dict:
    """The tree JAX's ``_state_arrays`` saves, as flax state-dict nodes:
    step, params, opt_state and ema_params (no ema_decay)."""
    tree = weights.train_state_to_flax(state)
    del tree["ema_decay"]
    return tree


def _optax_tree(node):
    """An optax state in the form orbax saves it: its tuples ("0", "1"...
    keyed dicts) as lists, its empty states as None."""
    if isinstance(node, dict):
        if not node:
            return None
        if all(k.isdigit() for k in node) and sorted(node, key=int) == [
                str(i) for i in range(len(node))]:
            return [_optax_tree(node[str(i)]) for i in range(len(node))]
        return {k: _optax_tree(v) for k, v in node.items()}
    return node


def _array_leaves(tree):
    """The array leaves of ``tree`` in JAX's flattening order (dict keys
    sorted, sequences in order, None and empty containers dropped)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _array_leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _array_leaves(value)
    elif tree is not None:
        yield tree


def _unflatten(template, leaves):
    """``template`` with its array leaves replaced, in order, from
    ``leaves``."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if template is None:
        return None
    return next(leaves)


def save_checkpoint_orbax(state, path: Path | str) -> Path:
    """Write the train state as an orbax directory checkpoint, replacing
    one that is there."""
    tree = _state_arrays(state)
    tree["opt_state"] = _optax_tree(tree["opt_state"])
    return pytree.save_pytree(path, tree)


def read_checkpoint_orbax(path: Path | str, state) -> dict:
    """The tree of an orbax checkpoint, as ``weights.train_state_to_flax``
    gives it for ``state`` (with ``state``'s ``ema_decay``). The restored
    leaves map onto the state's in flattening order, as the JAX package's
    ``load_checkpoint_orbax`` maps them; raises ``ValueError`` when their
    number or a shape differs."""
    leaves = list(_array_leaves(pytree.restore_pytree(path)))
    target = _state_arrays(state)
    want = list(_array_leaves(target))
    if len(leaves) != len(want):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, the train "
                         f"state expects {len(want)}")
    for got, expected in zip(leaves, want):
        if tuple(np.shape(got)) != tuple(np.shape(expected)):
            raise ValueError(f"checkpoint leaf shape {tuple(np.shape(got))}"
                             f" != train state's {tuple(np.shape(expected))}")
    tree = _unflatten(target, iter(leaves))
    tree["ema_decay"] = np.asarray(state.ema_decay or 0.999)
    return tree


def load_checkpoint_orbax(path: Path | str, state):
    """Load an orbax checkpoint into ``state`` (keeping its ``ema_decay``);
    returns ``state``."""
    return restore_train_state(read_checkpoint_orbax(path, state), state)


def orbax_checkpoint_has_ema(path: Path | str) -> bool:
    """True when an orbax checkpoint stores an EMA copy, read from its
    metadata alone (a run without EMA saves ``ema_params`` None)."""
    tree = pytree.pytree_metadata(path)
    return isinstance(tree, dict) and tree.get("ema_params") is not None


# ---------------------------------------------------------------------------
# Serving checkpoints
# ---------------------------------------------------------------------------


def save_serving_checkpoint(state, checkpoint_dir: Path | str,
                            step: int | None = None) -> Path:
    """Write ``serving_step_{N:05d}.msgpack``: the sampling parameters (EMA
    when tracked, else the live parameters) and the step, no optimiser
    state."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    step = int(step if step is not None else state.step)
    tensors = state.ema if state.ema is not None else state.params
    payload = {"step": step,
               "params": weights.torch_to_flax(dict(zip(state.names,
                                                        tensors)),
                                               state.model.architecture)}
    path = checkpoint_dir / f"serving_step_{step:05d}.msgpack"
    path.write_bytes(serialization.msgpack_serialize(payload))
    return path


def load_serving_checkpoint(path: Path | str, architecture: str = "convnet"
                            ) -> tuple[int, dict[str, torch.Tensor]]:
    """``(step, state_dict)`` of a serving checkpoint of an
    ``architecture`` model, by the port's parameter names."""
    payload = read_checkpoint(path)
    return int(payload["step"]), weights.flax_to_torch(payload["params"],
                                                       architecture)


def is_serving_checkpoint(path: Path | str) -> bool:
    return SERVING_RE.match(Path(path).name) is not None


def find_latest_serving_checkpoint(checkpoint_dir: Path | str) -> Path | None:
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.exists():
        return None
    found = sorted((p for p in checkpoint_dir.glob("serving_step_*.msgpack")
                    if is_serving_checkpoint(p)),
                   key=lambda p: int(SERVING_RE.match(p.name).group(1)))
    return found[-1] if found else None


# ============================================================================
# Metadata sidecars
# ============================================================================


def _git_commit() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def config_hash(config: Any) -> str | None:
    blob = json.dumps(config.to_dict(), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def count_params(state) -> int:
    return sum(p.numel() for p in state.params)


def _param_shapes(state) -> dict:
    tree = weights.torch_to_flax(dict(zip(state.names, state.params)),
                                 state.model.architecture)

    def flat(node, prefix=""):
        for key, value in node.items():
            name = f"{prefix}/{key}" if prefix else key
            if isinstance(value, dict):
                yield from flat(value, name)
            else:
                yield name, list(np.shape(value))

    return dict(flat(tree))


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _checkpoint_bytes(path: Path) -> int | None:
    if path.is_dir():
        return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    return path.stat().st_size if path.exists() else None


def checkpoint_metadata(state, path: Path, config: Any | None = None) -> dict:
    return {
        "step": int(state.step),
        "timestamp": time.time(),
        "datetime": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "git_commit": _git_commit(),
        "config_hash": config_hash(config) if config is not None else None,
        "torch_version": torch.__version__,
        "platform": device_name(state.device),
        "checkpoint_bytes": _checkpoint_bytes(path),
        "param_count": count_params(state),
        "param_shapes": _param_shapes(state),
    }


def save_checkpoint_with_metadata(state, checkpoint_dir: Path | str,
                                  step: int | None = None,
                                  config: Any | None = None,
                                  fmt: str | None = None) -> Path:
    """Write ``step_{N:05d}.msgpack`` (or the ``.orbax`` directory) and its
    metadata sidecar."""
    fmt = check_format(fmt)
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    step = int(state.step) if step is None else int(step)
    path = checkpoint_dir / f"step_{step:05d}.{fmt}"
    if fmt == "orbax":
        save_checkpoint_orbax(state, path)
    else:
        save_checkpoint(state, path)
    meta = checkpoint_metadata(state, path, config)
    meta["step"] = step
    meta["format"] = fmt
    sidecar = checkpoint_dir / f"step_{step:05d}.metadata.json"
    sidecar.write_text(json.dumps(meta, indent=2))
    return path


# ============================================================================
# Validation
# ============================================================================


def validate_checkpoint_file(path: Path | str) -> tuple[bool, str]:
    """Cheap integrity checks: exists, minimum size, msgpack parse (an
    orbax directory: not empty)."""
    path = Path(path)
    if not path.exists():
        return False, "file does not exist"
    if path.is_dir():
        has_payload = any(path.rglob("*"))
        return has_payload, "ok" if has_payload else "empty orbax dir"
    if path.stat().st_size < MIN_CHECKPOINT_BYTES:
        return False, f"file too small ({path.stat().st_size} bytes)"
    try:
        read_checkpoint(path)
    except (ValueError, TypeError, RuntimeError, UnicodeDecodeError) as exc:
        return False, f"msgpack decode failed: {exc}"
    return True, "ok"


def validate_checkpoint_structure(path: Path | str,
                                  state) -> tuple[bool, str]:
    """Deep check: the checkpoint's tree matches ``state`` leaf for leaf
    (an orbax directory is read whole, every chunk decoded)."""
    path = Path(path)
    if not path.exists():
        return False, "file does not exist"
    if path.is_dir():
        ok, reason = validate_checkpoint_file(path)
        if not ok:
            return ok, reason
    elif path.stat().st_size < MIN_CHECKPOINT_BYTES:
        return False, f"file too small ({path.stat().st_size} bytes)"
    try:
        tree = (read_checkpoint_orbax(path, state) if path.is_dir()
                else read_checkpoint(path))
        weights.train_state_from_flax(tree, state)
    except (ValueError, TypeError, KeyError, RuntimeError,
            UnicodeDecodeError) as exc:
        return False, f"structure mismatch: {exc}"
    return True, "ok"


def validate_config_compatibility(checkpoint_path: Path | str,
                                  config: Any) -> tuple[bool, str]:
    """Compare the sidecar's stored config hash with ``config``'s."""
    checkpoint_path = Path(checkpoint_path)
    stem = checkpoint_path.name.rsplit(".", 1)[0]
    sidecar = checkpoint_path.parent / f"{stem}.metadata.json"
    if not sidecar.exists():
        return True, "no metadata sidecar; skipping compatibility check"
    try:
        stored = json.loads(sidecar.read_text()).get("config_hash")
    except (OSError, ValueError, AttributeError) as exc:
        return True, f"unreadable sidecar ({exc}); skipping"
    current = config_hash(config)
    if stored and current and stored != current:
        return False, "config hash mismatch (training config changed)"
    return True, "ok"


# ============================================================================
# Discovery / retention / resume
# ============================================================================


def get_checkpoint_step(path: Path | str) -> int | None:
    match = CHECKPOINT_RE.match(Path(path).name)
    return int(match.group(1)) if match else None


def list_checkpoints(checkpoint_dir: Path | str) -> list[Path]:
    """Full checkpoints (``step_N.msgpack`` files and ``step_N.orbax``
    directories), sorted by step."""
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.exists():
        return []
    found = [p for pattern in ("step_*.msgpack", "step_*.orbax")
             for p in checkpoint_dir.glob(pattern)
             if get_checkpoint_step(p) is not None]
    return sorted(found, key=get_checkpoint_step)


def find_latest_checkpoint(checkpoint_dir: Path | str) -> Path | None:
    """The full checkpoint of the highest step, not validated."""
    found = list_checkpoints(checkpoint_dir)
    return found[-1] if found else None


def find_valid_checkpoint(checkpoint_dir: Path | str,
                          state=None) -> Path | None:
    """The newest checkpoint that passes validation (against ``state`` when
    given), skipping corrupted files."""
    for path in reversed(list_checkpoints(checkpoint_dir)):
        if state is not None:
            ok, reason = validate_checkpoint_structure(path, state)
        else:
            ok, reason = validate_checkpoint_file(path)
        if ok:
            return path
        print(f"Skipping invalid checkpoint {path.name}: {reason}")
    return None


def cleanup_old_checkpoints(checkpoint_dir: Path | str,
                            max_to_keep: int | None,
                            keep_final: bool = True,
                            final_step: int | None = None) -> list[Path]:
    """Delete the oldest checkpoints beyond ``max_to_keep`` (never the one at
    ``final_step`` with ``keep_final``) and their sidecars; returns the
    deleted paths."""
    if max_to_keep is None:
        return []
    checkpoints = list_checkpoints(checkpoint_dir)
    protected = set()
    if keep_final and final_step is not None:
        protected = {p for p in checkpoints
                     if get_checkpoint_step(p) == final_step}
    excess = len(checkpoints) - max_to_keep
    deleted = []
    for path in checkpoints:
        if excess <= 0:
            break
        if path in protected:
            continue
        if path.is_dir():
            shutil.rmtree(path, ignore_errors=True)
        else:
            path.unlink(missing_ok=True)
        stem = path.name.rsplit(".", 1)[0]
        (path.parent / f"{stem}.metadata.json").unlink(missing_ok=True)
        deleted.append(path)
        excess -= 1
    return deleted


def load_checkpoint_and_resume(checkpoint_dir: Path | str, state
                               ) -> tuple[Any, int] | None:
    """Load the newest valid checkpoint into ``state``; returns
    ``(state, start_step)``, or None when there is none."""
    path = find_valid_checkpoint(checkpoint_dir, state)
    if path is None:
        return None
    if path.is_dir():
        load_checkpoint_orbax(path, state)
    else:
        load_checkpoint(path, state)
    return state, get_checkpoint_step(path)
