"""Save and restore a nested dict/list tree as an orbax checkpoint
directory, the layout ``orbax.checkpoint.PyTreeCheckpointer`` 0.11 writes
with its defaults::

    <path>/_CHECKPOINT_METADATA   JSON: the handler's name, timestamps
    <path>/_METADATA              JSON: one entry per leaf in tree_metadata
    <path>/manifest.ocdbt, d/...  the OCDBT database of zarr v2 arrays

``tree_metadata`` is keyed by the leaf's path as a tuple's repr,
``"('opt_state', '1', '0', 'mu', 'Dense_0', 'kernel')"``, each with its
``key_metadata`` (``key_type`` 1 for a sequence index, 2 for a dict key)
and ``value_metadata``: ``value_type`` ``np.ndarray`` (arrays and
tensors), ``scalar`` (Python and numpy scalars), or, with
``skip_deserialize`` true, ``None``, ``Dict`` (an empty dict) or ``List``
(an empty list or tuple). An array leaf is the zarr array named by its
path's keys joined with ".".

A checkpoint is written into a temporary sibling directory and renamed to
``path`` at the end, so an interrupted save never leaves a directory under
the final name.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from meanflow_audio_codec_torch.training.orbax import ocdbt, zarr

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ITEM_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
                "PyTreeCheckpointHandler")
SEQUENCE, DICT = 1, 2
#: value types stored without data, and what each restores as
_SKIPPED = {"None": lambda: None, "Dict": dict, "List": list}


def _leaves(tree: Any, keys: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``((key, key_type), ...), leaf`` in JAX's flattening order: dict
    keys sorted, sequences in order; an empty container is a leaf."""
    if isinstance(tree, dict):
        if not tree:
            yield keys, tree
        for key in sorted(tree):
            if not isinstance(key, str):
                raise TypeError(f"dict key {key!r} is not a string")
            yield from _leaves(tree[key], keys + ((key, DICT),))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            yield keys, []
        for i, value in enumerate(tree):
            yield from _leaves(value, keys + ((str(i), SEQUENCE),))
    else:
        yield keys, tree


def _value_type(leaf: Any) -> str:
    if leaf is None:
        return "None"
    if isinstance(leaf, dict):
        return "Dict"
    if isinstance(leaf, list):
        return "List"
    if isinstance(leaf, (np.ndarray, torch.Tensor)):
        return "np.ndarray"
    if isinstance(leaf, (bool, int, float, np.generic)):
        return "scalar"
    raise TypeError(f"cannot store a {type(leaf).__name__} leaf")


def _scalar_array(leaf) -> np.ndarray:
    if isinstance(leaf, bool):
        return np.asarray(leaf, np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float64)
    return np.asarray(leaf)


def tree_metadata(tree: Any) -> dict:
    """``_METADATA``'s ``tree_metadata`` for ``tree``."""
    out = {}
    for keys, leaf in _leaves(tree):
        kind = _value_type(leaf)
        out[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": kind,
                               "skip_deserialize": kind in _SKIPPED}}
    return out


def save_pytree(path: Path | str, tree: Any) -> Path:
    """Write ``tree`` (nested dicts, lists and tuples of tensors, numpy
    arrays, scalars and None) as an orbax checkpoint at ``path``,
    replacing what is there; returns the path."""
    path = Path(path).absolute()
    started = time.time_ns()
    tmp = path.with_name(f"{path.name}.orbax-checkpoint-tmp-{started}")
    metadata = tree_metadata(tree)  # refuses an unknown leaf before writing
    tmp.mkdir(parents=True)
    try:
        writer = ocdbt.Writer(tmp)
        try:
            for keys, leaf in _leaves(tree):
                kind = _value_type(leaf)
                if kind in _SKIPPED:
                    continue
                value = leaf if kind == "np.ndarray" else _scalar_array(leaf)
                zarr.write_array(writer, ".".join(k for k, _ in keys), value)
        except BaseException:
            writer.close()
            raise
        writer.commit()
        (tmp / METADATA).write_text(json.dumps({
            "tree_metadata": metadata, "use_ocdbt": True,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}))
        (tmp / CHECKPOINT_METADATA).write_text(json.dumps({
            "item_handlers": ITEM_HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": started,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}))
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _read_metadata(path: Path) -> dict:
    try:
        meta = json.loads((path / METADATA).read_text())
    except (OSError, ValueError) as exc:
        raise ValueError(f"{path}: unreadable {METADATA} ({exc})") from None
    if not isinstance(meta, dict) or not isinstance(
            meta.get("tree_metadata"), dict):
        raise ValueError(f"{path}: {METADATA} has no tree_metadata")
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 arrays are not supported")
    if meta.get("use_ocdbt") is False:
        raise ValueError(f"{path}: checkpoints without OCDBT are not "
                         "supported")
    return meta["tree_metadata"]


class _Node:
    """An inner node while a tree is assembled: its key type and
    children."""

    def __init__(self):
        self.kind: int | None = None
        self.children: dict[str, Any] = {}


def _assemble(entries: list[tuple[list[dict], Any]], where: Path) -> Any:
    """The nested tree of ``(key_metadata, value)`` pairs."""
    if len(entries) == 1 and not entries[0][0]:
        return entries[0][1]
    root = _Node()
    for keys, value in entries:
        if not keys:
            raise ValueError(f"{where}: a root leaf beside other leaves")
        node = root
        for depth, key in enumerate(keys):
            kind = key.get("key_type")
            if kind not in (SEQUENCE, DICT):
                raise ValueError(f"{where}: unknown key_type {kind!r}")
            if node.kind not in (None, kind):
                raise ValueError(f"{where}: mixed key types under one node")
            node.kind = kind
            name = str(key["key"])
            child = node.children.get(name)
            if depth == len(keys) - 1:
                if child is not None or name in node.children:
                    raise ValueError(f"{where}: leaf {name!r} twice")
                node.children[name] = value
            else:
                if child is None:
                    child = node.children[name] = _Node()
                elif not isinstance(child, _Node):
                    raise ValueError(f"{where}: a leaf where a node is")
                node = child

    def build(node):
        if not isinstance(node, _Node):
            return node
        if node.kind == DICT:
            return {k: build(v) for k, v in node.children.items()}
        names = node.children
        if sorted(names, key=lambda n: int(n) if n.isdigit() else -1) != [
                str(i) for i in range(len(names))]:
            raise ValueError(f"{where}: sequence indices {sorted(names)} "
                             "are not 0..n-1")
        return [build(names[str(i)]) for i in range(len(names))]

    return build(root)


def restore_pytree(path: Path | str) -> Any:
    """The tree saved at ``path``: dicts, lists, CPU tensors for arrays,
    Python numbers for scalars, and None, {} or [] where those were saved.
    Raises ``ValueError`` on any fault of the directory."""
    path = Path(path)
    metadata = _read_metadata(path)
    db = ocdbt.Database(path)
    entries = []
    for name, entry in metadata.items():
        keys = entry["key_metadata"]
        kind = entry["value_metadata"]["value_type"]
        if kind in _SKIPPED:
            value = _SKIPPED[kind]()
        elif kind in ("np.ndarray", "scalar"):
            value = zarr.read_array(db, ".".join(str(k["key"])
                                                 for k in keys))
            if kind == "scalar":
                value = value.item()
        else:
            raise ValueError(f"{path}: leaf {name} has unknown value_type "
                             f"{kind!r}")
        entries.append((keys, value))
    return _assemble(entries, path)


def pytree_metadata(path: Path | str) -> Any:
    """The saved tree's structure without reading any array: each leaf is
    its ``value_type``, and None, {} or [] where those were saved."""
    path = Path(path)
    entries = []
    for entry in _read_metadata(path).values():
        kind = entry["value_metadata"]["value_type"]
        entries.append((entry["key_metadata"],
                        _SKIPPED[kind]() if kind in _SKIPPED else kind))
    return _assemble(entries, path)
