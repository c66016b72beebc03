"""Carry Flax parameters of the ConvNeXt flow, and whole train states,
across between the JAX package and the port.

``flax_to_torch`` maps a Flax param tree (nested dicts of arrays, as
``model.init(...)["params"]`` or a checkpoint gives it) to a ``state_dict``
of :class:`~meanflow_audio_codec_torch.models.conv_flow.ConditionalConvFlow`;
``torch_to_flax`` is its inverse. ``train_state_to_flax`` and
``train_state_from_flax`` map the port's ``TrainState`` to and from the
state dict of the JAX package's ``TrainState`` (``step``, ``params``,
``opt_state``, ``ema_params``, ``ema_decay``), the tree its msgpack
checkpoints hold.
Layouts: a Dense kernel ``[in, out]`` becomes a Linear weight ``[out, in]``;
a 1x1 conv kernel ``[1, 1, in, out]`` becomes a Linear weight too (the port
runs 1x1 convs as Dense layers on channels-last activations); a spatial conv
kernel HWIO becomes OIHW. Any Flax leaf the table does not know raises, and
:func:`load_flax_params` loads strictly, so a missing one raises as well.
"""

from __future__ import annotations

import re
from collections.abc import Iterator, Mapping

import numpy as np
import torch
from torch import nn

# flax name -> (torch name, kind of module it names; None for a parameter)
_CHILDREN = {
    "flow": {"latent_proj": ("latent_proj", "dense"),
             "encoder": ("encoder", "encoder")},
    "stage": {"Dense_0": ("bottleneck_in", "dense"),
              "Dense_1": ("lift", "dense"),
              "Conv_0": ("lift_conv", "dense"),
              "FiLM_0": ("film", "film"),
              "ConvNeXtBlock_0": ("block", "block"),
              "Conv_1": ("unlift_conv", "dense"),
              "Dense_2": ("bottleneck_out", "dense"),
              "Dense_3": ("out", "dense")},
    "film": {"Dense_0": ("proj", "dense")},
    "block": {"Conv_0": ("conv", "conv"),
              "Conv_1": ("expand", "dense"),
              "GlobalResponseNormalization_0": ("grn", "grn"),
              "Conv_2": ("contract", "dense"),
              "layer_scale_gamma": ("layer_scale", None)},
    "dense": {"kernel": ("weight", None), "bias": ("bias", None)},
    "conv": {"kernel": ("weight", None), "bias": ("bias", None)},
    "grn": {"gamma": ("gamma", None), "beta": ("beta", None)},
}

_STAGE = re.compile(r"blocks_(\d+)$")


def _encoder_children(tree: Mapping) -> dict:
    # a non-square token width adds a lift Dense, which takes the name Dense_0
    dense = (({"Dense_0": ("lift", "dense"), "Dense_1": ("head", "dense")})
             if "Dense_1" in tree else {"Dense_0": ("head", "dense")})
    return {"Conv_0": ("convs.0", "conv"), "Conv_1": ("convs.1", "conv"),
            **dense}


def _children(kind: str, tree: Mapping) -> dict:
    return _encoder_children(tree) if kind == "encoder" else _CHILDREN[kind]


def _walk(tree: Mapping, kind: str, prefix: tuple[str, ...], flax_path: str
          ) -> Iterator[tuple[str, str, str, np.ndarray]]:
    table = _children(kind, tree)
    for name, value in tree.items():
        where = f"{flax_path}/{name}" if flax_path else name
        stage = _STAGE.match(name) if kind == "flow" else None
        if stage:
            torch_name, child = f"stages.{stage.group(1)}", "stage"
        elif name in table:
            torch_name, child = table[name]
        else:
            raise KeyError(f"Flax leaf {where!r} has no counterpart in the "
                           "port's ConditionalConvFlow")
        if child is None:
            if isinstance(value, Mapping):
                raise KeyError(f"Flax entry {where!r} is a module, expected "
                               "an array")
            yield ".".join(prefix + (torch_name,)), kind, name, np.asarray(value)
        else:
            if not isinstance(value, Mapping):
                raise KeyError(f"Flax entry {where!r} is an array, expected "
                               "a module")
            yield from _walk(value, child, prefix + (torch_name,), where)


def _convert(kind: str, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    if kind == "conv":
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if value.ndim == 4:  # 1x1 conv run as Dense
        value = value[0, 0]
    return value.T  # [in, out] -> [out, in]


def flax_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``ConditionalConvFlow`` params -> port ``state_dict`` (float32)."""
    state = {}
    for key, kind, leaf, value in _walk(params, "flow", (), ""):
        array = np.ascontiguousarray(_convert(kind, leaf, value),
                                     dtype=np.float32)
        state[key] = torch.from_numpy(array)
    return state


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load Flax params into ``model``; raises on any unused or missing leaf."""
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model


# ---------------------------------------------------------------------------
# port -> Flax
# ---------------------------------------------------------------------------


def _reverse_table(kind: str, has_lift: bool) -> dict:
    """torch name -> (flax name, kind of module it names) for ``kind``."""
    table = _children(kind, {"Dense_1": None} if has_lift else {})
    return {torch_name: (flax_name, child)
            for flax_name, (torch_name, child) in table.items()}


def _flax_path(name: str, has_lift: bool) -> tuple[list[str], str, str]:
    """(flax path, kind of the leaf's module, flax name of that module) of
    the port parameter ``name``."""
    tokens, path, kind, module = name.split("."), [], "flow", ""
    i = 0
    while i < len(tokens):
        if kind == "flow" and tokens[i] == "stages" and i + 1 < len(tokens):
            path.append(f"blocks_{tokens[i + 1]}")
            kind, module, i = "stage", path[-1], i + 2
            continue
        table = _reverse_table(kind, has_lift)
        key = next((k for k in (".".join(tokens[i:i + 2]), tokens[i])
                    if k in table), None)
        if key is None:
            raise KeyError(f"port parameter {name!r} has no Flax counterpart")
        flax_name, child = table[key]
        path.append(flax_name)
        i += len(key.split("."))
        if child is None:
            if i != len(tokens):
                raise KeyError(f"port parameter {name!r} has no Flax "
                               "counterpart")
            return path, kind, module
        kind, module = child, flax_name
    raise KeyError(f"port name {name!r} names a module, not a parameter")


def _unconvert(kind: str, module: str, leaf: str,
               value: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_convert`."""
    if leaf != "kernel":
        return value
    if kind == "conv":
        return value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    value = value.T  # [out, in] -> [in, out]
    if module.startswith("Conv_"):  # a 1x1 conv, run as a Dense layer
        value = value[None, None]
    return value


def _sorted_tree(tree: dict) -> dict:
    """Keys sorted at every level, as JAX orders a dict pytree."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def torch_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """Port ``state_dict`` (or any mapping of its parameter names) -> Flax
    ``ConditionalConvFlow`` param tree of float32 numpy arrays; the inverse
    of :func:`flax_to_torch`."""
    has_lift = any(name.startswith("encoder.lift.") for name in state)
    tree: dict = {}
    for name, tensor in state.items():
        path, kind, module = _flax_path(name, has_lift)
        value = tensor.detach().to("cpu", torch.float32).numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(
            _unconvert(kind, module, path[-1], value))
    return _sorted_tree(tree)


# ---------------------------------------------------------------------------
# train states
# ---------------------------------------------------------------------------


def _adamw_tree(count: np.ndarray, mu: dict, nu: dict, clip: bool,
                scheduled: bool) -> dict:
    """optax's state of ``chain(clip_by_global_norm, adamw(lr))`` (no clip
    node when the config sets no ``grad_clip_norm``): adamw is
    ``chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)``,
    whose last node counts updates only when the rate is a schedule (a
    warmup or a cosine decay), not a constant."""
    adamw = {"0": {"count": count, "mu": mu, "nu": nu}, "1": {},
             "2": {"count": count} if scheduled else {}}
    return {"0": {}, "1": adamw} if clip else adamw


def train_state_to_flax(state) -> dict:
    """The port ``TrainState`` as the flax state dict of the JAX package's
    ``TrainState`` after training: ``step``, the optax counts and
    ``ema_decay`` as 0-d arrays, ``ema_params`` None without EMA."""
    count = np.asarray(state.step, dtype=np.int32)

    def tree(tensors):
        return torch_to_flax(dict(zip(state.names, tensors)))

    optimizer = state.optimizer
    return {
        "step": count,
        "params": tree(state.params),
        "opt_state": _adamw_tree(count, tree(state.mu), tree(state.nu),
                                 bool(optimizer.grad_clip_norm),
                                 optimizer.scheduled),
        "ema_params": tree(state.ema) if state.ema is not None else None,
        "ema_decay": np.asarray(state.ema_decay or 0.999, dtype=np.float32),
    }


def _same_structure(got, want, where: str) -> None:
    """Raise ``ValueError`` where ``got`` differs from ``want`` in keys,
    in a None or in a leaf's shape."""
    if isinstance(want, dict):
        keys = sorted(got) if isinstance(got, dict) else type(got).__name__
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{where}: keys {keys} where the train state "
                             f"has {sorted(want)}")
        for key in want:
            _same_structure(got[key], want[key], f"{where}/{key}")
    elif want is None:
        if got is not None:
            raise ValueError(f"{where}: an array where the train state has "
                             "none")
    elif got is None or np.shape(got) != np.shape(want):
        shape = None if got is None else tuple(np.shape(got))
        raise ValueError(f"{where}: shape {shape} where the train state has "
                         f"{tuple(np.shape(want))}")


def train_state_from_flax(tree: Mapping, state) -> dict:
    """Check ``tree`` (a flax ``TrainState`` state dict, as a checkpoint
    holds it) against the port ``state`` and return its contents by the
    port's names, without writing anything: ``{"step": int, "params",
    "mu", "nu", "ema": {name: tensor} (ema None without EMA), "ema_decay":
    float}``. Raises ``ValueError`` where the structure or a shape
    differs."""
    _same_structure(tree, train_state_to_flax(state), "checkpoint")
    opt = tree["opt_state"]
    adam = (opt["1"] if state.optimizer.grad_clip_norm else opt)["0"]
    return {"step": int(np.asarray(tree["step"])),
            "params": flax_to_torch(tree["params"]),
            "mu": flax_to_torch(adam["mu"]), "nu": flax_to_torch(adam["nu"]),
            "ema": (flax_to_torch(tree["ema_params"])
                    if tree["ema_params"] is not None else None),
            "ema_decay": float(np.asarray(tree["ema_decay"]))}
