"""Carry Flax parameters of every model family, and whole train states,
across between the JAX package and the port.

``flax_to_torch`` maps a Flax param tree (nested dicts of arrays, as
``model.init(...)["params"]`` or a checkpoint gives it) to a ``state_dict``
of the port's model of the family ``architecture`` names (a config's
``architecture``, or ``"mlp_mixer_autoencoder"``; each model class states
its own); ``torch_to_flax`` is its inverse.
``train_state_to_flax`` and ``train_state_from_flax`` map the port's
``TrainState`` to and from the state dict of the JAX package's
``TrainState`` (``step``, ``params``, ``opt_state``, ``ema_params``,
``ema_decay``), the tree its msgpack checkpoints hold.
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

_WEIGHTING = {"loss_weighting": ("loss_weighting", "loss_weighting")}
_LAYER = {"kernel": ("weight", None), "bias": ("bias", None)}

# kind of module -> {flax name: (torch name, kind of module it names; None
# for a parameter)}; "{i}" stands for the index of a list of modules
_CHILDREN = {
    # the ConvNeXt flow (its encoder's table depends on the tree: _children)
    "flow": {"latent_proj": ("latent_proj", "dense"),
             "encoder": ("encoder", "encoder"),
             "blocks_{i}": ("stages.{i}", "stage"),
             # the learned loss weighting's polynomial (ops/losses.py)
             **_WEIGHTING},
    "stage": {"Dense_0": ("bottleneck_in", "dense"),
              "Dense_1": ("lift", "dense"),
              "Conv_0": ("lift_conv", "conv1x1"),
              "FiLM_0": ("film", "film"),
              "ConvNeXtBlock_0": ("block", "block"),
              "Conv_1": ("unlift_conv", "conv1x1"),
              "Dense_2": ("bottleneck_out", "dense"),
              "Dense_3": ("out", "dense")},
    "film": {"Dense_0": ("proj", "dense")},
    "block": {"Conv_0": ("conv", "conv"),
              "Conv_1": ("expand", "conv1x1"),
              "GlobalResponseNormalization_0": ("grn", "grn"),
              "Conv_2": ("contract", "conv1x1"),
              "layer_scale_gamma": ("layer_scale", None)},
    # the MLP flow
    "mlp_flow": {"encoder": ("encoder", "mlp_encoder"),
                 "blocks_{i}": ("blocks.{i}", "residual_block"),
                 **_WEIGHTING},
    "mlp_encoder": {"MLP_0": ("mlp", "mlp")},
    "residual_block": {"MLP_0": ("modulation", "mlp"),
                       "MLP_1": ("mlp", "mlp")},
    "mlp": {"Dense_0": ("fc1", "dense"), "Dense_1": ("fc2", "dense")},
    # the MLP-Mixer flow and autoencoder
    "mixer_flow": {"stages_{i}": ("stages.{i}", "mixer_stage"),
                   "latent_proj": ("latent_proj", "dense"),
                   "encoder": ("encoder", "mixer_encoder"),
                   **_WEIGHTING},
    "mixer_stage": {"Dense_0": ("lift", "dense"),
                    "MixerBlock_0": ("block", "mixer_block"),
                    "Dense_1": ("out", "dense")},
    "mixer_block": {"Dense_0": ("token_modulation", "dense"),
                    "MLP_0": ("token_mix", "mlp"),
                    "Dense_1": ("channel_modulation", "dense"),
                    "MLP_1": ("channel_mix", "mlp")},
    "mixer_encoder": {"Dense_0": ("context", "dense"),
                      "latent_queries": ("latent_queries", None),
                      "condition_emb": ("condition_emb", None),
                      "MixerBlock_0": ("block", "mixer_block")},
    "mixer_decoder": {"output_queries": ("output_queries", None),
                      "condition_emb": ("condition_emb", None),
                      "MixerBlock_0": ("block", "mixer_block"),
                      "Dense_0": ("out", "dense")},
    "mixer_autoencoder": {"encoder": ("encoder", "mixer_encoder"),
                          "decoder": ("decoder", "mixer_decoder")},
    # the simple conv flow
    "simple_conv_flow": {
        "latent_proj": ("latent_proj", "dense"),
        "encoder_head": ("encoder_head", "dense"),
        **{name: (name, "simple_conv_block")
           for name in ("down1", "down2", "mid", "up2", "up1")},
        "skip_proj": ("skip_proj", "conv1x1"),
        "out_conv": ("out_conv", "conv1x1"),
        "lift": ("lift", "dense"), "unlift": ("unlift", "dense"),
        **_WEIGHTING},
    "simple_conv_block": {"Conv_0": ("conv1", "conv"),
                          "FiLM_0": ("film", "film"),
                          "Conv_1": ("conv2", "conv"),
                          "Conv_2": ("residual_proj", "conv1x1")},
    # layers
    "dense": _LAYER,
    "conv": _LAYER,
    "conv1x1": _LAYER,
    "grn": {"gamma": ("gamma", None), "beta": ("beta", None)},
    "loss_weighting": {"poly": ("poly", None)},
}


#: the table of each family, by its ``architecture``
ROOTS = {"convnet": "flow", "mlp": "mlp_flow", "mlp_mixer": "mixer_flow",
         "simple_conv": "simple_conv_flow",
         "mlp_mixer_autoencoder": "mixer_autoencoder"}


def _root(architecture: str) -> str:
    if architecture not in ROOTS:
        raise ValueError(f"no weight table for architecture "
                         f"{architecture!r}; known: {sorted(ROOTS)}")
    return ROOTS[architecture]


def _encoder_children(tree: Mapping) -> dict:
    # a non-square token width adds a lift Dense, which takes the name Dense_0
    dense = (({"Dense_0": ("lift", "dense"), "Dense_1": ("head", "dense")})
             if "Dense_1" in tree else {"Dense_0": ("head", "dense")})
    return {"Conv_0": ("convs.0", "conv"), "Conv_1": ("convs.1", "conv"),
            **dense}


def _children(kind: str, tree: Mapping) -> dict:
    return _encoder_children(tree) if kind == "encoder" else _CHILDREN[kind]


def _lookup(table: dict, name: str) -> tuple[str, str | None] | None:
    """(torch name, kind) of the Flax child ``name`` in ``table``."""
    if name in table:
        return table[name]
    for key, (torch_name, child) in table.items():
        if "{i}" in key:
            match = re.fullmatch(key.replace("{i}", r"(\d+)"), name)
            if match:
                return torch_name.replace("{i}", match.group(1)), child
    return None


def _walk(tree: Mapping, kind: str, prefix: tuple[str, ...], flax_path: str
          ) -> Iterator[tuple[str, str, str, np.ndarray]]:
    table = _children(kind, tree)
    for name, value in tree.items():
        where = f"{flax_path}/{name}" if flax_path else name
        entry = _lookup(table, name)
        if entry is None:
            raise KeyError(f"Flax leaf {where!r} has no counterpart in the "
                           "port's model")
        torch_name, child = entry
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
    if kind == "conv1x1":  # run as Dense
        value = value[0, 0]
    return value.T  # [in, out] -> [out, in]


def flax_to_torch(params: Mapping, architecture: str = "convnet"
                  ) -> dict[str, torch.Tensor]:
    """Flax params of an ``architecture`` model -> the port's ``state_dict``
    (float32)."""
    state = {}
    for key, kind, leaf, value in _walk(params, _root(architecture), (), ""):
        array = np.ascontiguousarray(_convert(kind, leaf, value),
                                     dtype=np.float32)
        state[key] = torch.from_numpy(array)
    return state


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load Flax params into ``model``; raises on any unused or missing leaf."""
    model.load_state_dict(flax_to_torch(params, model.architecture),
                          strict=True)
    return model


# ---------------------------------------------------------------------------
# port -> Flax
# ---------------------------------------------------------------------------


def _reverse_match(table: dict, tokens: list[str], i: int
                   ) -> tuple[str, str | None, int] | None:
    """(flax name, kind, tokens used) of the torch name at ``tokens[i:]``."""
    for flax_name, (torch_name, child) in table.items():
        n = torch_name.count(".") + 1
        candidate = ".".join(tokens[i:i + n])
        if "{i}" not in torch_name:
            if candidate == torch_name:
                return flax_name, child, n
            continue
        match = re.fullmatch(re.escape(torch_name).replace(
            re.escape("{i}"), r"(\d+)"), candidate)
        if match:
            return flax_name.replace("{i}", match.group(1)), child, n
    return None


def _flax_path(name: str, root: str, has_lift: bool
               ) -> tuple[list[str], str]:
    """(flax path, kind of the leaf's module) of the port parameter
    ``name`` of a model of kind ``root``."""
    tokens, path, kind, i = name.split("."), [], root, 0
    while i < len(tokens):
        table = _children(kind, {"Dense_1": None} if has_lift else {})
        entry = _reverse_match(table, tokens, i)
        if entry is None:
            raise KeyError(f"port parameter {name!r} has no Flax counterpart")
        flax_name, child, used = entry
        path.append(flax_name)
        i += used
        if child is None:
            if i != len(tokens):
                raise KeyError(f"port parameter {name!r} has no Flax "
                               "counterpart")
            return path, kind
        kind = child
    raise KeyError(f"port name {name!r} names a module, not a parameter")


def _unconvert(kind: str, leaf: str, value: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_convert`."""
    if leaf != "kernel":
        return value
    if kind == "conv":
        return value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    value = value.T  # [out, in] -> [in, out]
    if kind == "conv1x1":  # run as a Dense layer
        value = value[None, None]
    return value


def _sorted_tree(tree: dict) -> dict:
    """Keys sorted at every level, as JAX orders a dict pytree."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def torch_to_flax(state: Mapping[str, torch.Tensor],
                  architecture: str = "convnet") -> dict:
    """Port ``state_dict`` of an ``architecture`` model (or any mapping of
    its parameter names) -> its Flax param tree, of float32 numpy arrays;
    the inverse of :func:`flax_to_torch`."""
    root = _root(architecture)
    has_lift = any(name.startswith("encoder.lift.") for name in state)
    tree: dict = {}
    for name, tensor in state.items():
        path, kind = _flax_path(name, root, has_lift)
        value = tensor.detach().to("cpu", torch.float32).numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(
            _unconvert(kind, path[-1], value))
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
        return torch_to_flax(dict(zip(state.names, tensors)),
                             state.model.architecture)

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
    arch = state.model.architecture
    return {"step": int(np.asarray(tree["step"])),
            "params": flax_to_torch(tree["params"], arch),
            "mu": flax_to_torch(adam["mu"], arch),
            "nu": flax_to_torch(adam["nu"], arch),
            "ema": (flax_to_torch(tree["ema_params"], arch)
                    if tree["ema_params"] is not None else None),
            "ema_decay": float(np.asarray(tree["ema_decay"]))}
