"""Carry Flax parameters of the ConvNeXt flow across to the port.

``flax_to_torch`` maps a Flax param tree (nested dicts of arrays, as
``model.init(...)["params"]`` or a checkpoint gives it) to a ``state_dict``
of :class:`~meanflow_audio_codec_torch.models.conv_flow.ConditionalConvFlow`.
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
