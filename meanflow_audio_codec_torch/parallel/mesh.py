"""The (data, model) device mesh and the placement of the train state;
counterpart of ``meanflow_audio_codec_tpu/parallel/mesh.py``.

JAX builds a ``jax.sharding.Mesh`` over the devices of one process and lets
XLA insert the collectives. Here each device is a process (a rank of the
default group), the mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with axes ``("data", "model")``, and a placement is a tuple of DTensor
placements, one per mesh axis:

  * ``data``: the batch is split over the data ranks; the gradient is
    averaged over them before the clip and the AdamW update
    (:class:`~meanflow_audio_codec_torch.parallel.sharded_state.ShardedTrainState`).
  * ``model``: the large kernels are split by JAX's tensor-parallel rule
    (:func:`param_partition_spec`), and AdamW's moments and the EMA copy
    follow them leaf by leaf. Each model rank updates its shard; the full
    weights are gathered over the model axis before the forward, as XLA
    gathers where a partitioned activation meets a norm or a spatial op, so
    no kernel and no norm ever sees a partial channel axis.

The rule is JAX's, decided on the Flax layout of each parameter (Dense
``[in, out]``, conv ``[kh, kw, cin, cout]``); the port's layouts
(``nn.Linear`` ``[out, in]``, conv ``[cout, cin, kh, kw]``) are mapped back
to it (``weights.py``), so the same leaves split on the same logical axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(data: int = -1, model: int = 1, devices: list | None = None,
                device_type: str | None = None) -> DeviceMesh:
    """Build a (data, model) mesh over ``devices`` (ranks of the default
    group; all of them by default); data=-1 means all remaining ranks.

    The sizes are checked as JAX checks them, before any group is touched;
    building the mesh needs the default process group
    (:func:`~meanflow_audio_codec_torch.parallel.initialize_distributed`).
    ``device_type`` defaults to ``cuda`` and raises without a card
    (:func:`~meanflow_audio_codec_torch.device.resolve_device`); a mesh of
    CPU ranks asks for ``device_type="cpu"``.
    """
    if devices is None:
        devices = list(range(dist.get_world_size()
                             if dist.is_initialized() else 1))
    devices = list(devices)
    n = len(devices)
    if model <= 0:
        raise ValueError(f"model axis size must be positive, got {model}")
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} does not match {n} devices")
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs the default process group: "
                           "call initialize_distributed() first")
    device_type = resolve_device(device_type or "cuda").type
    grid = torch.tensor(devices, dtype=torch.int64).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS,
                                                         MODEL_AXIS))


def mesh_from_config(config: Any, devices: list | None = None,
                     device_type: str | None = None) -> DeviceMesh:
    return create_mesh(data=config.mesh_data, model=config.mesh_model,
                       devices=devices, device_type=device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


@dataclass(frozen=True)
class NamedSharding:
    """A placement on ``mesh``: one DTensor placement per mesh axis."""

    mesh: DeviceMesh
    placements: tuple


def batch_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Shard the leading (batch) axis over 'data', replicate the rest."""
    return NamedSharding(mesh, (Shard(0), Replicate()))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, (Replicate(), Replicate()))


def local_batch(batch: torch.Tensor, mesh: DeviceMesh,
                dim: int = 0) -> torch.Tensor:
    """This data rank's slice of a global ``batch`` along ``dim``."""
    n = axis_size(mesh, DATA_AXIS)
    per = batch.shape[dim] // n
    return batch.narrow(dim, mesh.get_local_rank(DATA_AXIS) * per, per)


#: kernels below this element count are replicated regardless of shape.
_TP_MIN_PARAM_SIZE = 16384


def param_partition_spec(path: tuple, leaf, model_size: int) -> tuple:
    """JAX's tensor-parallel rule on a Flax-layout ``leaf`` (an array or a
    shape), as the entries of its ``PartitionSpec``: ``()`` replicates.

    * 2-d Dense kernels: partition the *larger* contraction-side axis, so a
      lift ``[bneck, S*S*C]`` column-shards (``(None, 'model')``) and its
      paired projection ``[S*S*C, bneck]`` row-shards (``('model', None)``).
    * 4-d conv kernels ``[kh, kw, cin, cout]``: shard the output channels.
    * everything else (biases, scales, small kernels) replicates.
    """
    shape = tuple(getattr(leaf, "shape", leaf))
    if math.prod(shape) < _TP_MIN_PARAM_SIZE:
        return ()
    if len(shape) == 2:
        rows, cols = shape
        if cols >= rows and cols % model_size == 0:
            return (None, MODEL_AXIS)
        if rows > cols and rows % model_size == 0:
            return (MODEL_AXIS, None)
        return ()
    if len(shape) == 4 and shape[-1] % model_size == 0:
        return (None, None, None, MODEL_AXIS)
    return ()


def flax_layout(name: str, shape: tuple, architecture: str,
                has_lift: bool) -> tuple[tuple, tuple]:
    """(Flax-layout shape, the port dim behind each Flax dim) of the port
    parameter ``name`` of ``shape``: the transposes of ``weights.py``
    (conv OIHW -> HWIO, Dense ``[out, in]`` -> ``[in, out]``, a 1x1 conv run
    as Dense -> ``[1, 1, in, out]``, whose leading dims have no port dim)."""
    path, kind = weights._flax_path(name, weights._root(architecture),
                                    has_lift)
    if path[-1] != "kernel":
        sources = tuple(range(len(shape)))
    elif kind == "conv":
        sources = (2, 3, 1, 0)
    elif kind == "conv1x1":
        sources = (None, None, 1, 0)
    else:
        sources = (1, 0)
    return tuple(1 if d is None else shape[d] for d in sources), sources


def port_placement(name: str, shape: tuple, architecture: str,
                   has_lift: bool, model_size: int) -> tuple:
    """The (data, model) placements of the port parameter ``name``: JAX's
    rule on its Flax layout, the split carried to the port's dim."""
    if model_size <= 1:
        return (Replicate(), Replicate())
    flax_shape, sources = flax_layout(name, shape, architecture, has_lift)
    spec = param_partition_spec((), flax_shape, model_size)
    if MODEL_AXIS not in spec:
        return (Replicate(), Replicate())
    return (Replicate(), Shard(sources[spec.index(MODEL_AXIS)]))


def state_shardings(state, mesh: DeviceMesh) -> dict:
    """Placements of a ``TrainState``: ``{"params", "mu", "nu", "ema"}``,
    each a ``{name: placements}`` dict in the state's parameter order
    (``ema`` None without EMA). With model-axis size 1 everything replicates
    (pure data parallelism); otherwise the rule above splits the large
    kernels, and the moments and the EMA copy follow them leaf by leaf."""
    model_size = axis_size(mesh, MODEL_AXIS)
    architecture = state.model.architecture
    has_lift = any(n.startswith("encoder.lift.") for n in state.names)
    params = {name: port_placement(name, tuple(p.shape), architecture,
                                   has_lift, model_size)
              for name, p in zip(state.names, state.params)}
    return {"params": params, "mu": dict(params), "nu": dict(params),
            "ema": dict(params) if state.ema_decay else None}


def shard_state(state, mesh: DeviceMesh):
    """Place a ``TrainState`` on the mesh per :func:`state_shardings`."""
    from meanflow_audio_codec_torch.parallel.sharded_state import (
        ShardedTrainState,
    )

    return ShardedTrainState(state, mesh)
