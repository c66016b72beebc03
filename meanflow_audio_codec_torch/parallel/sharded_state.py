"""A train state placed on a (data, model) mesh: what ``shard_state``
returns.

JAX places the ``TrainState`` pytree with ``NamedSharding`` and lets XLA
partition the step. Here every rank keeps the full weights in the model it
runs (a working copy, refreshed after each update) and the train step calls
three hooks that the one-process ``TrainState`` has as no-ops:

  * :meth:`ShardedTrainState.reduce_gradients` averages the gradient over
    the data ranks (one ``all_reduce`` of the flat gradient) before the
    global-norm clip and AdamW, so both see the global gradient, as under
    JAX's ``jit``;
  * :meth:`ShardedTrainState.mean_over_data` averages the loss and the
    auxiliary metrics the same way, so every rank logs the global values;
  * :meth:`ShardedTrainState.agree` makes the non-finite guard decide the
    same way on every rank.

On a model axis of more than one rank, parameters, AdamW's moments and the
EMA copy are held as shards by :func:`~.mesh.state_shardings`: each rank
updates its shard of every split leaf (and all of each replicated one), and
the new weights are gathered over the model axis into the working copy.
:meth:`ShardedTrainState.dtensors` gives each leaf as a ``DTensor`` of its
placements. Everything the one-process state offers that reads the moments
or the EMA (``mu``, ``nu``, ``ema``, :meth:`full`) gathers them first: a
collective, which every rank must call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from meanflow_audio_codec_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
    state_shardings,
)
from meanflow_audio_codec_torch.training.optim import TrainState, Update


class ShardedTrainState:
    """``state`` on ``mesh``; the train step and the trainer use it where
    they use a ``TrainState``."""

    def __init__(self, state: TrainState, mesh: DeviceMesh):
        self.base = state
        self.mesh = mesh
        self.data_size = axis_size(mesh, DATA_AXIS)
        self.model_size = axis_size(mesh, MODEL_AXIS)
        self.data_rank = mesh.get_local_rank(DATA_AXIS)
        self.model_rank = mesh.get_local_rank(MODEL_AXIS)
        self._data_group = mesh.get_group(DATA_AXIS)
        self._model_group = mesh.get_group(MODEL_AXIS)
        self.placements = list(state_shardings(state, mesh)["params"]
                               .values())
        if self.model_size > 1:
            self._split(state)

    # ---- the one-process state's attributes --------------------------------
    model = property(lambda self: self.base.model)
    params = property(lambda self: self.base.params)
    names = property(lambda self: self.base.names)
    device = property(lambda self: self.base.device)
    count = property(lambda self: self.base.count)
    optimizer = property(lambda self: self.base.optimizer)
    ema_decay = property(lambda self: self.base.ema_decay)

    @property
    def step(self) -> int:
        return self.base.step

    @property
    def mu(self) -> list[torch.Tensor]:
        return self.full().mu

    @property
    def nu(self) -> list[torch.Tensor]:
        return self.full().nu

    @property
    def ema(self) -> list[torch.Tensor] | None:
        return self.full().ema

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        return self.full().ema_state_dict()

    # ---- the model axis: shards and their index maps -----------------------
    def _local_index(self, rank: int) -> torch.Tensor:
        """Positions, in the full flat tensor, of model rank ``rank``'s
        shard of every leaf (all of a replicated leaf), in leaf order."""
        pieces, offset = [], 0
        for p, placement in zip(self.base.params, self.placements):
            full = torch.arange(offset, offset + p.numel()).view(p.shape)
            offset += p.numel()
            split = placement[1]
            if isinstance(split, Shard):
                full = full.chunk(self.model_size, dim=split.dim)[rank]
            pieces.append(full.reshape(-1))
        return torch.cat(pieces)

    def _split(self, state: TrainState) -> None:
        device = state.device
        self._index = self._local_index(self.model_rank).to(device)
        # where each rank's shard lands in the full tensor, for the gather
        self._scatter = torch.cat([self._local_index(r) for r in
                                   range(self.model_size)]).to(device)
        self._local_shapes = []
        for p, placement in zip(state.params, self.placements):
            shape = list(p.shape)
            if isinstance(placement[1], Shard):
                shape[placement[1].dim] //= self.model_size
            self._local_shapes.append(torch.Size(shape))
        self._local_numels = [s.numel() for s in self._local_shapes]
        self._p = state._params[self._index]
        self._mu = state._mu[self._index]
        self._nu = state._nu[self._index]
        self._ema = (None if state._ema is None
                     else state._ema[self._index])
        # the full moments and EMA live in the shards from here on
        state._mu = state._nu = None
        state._ema = None if state._ema is None else torch.empty(0)

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full flat tensor from every model rank's ``local`` shard."""
        parts = local.new_empty(self.model_size * local.numel())
        gather = getattr(dist, "all_gather_single", None) or (
            dist.all_gather_into_tensor)
        gather(parts, local, group=self._model_group)
        full = local.new_empty(self.base._params.numel())
        return full.index_copy_(0, self._scatter, parts)

    def full(self) -> TrainState:
        """The one-process state with full moments and EMA (gathered over
        the model axis: every rank calls it)."""
        if self.model_size > 1:
            base = self.base
            base._mu, base._nu = self._gather(self._mu), self._gather(self._nu)
            if self._ema is not None:
                base._ema = self._gather(self._ema)
        return self.base

    def dtensors(self, which: str = "params") -> list[DTensor] | None:
        """Each leaf of ``params``, ``mu``, ``nu`` or ``ema`` as a DTensor
        of its placements over this rank's shard."""
        if self.model_size == 1:
            flat = getattr(self.base, "_" + which)
            if flat is None:
                return None
            local = self.base._views(flat)
        else:
            flat = getattr(self, "_" + ("p" if which == "params" else which))
            if flat is None:
                return None
            local = [v.view(s) for v, s in zip(flat.split(self._local_numels),
                                               self._local_shapes)]
        return [DTensor.from_local(t, self.mesh, placement, run_check=False,
                                   shape=p.shape, stride=p.stride())
                for t, placement, p in zip(local, self.placements,
                                           self.base.params)]

    # ---- the train step's hooks --------------------------------------------
    def reduce_gradients(self, grads) -> list[torch.Tensor]:
        """The gradients averaged over the data ranks."""
        if self.data_size == 1:
            return list(grads)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self._data_group)
        flat.div_(self.data_size)
        return self.base._views(flat)

    def mean_over_data(self, metrics: dict) -> dict:
        """The 0-d tensor metrics averaged over the data ranks."""
        names = [k for k, v in metrics.items()
                 if isinstance(v, torch.Tensor) and v.ndim == 0]
        if self.data_size == 1 or not names:
            return metrics
        stacked = torch.stack([metrics[k].float() for k in names])
        dist.all_reduce(stacked, group=self._data_group)
        stacked.div_(self.data_size)
        return {**metrics, **{k: stacked[i].to(metrics[k].dtype)
                              for i, k in enumerate(names)}}

    def agree(self, ok: torch.Tensor) -> torch.Tensor:
        """``ok`` where every rank's ``ok`` holds (the guard reads each
        rank's shard of the update)."""
        if dist.get_world_size() == 1:
            return ok
        failed = (~ok).to(torch.int32).reshape(1)  # a sum: gloo reduces
        dist.all_reduce(failed)                    # CUDA tensors so
        return failed[0] == 0

    def apply_gradients(self, grads: list[torch.Tensor],
                        grad_norm: torch.Tensor) -> Update:
        """This rank's update: all of it on a model axis of one rank, its
        shard of it otherwise."""
        if self.model_size == 1:
            return self.base.apply_gradients(grads, grad_norm)
        with torch.no_grad():
            g = torch.cat([t.reshape(-1) for t in grads])[self._index]
            params, mu, nu = self.optimizer.update(
                self._p, g, self._mu, self._nu, self.count, grad_norm)
            ema = None
            if self._ema is not None:
                d = self.ema_decay
                ema = self._ema * d + params * (1.0 - d)
        return Update(params, mu, nu, ema)

    def commit(self, update: Update) -> None:
        if self.model_size == 1:
            return self.base.commit(update)
        self.commit_where(update, None)

    def commit_where(self, update: Update, ok: torch.Tensor | None) -> None:
        if self.model_size == 1:
            return self.base.commit_where(update, ok)
        with torch.no_grad():
            keep = (lambda new, old: new) if ok is None else (
                lambda new, old: torch.where(ok, new, old))
            self._p = keep(update.params, self._p)
            self._mu = keep(update.mu, self._mu)
            self._nu = keep(update.nu, self._nu)
            if self._ema is not None:
                self._ema = keep(update.ema, self._ema)
            self.count.add_(1 if ok is None else ok.to(torch.int64))
            self.base._params.copy_(self._gather(self._p))
