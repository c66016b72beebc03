"""Device-resident replay pool; counterpart of ``DeviceReplayPool`` in
``meanflow_audio_codec_tpu/data/device_pool.py``.

A pool of clips lives on the device as float32. ``sample(k, batch)`` gathers
a ``[k, batch, ...]`` training chunk there; its indices come from a numpy
``default_rng(seed)``, as in the JAX pool, so the same seed and source give
the same chunks. ``refresh()`` overwrites the next slot group with a batch
that a background thread has synthesised and quantized to int16 (half the
bytes of float32, the precision of PCM audio): the int16 batch is copied
from pinned memory without blocking the host and dequantized on the device.
Over a long run the pool is a sliding window over the stream.

``MeshDeviceReplayPool`` is the pool of a run sharded over a mesh's data
axis: each data rank holds its own sub-pool on its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from meanflow_audio_codec_torch.parallel.mesh import axis_size

#: int16 wire format: symmetric full-scale at this amplitude. Audio is
#: nominally in [-1, 1]; synthetic mixtures can slightly exceed it, so
#: leave ~10% headroom before the clip.
WIRE_SCALE = 1.1


def _quantize(batch: np.ndarray) -> np.ndarray:
    return np.clip(batch * (32767.0 / WIRE_SCALE),
                   -32767.0, 32767.0).astype(np.int16)


def _dequantize(wire: torch.Tensor) -> torch.Tensor:
    """int16 -> float32 on the wire's device, as the JAX pool computes it
    (one float32 multiply by ``WIRE_SCALE / 32767``)."""
    return wire.to(torch.float32) * (WIRE_SCALE / 32767.0)


class DeviceReplayPool:
    """A clip pool on ``device`` fed by a host batch iterator.

    ``source`` yields [B, ...] float32 batches. The pool holds ``pool_clips``
    examples, rounded up to a whole number of source batches (at least two).
    """

    def __init__(self, source: Iterator[np.ndarray], pool_clips: int = 1024,
                 seed: int = 0, prefetch: int = 2,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self._source = source
        first = np.asarray(next(source))
        self._batch = first.shape[0]
        n_batches = max(2, -(-pool_clips // self._batch))
        host = [first] + [np.asarray(next(source))
                          for _ in range(n_batches - 1)]
        wire = torch.from_numpy(_quantize(np.concatenate(host, axis=0)))
        self.pool = _dequantize(wire.to(self.device))
        self.pool_size = int(self.pool.shape[0])
        self._rng = np.random.default_rng(seed)
        self._slot = 0
        self.skipped_refreshes = 0  # empty-queue refresh skips (run logs)
        self._start_producer(prefetch)

    def _start_producer(self, prefetch: int) -> None:
        # The producer synthesises and quantizes the next batches so that
        # refresh() never pays for the synthesis on the training thread. The
        # queue keeps the source's order, so consumption stays deterministic.
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._produce, daemon=True,
            name=f"{type(self).__name__}-producer")
        self._thread.start()

    def _host_tensor(self, array: np.ndarray) -> torch.Tensor:
        """``array`` as a CPU tensor, pinned when the pool is on the card (a
        pinned tensor copies to the card without blocking the host)."""
        tensor = torch.from_numpy(array)
        return tensor.pin_memory() if self.device.type == "cuda" else tensor

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                wire = self._host_tensor(
                    _quantize(np.asarray(next(self._source))))
                while not self._stop.is_set():
                    try:
                        self._queue.put(wire, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except StopIteration:
            self._queue.put(None)
        except BaseException as exc:  # surfaced on the training thread
            self._error = exc
            self._queue.put(None)

    def close(self) -> None:
        """Stop the producer thread (idempotent)."""
        self._stop.set()
        try:  # unblock a producer stuck on a full queue
            self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def sample(self, k: int, batch: int) -> torch.Tensor:
        """A [k, batch, ...] training chunk gathered on the device."""
        idx = self._rng.integers(0, self.pool_size, size=k * batch,
                                 dtype=np.int32)
        idx = self._host_tensor(idx).to(self.device, non_blocking=True)
        return self.pool.index_select(0, idx).reshape(
            (k, batch) + tuple(self.pool.shape[1:]))

    def refresh(self, wait: bool = False) -> bool:
        """Overwrite the next slot group with a batch the producer made.

        Non-blocking by default: an empty queue skips the refresh (the pool
        keeps replaying its clips) and counts it in ``skipped_refreshes``;
        ``wait=True`` blocks for the next batch. Returns True when a slot
        group was refreshed.
        """
        try:
            wire = self._queue.get() if wait else self._queue.get_nowait()
        except queue.Empty:
            self.skipped_refreshes += 1
            return False
        if wire is None:
            if self._error is not None:
                raise self._error
            return False  # source exhausted: the pool replays its clips
        fresh = _dequantize(wire.to(self.device, non_blocking=True))
        self.pool[self._slot:self._slot + fresh.shape[0]] = fresh
        # pool_size is a whole number of source batches, so slots tile it
        self._slot = (self._slot + fresh.shape[0]) % self.pool_size
        return True


class MeshDeviceReplayPool(DeviceReplayPool):
    """The replay pool of a run sharded over a mesh's data axis; counterpart
    of ``MeshDeviceReplayPool`` in ``meanflow_audio_codec_tpu/data/
    device_pool.py``.

    Layout: the pool of ``pool_size`` clips is split into ``data_size``
    contiguous sub-pools of ``local_size`` clips, as JAX places it
    ``P('data')``; each data rank holds its own on its ``device``, so the
    replay path moves no byte between ranks. Every rank reads the whole
    host stream (the same source and seed on every rank):

      * ``sample(k, batch)`` draws the whole ``(data_size, k * batch /
        data_size)`` array of local indices from one
        ``np.random.default_rng(seed)``, as JAX does, and gathers this
        rank's row from its sub-pool: a ``[k, batch / data_size, ...]``
        chunk, the rank's columns of JAX's ``P(None, 'data')`` chunk;
      * ``refresh()`` splits one host batch into ``data_size`` equal slices
        and writes this rank's slice into its sub-pool at the local slot
        (int16 wire, non-blocking, ``skipped_refreshes`` counted), as JAX
        scatters each slice into its device's sub-pool.

    Divisibility (enforced, with JAX's errors): the source batch and the
    training batch are multiples of the data-axis size.
    """

    def __init__(self, source: Iterator[np.ndarray], mesh,
                 pool_clips: int = 1024, seed: int = 0, prefetch: int = 2,
                 data_axis: str = "data",
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self._source = source
        nd = axis_size(mesh, data_axis)
        self.data_size = nd
        self.data_rank = mesh.get_local_rank(data_axis)
        first = np.asarray(next(source))
        if first.shape[0] % nd:
            raise ValueError(
                f"source batch {first.shape[0]} not divisible by data-axis "
                f"size {nd}")
        self._batch = first.shape[0]
        n_batches = max(2, -(-pool_clips // self._batch))
        host = [first] + [np.asarray(next(source))
                          for _ in range(n_batches - 1)]
        wire = _quantize(np.concatenate(host, axis=0))
        self.pool_size = int(wire.shape[0])
        self.local_size = self.pool_size // nd
        start = self.data_rank * self.local_size
        self.pool = _dequantize(torch.from_numpy(
            wire[start:start + self.local_size]).to(self.device))
        self._rng = np.random.default_rng(seed)
        self._local_slot = 0
        self.skipped_refreshes = 0  # empty-queue refresh skips (run logs)
        self._start_producer(prefetch)

    def sample(self, k: int, batch: int) -> torch.Tensor:
        """This rank's ``[k, batch / data_size, ...]`` chunk."""
        if batch % self.data_size:
            raise ValueError(
                f"batch {batch} not divisible by data-axis size "
                f"{self.data_size}")
        per_dev = batch // self.data_size
        idx = self._rng.integers(0, self.local_size,
                                 size=(self.data_size, k * per_dev),
                                 dtype=np.int32)
        mine = self._host_tensor(np.ascontiguousarray(idx[self.data_rank]))
        mine = mine.to(self.device, non_blocking=True)
        return self.pool.index_select(0, mine).reshape(
            (k, per_dev) + tuple(self.pool.shape[1:]))

    def refresh(self, wait: bool = False) -> bool:
        """Write this rank's slice of one pre-produced host batch into its
        sub-pool; the contract of :meth:`DeviceReplayPool.refresh`."""
        try:
            wire = self._queue.get() if wait else self._queue.get_nowait()
        except queue.Empty:
            self.skipped_refreshes += 1
            return False
        if wire is None:
            if self._error is not None:
                raise self._error
            return False
        per = wire.shape[0] // self.data_size
        mine = wire[self.data_rank * per:(self.data_rank + 1) * per]
        fresh = _dequantize(mine.to(self.device, non_blocking=True))
        self.pool[self._local_slot:self._local_slot + per] = fresh
        self._local_slot = (self._local_slot + per) % self.local_size
        return True
