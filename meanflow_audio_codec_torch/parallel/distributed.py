"""Process-group initialisation; counterpart of
``meanflow_audio_codec_tpu/parallel/distributed.py``.

JAX shards over many devices from one process; PyTorch runs one process per
rank, each with its own device, joined by a ``torch.distributed`` process
group. ``torchrun`` sets the variables read here (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), where JAX reads
``JAX_NUM_PROCESSES`` and its coordinator address:

    torchrun --nproc-per-node 4 -m meanflow_audio_codec_torch.train \\
        --config configs/frontier_v2.json --workdir outputs/run

One departure: when more than one process is asked for and the group does
not form, :func:`initialize_distributed` raises (JAX's prints the error and
returns False, leaving each process to train alone).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           device: str | torch.device | None = None) -> bool:
    """Form the default process group when running multi-process.

    No-op (returns False) for a single process, so trainers can call it
    unconditionally; True when a group exists (formed here or before).
    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``;
    ``init_method`` to ``tcp://MASTER_ADDR:MASTER_PORT`` (``env://`` when
    those are unset). ``backend`` defaults to ``nccl`` for a CUDA ``device``
    (``cuda`` when a card is present and ``device`` is unset) and ``gloo``
    for the CPU. With NCCL the process takes card ``LOCAL_RANK``.
    """
    if dist.is_initialized():
        return True
    env_world = os.environ.get("WORLD_SIZE")
    world_size = world_size or (int(env_world) if env_world else None)
    if init_method is None and world_size in (None, 0, 1):
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        init_method = f"tcp://{addr}:{port}" if addr and port else "env://"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    # a group that does not form raises here: more than one process was
    # asked for, and training on alone would silently change the run
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size or 1, rank=rank)
    return True


def global_batch_slice(global_batch: int) -> tuple[int, int]:
    """(per-process batch, offset) for host-sharded data loading."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // count
    return per, per * index
