"""PyTorch port: the sharded trainer and ``MeshDeviceReplayPool`` against the
JAX package's, on the CPU.

``train_flow`` runs in one group of 2 gloo ranks (``tests/torch_ranks.py``),
which the first run forms from torchrun's environment variables, for three
configs: data parallel over both ranks with the mesh pool, tensor
parallel (``mesh_model`` 2), and a batch the data axis does not divide,
which runs unsharded. Rank 0 writes the workdir; JAX reads its checkpoint.
The mesh pool is held against JAX's ``MeshDeviceReplayPool`` on
``create_mesh(data=2, model=4)`` (tests/conftest.py gives JAX 8 CPU
devices) element for element: each data rank's pool is built in this
process under torch's fake backend, as rank 0 and rank 4 of 8.
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import torch_ranks
from meanflow_audio_codec_tpu.configs import TrainFlowConfig
from meanflow_audio_codec_tpu.data.device_pool import (
    MeshDeviceReplayPool as JaxMeshPool,
)
from meanflow_audio_codec_tpu.parallel import create_mesh as jcreate_mesh
from meanflow_audio_codec_tpu.training.trainer import (
    load_flow_state as jax_load_flow_state,
)
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.data.device_pool import MeshDeviceReplayPool
from meanflow_audio_codec_torch.parallel import create_mesh
from meanflow_audio_codec_torch.training.trainer import load_flow_state

TINY = {
    "config_version": "2.0",
    "base": {"batch_size": 4, "n_steps": 4, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 3, "grad_clip_norm": 1.0,
             "warmup_steps": 1, "lr_schedule": "cosine",
             "lr_final_fraction": 0.05},
    "model": {"noise_dimension": 128, "condition_dimension": 16,
              "latent_dimension": 8, "num_blocks": 1,
              "architecture": "convnet",
              "architecture_options": {"channels": 16, "bottleneck_dim": 32,
                                       "spatial": 4, "lift_channels": 8}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {
                    "frame_size": 2048, "window_size": 64,
                    "coeff_scale": 4.0, "gain_norm": 0.05,
                    "device_pool_clips": 8, "synthetic_family": "mixed"}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True,
               "time_sampling_full_proportion": 0.25},
    "training": {"sample_every": 2, "sample_seed": 1, "sample_steps": 1,
                 "workdir": "unset", "checkpoint_step": 2,
                 "max_checkpoints_to_keep": 2, "ema_decay": 0.99},
    "tpu": {"precision": "float32", "steps_per_call": 2,
            "skip_nonfinite_updates": True},
}


def _config(workdir, **sections):
    data = json.loads(json.dumps(TINY))
    data["training"]["workdir"] = str(workdir)
    for section, values in sections.items():
        data[section].update(values)
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (config, the rank 0 and rank 1 outputs)."""
    root = tmp_path_factory.mktemp("sharded")
    configs = {
        "dp": _config(root / "dp"),
        # the host stream through the stacked [K, B/n, ...] path
        "tp": _config(root / "tp", tpu={"mesh_model": 2},
                      dataset={"tokenization_config": dict(
                          TINY["dataset"]["tokenization_config"],
                          device_pool_clips=0)},
                      model={"architecture_options": dict(
                          TINY["model"]["architecture_options"],
                          channels=128)}),
        "odd": _config(root / "odd", base=dict(TINY["base"], batch_size=3)),
    }
    (root / "runs.json").write_text(json.dumps(list(configs.values())))
    torch_ranks.launch(torch_ranks.train_runs, 2, str(root / "runs.json"),
                       torchrun=True)
    return {name: (config, [torch.load(root / f"{name}.rank{r}.pt")
                            for r in range(2)])
            for name, config in configs.items()}


def test_trainer_on_two_ranks_prints_jax_lines_and_trains(runs):
    config, (rank0, rank1) = runs["dp"]
    assert "Sharding over mesh {'data': 2, 'model': 1}: batch 4 -> 2 per " \
        "device" in rank0["out"]
    assert ("Mesh device replay pool: 8 clips (4/device over 2 data shards),"
            " async int16 refresh") in rank0["out"]
    assert "Sharding over mesh" not in rank1["out"]  # rank 0 speaks
    assert np.isfinite(rank0["final"])
    assert rank0["final"] == rank1["final"]  # the loss averaged over ranks
    config, (rank0, _) = runs["tp"]
    assert "Sharding over mesh {'data': 1, 'model': 2}: batch 4 -> 4 per " \
        "device" in rank0["out"]
    assert "replay pool" not in rank0["out"]
    assert np.isfinite(rank0["final"])


def test_only_rank_zero_writes_and_jax_reads_its_checkpoint(runs):
    config, _ = runs["dp"]
    workdir = config["training"]["workdir"]
    ckpt = f"{workdir}/checkpoints/step_00004.msgpack"
    jstate, _ = jax_load_flow_state(ckpt, TrainFlowConfig.from_dict(
        json.loads(open(f"{workdir}/config.json").read())))
    assert int(jstate.step) == 4
    state, _ = load_flow_state(ckpt, config_from_dict(config), device="cpu")
    want = weights.flax_to_torch(jax.device_get(jstate.params))
    got = dict(state.model.named_parameters())
    for key, value in want.items():
        assert torch.equal(got[key].detach(), value), key
    ema = weights.flax_to_torch(jax.device_get(jstate.ema_params))
    for key, value in zip(state.names, state.ema):
        assert torch.equal(value, ema[key]), key
    for name in ("dp", "tp"):  # one writer: each step logged once
        config, _ = runs[name]
        workdir = config["training"]["workdir"]
        records = [json.loads(line) for line in
                   open(f"{workdir}/logs/train_log.jsonl")]
        assert [r["step"] for r in records if "loss" in r] == [0, 1, 2, 3]
        # the tensor-parallel run's checkpoint holds the full tensors
        state, _ = load_flow_state(
            f"{workdir}/checkpoints/step_00004.msgpack",
            config_from_dict(config), device="cpu")
        assert state.step == 4
        assert all(torch.isfinite(t).all() for t in state.mu + state.ema)


def test_indivisible_batch_runs_single_device(runs):
    _, (rank0, rank1) = runs["odd"]
    assert ("batch_size 3 not divisible by mesh data axis 2; running "
            "single-device") in rank0["out"]
    assert "Device replay pool: 8 clips" not in rank0["out"]  # 9: 3 x 3
    assert "Device replay pool: 9 clips" in rank0["out"]
    assert np.isfinite(rank0["final"]) and np.isfinite(rank1["final"])


# ---------------------------------------------------------------------------
# the mesh pool against JAX's
# ---------------------------------------------------------------------------


def _source(batch=4, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield (0.4 * rng.standard_normal((batch, 32, 2))).astype(np.float32)


@pytest.fixture
def world_of_8():
    def rank_pool(rank, **kwargs):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        mesh = create_mesh(data=2, model=4, device_type="cpu")
        return MeshDeviceReplayPool(_source(**kwargs.pop("source", {})),
                                    mesh, device="cpu", **kwargs)
    yield rank_pool
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_pool_samples_equal_jax(world_of_8):
    jpool = JaxMeshPool(_source(), jcreate_mesh(data=2, model=4),
                        pool_clips=12, seed=5)
    pools = [world_of_8(rank, pool_clips=12, seed=5) for rank in (0, 4)]
    try:
        assert [p.data_rank for p in pools] == [0, 1]
        assert pools[0].pool_size == jpool.pool_size == 12
        assert pools[0].local_size == jpool.local_size == 6
        for _ in range(3):
            want = np.asarray(jpool.sample(3, 4))
            got = np.concatenate([p.sample(3, 4).numpy() for p in pools],
                                 axis=1)
            assert got.shape == want.shape == (3, 4, 32, 2)
            np.testing.assert_array_equal(got, want)
            assert jpool.refresh(wait=True)
            assert all(p.refresh(wait=True) for p in pools)
        np.testing.assert_array_equal(
            np.concatenate([p.pool.numpy() for p in pools]),
            np.asarray(jpool.pool))
    finally:
        jpool.close()
        for p in pools:
            p.close()


def test_mesh_pool_refresh_skips_without_blocking(world_of_8):
    pool = world_of_8(0, pool_clips=8, seed=0, prefetch=1)
    try:
        while pool.refresh():
            pass
        assert pool.skipped_refreshes >= 1
    finally:
        pool.close()


def test_mesh_pool_divisibility_errors_match_jax(world_of_8):
    jmesh = jcreate_mesh(data=2, model=4)
    with pytest.raises(ValueError) as theirs:
        JaxMeshPool(_source(batch=3), jmesh, pool_clips=6)
    with pytest.raises(ValueError) as ours:
        world_of_8(0, source={"batch": 3}, pool_clips=6)
    assert str(ours.value) == str(theirs.value)
    jpool = JaxMeshPool(_source(), jmesh, pool_clips=8)
    pool = world_of_8(0, pool_clips=8)
    try:
        with pytest.raises(ValueError) as theirs:
            jpool.sample(1, 3)
        with pytest.raises(ValueError) as ours:
            pool.sample(1, 3)
        assert str(ours.value) == str(theirs.value)
    finally:
        jpool.close()
        pool.close()
