"""The training loop; counterpart of ``train_flow`` and ``load_flow_state`` in
``meanflow_audio_codec_tpu/training/trainer.py``.

Tokenizer wiring -> workdir layout -> model, optimiser and state -> resume
-> data (the audio files under an existing ``data_dir`` through
``build_audio_pipeline``, else synthetic audio; through the device replay
pool, which is on by default for synthetic audio only) -> chunks of
``steps_per_call`` train steps (tokenization in the step, the non-finite
guard on the device) -> JSONL logging and profiling (with MFU) -> periodic
sampling with real encoder latents and the EMA weights -> checkpoints with
retention -> the serving checkpoint and the summary. The workdir layout,
the log records and the checkpoints are the JAX package's, so either
package resumes the other's run. The data is audio (frames layout with the
MDCT, features layout with the reshape tokenizer) or MNIST (features
layout; ``data/mnist.py``), whose samples are written as a PNG grid.

Every objective of the JAX package trains (autoencoder, flow matching,
mean flow, improved mean flow; the learned loss weighting, whose polynomial
the factory adds to the model's parameters; latent QAT), and ``tpu.remat`` recomputes the
loss in the backward pass. Checkpoints are written in the configured
``checkpoint_format`` (msgpack files or orbax directories), and a resume
takes the newest valid checkpoint of either format. Noise, t and r come from one
``torch.Generator`` on the state's device seeded with ``config.seed``; like
the JAX key, it is not saved, so a resumed run draws anew from the seed.

Sharded training: where JAX shards over the devices of one process, the
port runs one process per rank in a ``torch.distributed`` group
(``torchrun --nproc-per-node N -m meanflow_audio_codec_torch.train ...``,
or a group the caller formed). Whenever a group exists the run is sharded
over a ``(data, model)`` mesh of ``tpu.mesh_data`` x ``tpu.mesh_model``
ranks (``mesh_data`` -1: the world size over ``mesh_model``): each data
rank trains on its slice of the global batch (from the
``MeshDeviceReplayPool`` when the device pool is on, else from its slice of
the host stream, stacked ``[K, B/n, ...]`` per chunk), draws its rows of the
global batch's noise, t and r, and the gradient is averaged over the data
ranks before the clip and AdamW (``parallel.ShardedTrainState``). A batch
that the data axis does not divide runs unsharded on every rank, as JAX's
does. Only rank 0 writes the workdir's files (metadata, config, logs,
samples, checkpoints from full tensors, summary); the other ranks return a
summary of their final loss.

A chunk of the hot loop is the spans ``pool.sample``, ``train.chunk``,
``pool.refresh`` and ``readback`` (``tracing``), recorded while
``ProfilingTrainer`` times it: the logged ``step_time`` is the chunk's
device time over its steps, and the summary's ``phase_ms`` each step
phase's device ms a step.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from meanflow_audio_codec_torch import tracing
from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.data.audio import (
    build_audio_pipeline,
    prefetch_batches,
    replay_pool_batches,
    synthetic_pipeline_for_family,
    write_wav,
)
from meanflow_audio_codec_torch.data.device_pool import (
    DeviceReplayPool,
    MeshDeviceReplayPool,
)
from meanflow_audio_codec_torch.data.mnist import load_mnist
from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops.losses import ema
from meanflow_audio_codec_torch.ops.sampling import sample, sample_dual_time
from meanflow_audio_codec_torch.parallel import (
    initialize_distributed,
    mesh_from_config,
    shard_state,
)
from meanflow_audio_codec_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    local_batch,
)
from meanflow_audio_codec_torch.ops.tokenize import (
    compute_token_shape,
    create_tokenization_strategy,
)
from meanflow_audio_codec_torch.training import checkpoints
from meanflow_audio_codec_torch.training.adapter import (
    adapter_from_config,
    resolve_flatten_mode,
)
from meanflow_audio_codec_torch.training.logging import (
    LogWriter,
    collect_experiment_metadata,
    generate_config_diff,
    generate_training_summary,
    plot_loss_curve,
    plot_samples,
    save_json,
)
from meanflow_audio_codec_torch.training.objectives import create_loss_strategy
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    lr_at_step,
    make_optimizer,
)
from meanflow_audio_codec_torch.training.profiling import (
    ProfilingTrainer,
    estimate_step_flops,
)
from meanflow_audio_codec_torch.training.train_step import (
    make_multi_step,
    make_train_step,
)

SAMPLE_RATE = 44100


# ============================================================================
# Wiring helpers
# ============================================================================


def input_example_shape(config: CodecConfig) -> tuple[int, ...]:
    """Per-example raw data shape fed to the tokenizer."""
    if config.dataset == "audio":
        tok_cfg = config.tokenization_config
        return (tok_cfg.get("frame_size", 65536), tok_cfg.get("channels", 2))
    return (784,)  # flat MNIST


def effective_noise_dimension(config: CodecConfig) -> int:
    """Model input width after tokenization and flattening."""
    strategy = create_tokenization_strategy(config.tokenization_strategy,
                                            config.tokenization_config)
    n_tokens, token_dim = compute_token_shape(strategy,
                                              input_example_shape(config))
    if resolve_flatten_mode(config) == "frames":
        return token_dim
    return n_tokens * token_dim


def _check_ported(config: CodecConfig) -> None:
    """Raise, before anything is written, on a config the trainer cannot
    run: an unknown tokenization, objective or checkpoint format, and the
    serving-only int8 switch."""
    create_tokenization_strategy(config.tokenization_strategy,
                                 config.tokenization_config)
    create_loss_strategy(config)
    if config.architecture_options.get("quantized"):
        raise ValueError(
            "architecture_options.quantized is a serving-only knob: the int8 "
            "rounding has zero gradient a.e. and would silence the mean-flow "
            "JVP. Train in bf16 and pass quantized=True at load/eval time.")
    checkpoints.check_format(config.checkpoint_format)


def _on_disk(config: CodecConfig) -> bool:
    return bool(config.data_dir) and Path(config.data_dir).exists()


def make_dataset_iterator(config: CodecConfig) -> Iterator[np.ndarray]:
    """Infinite iterator of raw (untokenized) float32 batches. Audio,
    ``[B, frame_size, 2]``: the audio files under an existing ``data_dir``
    (``build_audio_pipeline``), else the synthetic source of the config's
    ``synthetic_family``, through a host replay pool when ``pool_batches``
    is set, else through a prefetch thread. Any other dataset is MNIST,
    ``[B, 784]`` in [-1, 1], as in the JAX package."""
    if config.dataset != "audio":
        return load_mnist(config.batch_size, seed=config.seed)[0]
    tok_cfg = config.tokenization_config
    frame_size = tok_cfg.get("frame_size", 65536)
    if _on_disk(config):
        return build_audio_pipeline(
            config.data_dir, seed=config.seed, frame_size=frame_size,
            batch_size=config.batch_size, resample=config.resample_audio)
    print("No audio data_dir found; using synthetic audio source")
    source = synthetic_pipeline_for_family(
        tok_cfg.get("synthetic_family"), seed=config.seed,
        frame_size=frame_size, batch_size=config.batch_size)
    pool = tok_cfg.get("pool_batches", 0)
    if pool:
        return replay_pool_batches(source, pool_batches=pool,
                                   seed=config.seed)
    return prefetch_batches(source)


def device_pool_clips(config: CodecConfig) -> int:
    """The device replay pool's size in clips: 0 (none) for MNIST; for audio
    the config's ``device_pool_clips``, by default 1024 for synthetic audio
    and 0 (the exact stream) for a corpus, where the pool would turn the
    stream into with-replacement draws of int16 clips unasked."""
    if config.dataset != "audio":
        return 0
    return config.tokenization_config.get(
        "device_pool_clips", 0 if _on_disk(config) else 1024)


# ============================================================================
# Main entry
# ============================================================================


def train_flow(config: CodecConfig, resume: bool = False,
               device: str | torch.device = "cuda") -> dict:
    """Train the flow model the config names; returns the run summary.

    Runs on the card by default and raises without one; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels.
    """
    device = resolve_device(device)
    _check_ported(config)
    grouped = initialize_distributed(device=device)
    if grouped and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    writer = not grouped or dist.get_rank() == 0  # writes the workdir
    say = print if writer else (lambda *args, **kwargs: None)
    # a mesh the group cannot hold is refused before anything is written
    mesh = (mesh_from_config(config, device_type=device.type) if grouped
            else None)
    workdir = Path(config.workdir)
    samples_dir = workdir / "samples"
    checkpoints_dir = workdir / "checkpoints"
    logs_dir = workdir / "logs"
    for d in (samples_dir, checkpoints_dir, logs_dir):
        d.mkdir(parents=True, exist_ok=True)

    # ---- tokenizer + effective model width ---------------------------------
    strategy = create_tokenization_strategy(config.tokenization_strategy,
                                            config.tokenization_config)
    mode = resolve_flatten_mode(config)
    adapter = adapter_from_config(config, strategy)
    n_tokens, token_dim = compute_token_shape(strategy,
                                              input_example_shape(config))
    noise_dim = token_dim if mode == "frames" else n_tokens * token_dim
    if noise_dim != config.noise_dimension:
        say(f"Overriding noise_dimension {config.noise_dimension} -> "
              f"{noise_dim} (tokenized width, mode={mode})")
        config = dataclasses.replace(config, noise_dimension=noise_dim)

    # ---- run metadata / config persistence ---------------------------------
    config_path = workdir / "config.json"
    if writer:
        save_json(collect_experiment_metadata(config, device),
                  workdir / "metadata.json")
    if writer and resume and config_path.exists():
        try:
            generate_config_diff(json.loads(config_path.read_text()),
                                 config.to_dict(),
                                 workdir / "config_diff.json")
        except (ValueError, TypeError, AttributeError, OSError) as exc:
            # a config.json that is not a v2 dict, e.g. truncated by a
            # crash: train on without a diff, as the JAX trainer does
            print(f"Could not diff previous config: {exc}")
    if writer:
        save_json(config.to_dict(), config_path)

    # ---- model / optimizer / state -----------------------------------------
    model = create_flow_model(
        config, generator=torch.Generator().manual_seed(config.seed))
    state = TrainState(model, make_optimizer(config),
                       config.ema_decay or None, device=device)
    param_count = checkpoints.count_params(state)

    start_step = 0
    if resume:
        restored = checkpoints.load_checkpoint_and_resume(checkpoints_dir,
                                                          state)
        if restored is not None:
            state, start_step = restored
            say(f"Resumed from step {start_step}")
        else:
            say("No valid checkpoint found; starting from scratch")

    # ---- sharding (data parallel over 'data', tensor parallel over 'model')
    if mesh is not None:
        data_size = axis_size(mesh, DATA_AXIS)
        if config.batch_size % data_size == 0:
            state = shard_state(state, mesh)
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
            say(f"Sharding over mesh {shape}: batch {config.batch_size} -> "
                f"{config.batch_size // data_size} per device")
        else:
            say(f"batch_size {config.batch_size} not divisible by mesh "
                f"data axis {data_size}; running single-device")
            mesh = None

    def to_device(array: np.ndarray, dim: int = 0) -> torch.Tensor:
        """A host batch on the device: this data rank's slice of it along
        ``dim`` when sharded."""
        tensor = torch.from_numpy(np.asarray(array))
        if mesh is not None:
            tensor = local_batch(tensor, mesh, dim)
        return tensor.to(device)

    # ---- data / objective / chunked step -----------------------------------
    data_iter = make_dataset_iterator(config)
    pool_clips = device_pool_clips(config)
    device_pool = None
    if pool_clips and mesh is None:
        device_pool = DeviceReplayPool(data_iter, pool_clips=pool_clips,
                                       seed=config.seed, device=device)
        say(f"Device replay pool: {device_pool.pool_size} clips resident "
            f"on {device}, async int16 refresh")
    elif pool_clips:
        device_pool = MeshDeviceReplayPool(data_iter, mesh,
                                           pool_clips=pool_clips,
                                           seed=config.seed, device=device)
        say(f"Mesh device replay pool: {device_pool.pool_size} clips "
            f"({device_pool.local_size}/device over "
            f"{device_pool.data_size} data shards), async int16 refresh")
    objective = create_loss_strategy(config)
    steps_per_call = config.steps_per_call
    skip = config.skip_nonfinite_updates
    if steps_per_call > 1:
        step_fn = make_multi_step(objective, steps_per_call, adapter,
                                  remat=config.remat, skip_nonfinite=skip)
    else:
        step_fn = make_train_step(objective, adapter, remat=config.remat,
                                  skip_nonfinite=skip)

    log = LogWriter(logs_dir / "train_log.jsonl") if writer else None
    first_raw = None if device_pool else np.asarray(next(data_iter))
    first_batch = (device_pool.sample(1, config.batch_size)[0]
                   if device_pool else to_device(first_raw))

    def probe(batch):
        """One step's loss and gradients, nothing written (FLOP count)."""
        with torch.no_grad():
            x = adapter.tokenize(batch)
        loss, _ = objective.loss(
            state.model, x, generator=torch.Generator(device).manual_seed(0))
        torch.autograd.grad(loss, state.params)

    flops = estimate_step_flops(probe, first_batch)
    profiler = ProfilingTrainer(
        log_writer=log,
        flops_per_step=flops * steps_per_call if flops else None,
        device=device)
    say(f"Device {checkpoints.device_name(device)}: "
          + (f"bf16 peak {profiler.peak / 1e12:.1f} TFLOP/s for mfu"
             if profiler.peak else "no known peak, mfu not written")
          + (f"; {flops / 1e9:.1f} GFLOP per step" if flops else ""))
    profiler.start_training(param_count=param_count)
    say(f"Training {config.architecture or 'mlp'} / "
          f"{config.method or 'flow_matching'} on {config.dataset}: "
          f"{param_count:,} params, noise_dim {noise_dim}, "
          f"{config.n_steps} steps")

    # fixed held-out batch for periodic sampling with real latents
    eval_batch = first_batch
    token_shape = (n_tokens, token_dim)
    generator = torch.Generator(device).manual_seed(config.seed)
    # samplers prefer the EMA weights when tracked: a model copy holds them
    sampler = (copy.deepcopy(state.model) if state.ema_decay
               else state.model)

    loss_ema = None
    skipped_updates = 0  # count of guard-rejected (non-finite) updates
    batch = first_batch
    is_mean_flow = (config.method in ("mean_flow", "improved_mean_flow")
                    or config.use_improved_mean_flow)

    @torch.no_grad()
    def run_sampling(state, step: int) -> None:
        if (config.method or "") == "autoencoder":
            return
        ema = state.ema  # gathered over the model axis: every rank reads it
        if not writer:
            return
        model = sampler
        if ema is not None:
            torch._foreach_copy_(list(model.parameters()), ema)
        x_tokens, gains = adapter.tokenize_with_gain(eval_batch)
        latents = model.encode(x_tokens)
        flat = (sample_dual_time if is_mean_flow else sample)(
            model, noise_dim, latents, n_steps=config.sample_steps,
            guidance_scale=config.sample_guidance_scale or 1.0,
            generator=torch.Generator(device).manual_seed(config.sample_seed))
        decoded = adapter.detokenize_flat(
            flat, token_shape, gains=gains if adapter.gain_norm else None)
        decoded = decoded[:16].float().cpu().numpy()
        if config.dataset == "audio":
            write_wav(samples_dir / f"step_{step:05d}.wav", decoded[0],
                      sample_rate=SAMPLE_RATE)
        else:
            plot_samples(decoded[:16], samples_dir / f"step_{step:05d}.png")

    # ---- hot loop -----------------------------------------------------------
    chunk_fns = {steps_per_call: step_fn}

    def chunk_fn(k: int):
        if k not in chunk_fns:
            # always the chunk form: the chunked path feeds [k, B, ...] even
            # for a final partial chunk of k == 1
            chunk_fns[k] = make_multi_step(objective, k, adapter,
                                           remat=config.remat,
                                           skip_nonfinite=skip)
        return chunk_fns[k]

    def save_checkpoint(step: int, serving: bool = False) -> None:
        full = state.full()  # full tensors (a gather on every rank)
        if not writer:
            return
        checkpoints.save_checkpoint_with_metadata(
            full, checkpoints_dir, step=step, config=config,
            fmt=config.checkpoint_format)
        checkpoints.cleanup_old_checkpoints(
            checkpoints_dir, config.max_checkpoints_to_keep,
            final_step=config.n_steps)
        if serving:
            checkpoints.save_serving_checkpoint(full, checkpoints_dir,
                                                step=step)

    step = start_step
    first_chunk = True
    loss = float("nan")
    while step < config.n_steps:
        k = min(steps_per_call, config.n_steps - step)
        profiler.before_step()
        if steps_per_call == 1:
            state, metrics = step_fn(state, batch, generator=generator)
            series = {name: [value] for name, value in metrics.items()}
            if device_pool:
                device_pool.refresh()
                batch = device_pool.sample(1, config.batch_size)[0]
            else:
                batch = to_device(next(data_iter))
        else:
            if device_pool:
                stacked = device_pool.sample(k, config.batch_size)
                state, series = chunk_fn(k)(state, stacked, generator)
                device_pool.refresh()  # its copy overlaps the chunk
            else:
                raws = [first_raw] if first_chunk else []
                while len(raws) < k:
                    raws.append(np.asarray(next(data_iter)))
                stacked = to_device(np.stack(raws), dim=1)  # [K, B/n, ...]
                state, series = chunk_fn(k)(state, stacked, generator)
            with tracing.root("readback"):
                series = {name: value.cpu().numpy()
                          for name, value in series.items()}
        first_chunk = False
        # NB: the adaptive weighted-L2 loss is ~1 by construction (w ~
        # 1/||d||^2); 'mse' is the informative convergence signal.
        record = profiler.after_step(step)
        per_step_time = record["step_time"] / k
        for i in range(k):
            loss = float(series["loss"][i])
            mse = float(series["mse"][i]) if "mse" in series else None
            grad_norm = (float(series["grad_norm"][i])
                         if "grad_norm" in series else None)
            update_ok = (bool(series["update_ok"][i])
                         if "update_ok" in series else None)
            if update_ok is False:
                skipped_updates += 1
            if np.isfinite(loss):  # a skipped NaN step must not poison the EMA
                loss_ema = ema(loss_ema, loss)
            if not writer:
                continue
            log.write_step(step + i, loss=loss, loss_avg=loss_ema, mse=mse,
                           lr=lr_at_step(config, step + i),
                           grad_norm=grad_norm, update_ok=update_ok,
                           step_time=per_step_time,
                           **{name: value for name, value in record.items()
                              if name != "step_time"})
            if (step + i) % 50 == 0 or update_ok is False:
                mfu = record.get("mfu")
                mfu_str = f" mfu={mfu:.1%}" if mfu else ""
                if skipped_updates:
                    mfu_str += f" SKIPPED={skipped_updates}"
                mse_str = f" mse={mse:.5f}" if mse is not None else ""
                avg_str = (f"avg={loss_ema:.5f}" if loss_ema is not None
                           else "avg=n/a")
                print(f"step {step + i}: loss={loss:.5f} "
                      f"{avg_str}{mse_str} "
                      f"t={per_step_time * 1e3:.1f}ms{mfu_str}")
        prev_step, step = step, step + k

        def crossed(every: int | None) -> bool:
            return bool(every) and (step // every) > (prev_step // every)

        if crossed(config.sample_every):
            run_sampling(state, step)
        if crossed(config.checkpoint_step or config.sample_every):
            save_checkpoint(step)

    # ---- finalisation -------------------------------------------------------
    run_sampling(state, config.n_steps)
    save_checkpoint(config.n_steps, serving=True)
    if not writer:
        if device_pool is not None:
            device_pool.close()
        return {"rank": dist.get_rank(), "loss": {"final": loss}}
    perf = profiler.end_training(config.n_steps - start_step)
    summary = generate_training_summary(
        log.path, total_time=perf["total_time_sec"],
        total_steps=config.n_steps - start_step, param_count=param_count)
    summary.update({k: v for k, v in perf.items() if k not in summary})
    summary["flops_per_step"] = flops
    if device_pool is not None:
        # how often the producer fell behind the step loop and a slot
        # turnover was skipped
        summary["pool_skipped_refreshes"] = device_pool.skipped_refreshes
        device_pool.close()
    save_json(summary, workdir / "summary.json")
    plot_loss_curve(log.path, samples_dir / "loss_curve.png")
    log.close()
    steps_per_sec = summary.get("steps_per_sec")
    if steps_per_sec:
        print(f"Done: {steps_per_sec:.2f} steps/s over "
              f"{config.n_steps - start_step} steps")
    return summary


def load_flow_state(checkpoint_path: Path | str, config: CodecConfig,
                    device: str | torch.device = "cuda"
                    ) -> tuple[TrainState, torch.nn.Module]:
    """Rebuild the model and train state and load a checkpoint into them,
    for evaluation: a full ``step_N.msgpack`` or ``step_N.orbax`` directory
    (with its EMA when it has one) or a ``serving_step_N.msgpack`` (its
    parameters in both the live and the EMA slot; optimiser state
    fresh)."""
    noise_dim = effective_noise_dimension(config)
    if noise_dim != config.noise_dimension:
        config = dataclasses.replace(config, noise_dimension=noise_dim)
    model = create_flow_model(config)
    optimizer = make_optimizer(config)
    ema_decay = config.ema_decay or 0.999
    if checkpoints.is_serving_checkpoint(checkpoint_path):
        step, params = checkpoints.load_serving_checkpoint(
            checkpoint_path, model.architecture)
        model.load_state_dict(params, strict=True)
        state = TrainState(model, optimizer, ema_decay, device=device)
        state.step = step
        return state, state.model
    # pick the template by inspecting the checkpoint: runs without EMA store
    # ema_params None (an orbax directory says so in its metadata)
    if Path(checkpoint_path).is_dir():
        has_ema = checkpoints.orbax_checkpoint_has_ema(checkpoint_path)
        state = TrainState(model, optimizer, ema_decay if has_ema else None,
                           device=device)
        return (checkpoints.load_checkpoint_orbax(checkpoint_path, state),
                state.model)
    tree = checkpoints.read_checkpoint(checkpoint_path)
    has_ema = isinstance(tree, dict) and tree.get("ema_params") is not None
    state = TrainState(model, optimizer, ema_decay if has_ema else None,
                       device=device)
    return checkpoints.restore_train_state(tree, state), state.model
