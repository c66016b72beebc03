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
loss in the backward pass. What the port's trainer does not take yet raises,
naming the ROADMAP item: more than one device and orbax
checkpoints. Noise, t and r come from one
``torch.Generator`` on the state's device seeded with ``config.seed``; like
the JAX key, it is not saved, so a resumed run draws anew from the seed.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.data.audio import (
    build_audio_pipeline,
    prefetch_batches,
    replay_pool_batches,
    synthetic_pipeline_for_family,
    write_wav,
)
from meanflow_audio_codec_torch.data.device_pool import DeviceReplayPool
from meanflow_audio_codec_torch.data.mnist import load_mnist
from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops.losses import ema
from meanflow_audio_codec_torch.ops.sampling import sample, sample_dual_time
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
    run: an unknown tokenization or objective, and what the port's trainer
    does not take yet."""
    create_tokenization_strategy(config.tokenization_strategy,
                                 config.tokenization_config)
    tpu = config.source.get("tpu") or {}
    if tpu.get("mesh_data", -1) > 1 or tpu.get("mesh_model", 1) > 1:
        raise NotImplementedError(
            "more than one device is not ported yet (ROADMAP §1, "
            f"parallel/): tpu.mesh_data {tpu.get('mesh_data')}, "
            f"tpu.mesh_model {tpu.get('mesh_model')}")
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
        print(f"Overriding noise_dimension {config.noise_dimension} -> "
              f"{noise_dim} (tokenized width, mode={mode})")
        config = dataclasses.replace(config, noise_dimension=noise_dim)

    # ---- run metadata / config persistence ---------------------------------
    save_json(collect_experiment_metadata(config, device),
              workdir / "metadata.json")
    config_path = workdir / "config.json"
    if resume and config_path.exists():
        try:
            generate_config_diff(json.loads(config_path.read_text()),
                                 config.to_dict(),
                                 workdir / "config_diff.json")
        except (ValueError, TypeError, AttributeError, OSError) as exc:
            # a config.json that is not a v2 dict, e.g. truncated by a
            # crash: train on without a diff, as the JAX trainer does
            print(f"Could not diff previous config: {exc}")
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
            print(f"Resumed from step {start_step}")
        else:
            print("No valid checkpoint found; starting from scratch")

    # ---- data / objective / chunked step -----------------------------------
    data_iter = make_dataset_iterator(config)
    pool_clips = device_pool_clips(config)
    device_pool = None
    if pool_clips:
        device_pool = DeviceReplayPool(data_iter, pool_clips=pool_clips,
                                       seed=config.seed, device=device)
        print(f"Device replay pool: {device_pool.pool_size} clips resident "
              f"on {device}, async int16 refresh")
    objective = create_loss_strategy(config)
    steps_per_call = config.steps_per_call
    skip = config.skip_nonfinite_updates
    if steps_per_call > 1:
        step_fn = make_multi_step(objective, steps_per_call, adapter,
                                  remat=config.remat, skip_nonfinite=skip)
    else:
        step_fn = make_train_step(objective, adapter, remat=config.remat,
                                  skip_nonfinite=skip)

    log = LogWriter(logs_dir / "train_log.jsonl")
    first_batch = (device_pool.sample(1, config.batch_size)[0]
                   if device_pool else
                   torch.from_numpy(np.asarray(next(data_iter))).to(device))

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
    print(f"Device {checkpoints.device_name(device)}: "
          + (f"bf16 peak {profiler.peak / 1e12:.1f} TFLOP/s for mfu"
             if profiler.peak else "no known peak, mfu not written")
          + (f"; {flops / 1e9:.1f} GFLOP per step" if flops else ""))
    profiler.start_training(param_count=param_count)
    print(f"Training {config.architecture or 'mlp'} / "
          f"{config.method or 'flow_matching'} on {config.dataset}: "
          f"{param_count:,} params, noise_dim {noise_dim}, "
          f"{config.n_steps} steps")

    # fixed held-out batch for periodic sampling with real latents
    eval_batch = first_batch
    token_shape = (n_tokens, token_dim)
    generator = torch.Generator(device).manual_seed(config.seed)
    # samplers prefer the EMA weights when tracked: a model copy holds them
    sampler = (copy.deepcopy(state.model) if state.ema is not None
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
        model = sampler
        if state.ema is not None:
            torch._foreach_copy_(list(model.parameters()), state.ema)
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

    step = start_step
    first_chunk = True
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
                batch = torch.from_numpy(np.asarray(next(data_iter))).to(
                    device)
        else:
            if device_pool:
                stacked = device_pool.sample(k, config.batch_size)
                state, series = chunk_fn(k)(state, stacked, generator)
                device_pool.refresh()  # its copy overlaps the chunk
            else:
                raws = [batch.cpu().numpy()] if first_chunk else []
                while len(raws) < k:
                    raws.append(np.asarray(next(data_iter)))
                stacked = torch.from_numpy(np.stack(raws)).to(device)
                state, series = chunk_fn(k)(state, stacked, generator)
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
            checkpoints.save_checkpoint_with_metadata(
                state, checkpoints_dir, step=step, config=config,
                fmt=config.checkpoint_format)
            checkpoints.cleanup_old_checkpoints(
                checkpoints_dir, config.max_checkpoints_to_keep,
                final_step=config.n_steps)

    # ---- finalisation -------------------------------------------------------
    run_sampling(state, config.n_steps)
    checkpoints.save_checkpoint_with_metadata(
        state, checkpoints_dir, step=config.n_steps, config=config,
        fmt=config.checkpoint_format)
    checkpoints.cleanup_old_checkpoints(checkpoints_dir,
                                        config.max_checkpoints_to_keep,
                                        final_step=config.n_steps)
    checkpoints.save_serving_checkpoint(state, checkpoints_dir,
                                        step=config.n_steps)
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
    for evaluation: a full ``step_N.msgpack`` (with its EMA when it has one)
    or a ``serving_step_N.msgpack`` (its parameters in both the live and the
    EMA slot; optimiser state fresh)."""
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
    tree = checkpoints.read_checkpoint(checkpoint_path)
    # pick the template by inspecting the checkpoint: runs without EMA store
    # ema_params None
    has_ema = isinstance(tree, dict) and tree.get("ema_params") is not None
    state = TrainState(model, optimizer, ema_decay if has_ema else None,
                       device=device)
    return checkpoints.restore_train_state(tree, state), state.model
