"""ComprehensiveEvaluator: checkpoint -> NFE sweep -> quality and speed report.

Counterpart of ``meanflow_audio_codec_tpu/evaluators/comprehensive_evaluator.py``
with its result dict (keys, nesting, units): load a trained state, encode
the given real data (the MDCT kernel tokenizes on the card), optionally pass
the latents through a stored format (fixed-width codes or ECSQ, with the
rANS-coded kbps), sample at each NFE (the EMA weights when the run tracked
them, conditioned on the real latents), decode (the IMDCT kernel on the
card), and score the result on the host (MNIST: MSE/PSNR/SSIM/FID/KID;
audio: spectral distance, SI-SNR, STOI/eSTOI, NSIM, BSD, PESQ when it
imports).

Departures from the JAX evaluator, stated:
  * each NFE's start noise is drawn from a ``torch.Generator`` seeded with
    ``seed`` on the evaluator's device (JAX: ``normal(sub, (B, noise_dim))``
    with ``sub`` split from ``PRNGKey(seed)``); ``evaluate(noise=...)``
    takes the draws instead (NFE -> ``[B, noise_dim]``), so tests pass
    JAX's in;
  * ``first_call_sec`` times the first sampling call, which launches no
    kernel of the repository (the MDCT runs in the encode before it, the
    IMDCT in the decode after it), so it holds no kernel build; in JAX it
    includes the compile.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.evaluators import audio_metrics as am
from meanflow_audio_codec_torch.evaluators import metrics as im
from meanflow_audio_codec_torch.evaluators.performance import (
    count_parameters,
    force_completion,
    inference_time,
    memory_usage,
)
from meanflow_audio_codec_torch.ops import latent_quant as lq
from meanflow_audio_codec_torch.ops.sampling import sample, sample_dual_time
from meanflow_audio_codec_torch.ops.tokenize import (
    compute_token_shape,
    create_tokenization_strategy,
)
from meanflow_audio_codec_torch.training.adapter import adapter_from_config
from meanflow_audio_codec_torch.training.trainer import (
    effective_noise_dimension,
    input_example_shape,
    load_flow_state,
)

DEFAULT_NFE_SWEEP = [1, 10, 50, 250]
SAMPLE_RATE = 44100  # the kbps convention of the stored-format passes


class ComprehensiveEvaluator:
    """Evaluate one trained checkpoint across an NFE sweep, on the card
    unless ``device`` says otherwise."""

    def __init__(self, checkpoint_path: Path | str, config: CodecConfig,
                 nfe_list: list[int] | None = None, num_samples: int = 64,
                 batch_size: int = 32, seed: int = 0,
                 latent_bits: int | None = None,
                 latent_step: float | None = None,
                 timing_runs: int = 5,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.nfe_list = nfe_list or list(DEFAULT_NFE_SWEEP)
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.seed = seed
        #: repetitions of the timed sampling call; 0 skips the timing loop
        #: (the metrics still come from the one decode)
        self.timing_runs = timing_runs
        #: decode from a stored format instead of float latents: ECSQ
        #: (MACB v2) at ``latent_step``, which wins, else ``latent_bits``
        #: fixed-width codes (MACB v1)
        self.latent_bits = latent_bits
        self.latent_step = latent_step
        self.state, model = load_flow_state(checkpoint_path, config,
                                            device=self.device)
        #: the sampling weights: the EMA when the run tracked it
        self.model = model
        if self.state.ema is not None:
            self.model = copy.deepcopy(model)
            with torch.no_grad():
                torch._foreach_copy_(list(self.model.parameters()),
                                     self.state.ema)
        self.model.eval()
        self.noise_dim = effective_noise_dimension(config)
        strategy = create_tokenization_strategy(config.tokenization_strategy,
                                                config.tokenization_config)
        self.adapter = adapter_from_config(config, strategy)
        self.token_shape = compute_token_shape(
            strategy, input_example_shape(config))
        self.param_info = count_parameters(
            dict(zip(self.state.names, self.state.params)),
            model.architecture)
        self._is_mean_flow = (
            config.method in ("mean_flow", "improved_mean_flow")
            or config.use_improved_mean_flow)

    # ---- generation ----------------------------------------------------------
    def _sample_flat(self, latents: torch.Tensor, nfe: int,
                     noise: torch.Tensor) -> torch.Tensor:
        sampler = sample_dual_time if self._is_mean_flow else sample
        return sampler(self.model, self.noise_dim, latents, n_steps=nfe,
                       noise=noise)

    @torch.no_grad()
    def _encode(self, data: np.ndarray
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        raw = torch.from_numpy(np.array(data, dtype=np.float32)).to(
            self.device)
        flat, gains = self.adapter.tokenize_with_gain(raw)
        # gain-normalised runs restore each frame's energy after the decode
        return self.model.encode(flat), (gains if self.adapter.gain_norm
                                         else None)

    def _stored(self, latents: torch.Tensor, gains: torch.Tensor | None,
                data: np.ndarray, results: dict):
        """The latents and gains a reader of the stored format decodes; the
        rANS-coded kbps of audio into ``results``."""
        if self.latent_step:
            bitstream = lq.quantize_latents_ecsq(latents,
                                                 step_frac=self.latent_step)
            results["latent_step"] = self.latent_step
        else:
            bitstream = lq.quantize_latents(latents, bits=self.latent_bits)
            results["latent_bits"] = self.latent_bits
        if gains is not None:
            # the gains through the 8-bit log grid the bytes carry
            gains = torch.from_numpy(lq.dequantize_gains(lq.quantize_gains(
                gains.cpu().numpy()))).to(self.device)
            shape = ((bitstream.codes.shape[0], -1, 1)
                     if bitstream.codes.ndim == 3 else (1, -1, 1))
            bitstream = dataclasses.replace(bitstream,
                                            gains=gains.reshape(shape))
        latents = lq.dequantize_latents(bitstream)
        if self.config.dataset == "audio":
            # stored rate: the coded bytes over the audio's duration
            # (data is [N, frame_size, channels] at 44.1 kHz)
            packed = lq.pack_bitstream(bitstream)
            duration_s = data.shape[0] * data.shape[1] / float(SAMPLE_RATE)
            results["bitstream_kbps_measured"] = (
                len(packed) * 8 / duration_s / 1000.0)
        return latents, gains

    def evaluate(self, real_data: np.ndarray,
                 noise: dict[int, torch.Tensor] | None = None) -> dict:
        """``real_data``: raw (untokenized) examples ``[N, ...]``; ``noise``:
        optional start noise per NFE, ``[rows, noise_dim]``."""
        results: dict[str, Any] = {
            "param_count": self.param_info["total"],
            "nfe_sweep": {},
            "memory_before": memory_usage(self.device),
        }
        data = np.asarray(real_data[:self.num_samples])
        latents, gains = self._encode(data)
        force_completion(latents)
        if self.latent_bits or self.latent_step:
            latents, gains = self._stored(latents, gains, data, results)
        generator = torch.Generator(self.device).manual_seed(self.seed)

        for nfe in self.nfe_list:
            draw = (noise or {}).get(nfe)
            if draw is None:
                draw = torch.randn((latents.shape[0], self.noise_dim),
                                   generator=generator, device=self.device,
                                   dtype=torch.float32)
            draw = draw.to(self.device)
            t0 = time.perf_counter()
            flat = self._sample_flat(latents, nfe, draw)
            force_completion(flat)
            first_latency = time.perf_counter() - t0
            if self.timing_runs > 0:
                timing = inference_time(self._sample_flat, latents, nfe, draw,
                                        warmup=1, runs=self.timing_runs)
            else:
                timing = {"mean_sec": first_latency, "runs": 0,
                          "note": "timing skipped (timing_runs=0); "
                                  "mean_sec is the first call"}
            with torch.no_grad():
                decoded = self.adapter.detokenize_flat(flat, self.token_shape,
                                                       gains=gains)
            decoded_np = decoded.float().cpu().numpy()
            entry = {
                "nfe": nfe,
                "first_call_sec": first_latency,
                "inference": timing,
                **self._quality(data, decoded_np),
            }
            results["nfe_sweep"][str(nfe)] = entry
            print(f"  nfe={nfe}: mse={entry.get('mse', float('nan')):.5f} "
                  f"({timing['mean_sec'] * 1e3:.1f} ms/call)", flush=True)
        results["memory_after"] = memory_usage(self.device)
        return results

    # ---- metrics -------------------------------------------------------------
    def _quality(self, real: np.ndarray, generated: np.ndarray) -> dict:
        n = min(len(real), len(generated))
        real, generated = real[:n], generated[:n]
        out: dict[str, float] = {}
        if self.config.dataset == "audio":
            # [N, frame, 2] flattened: the metrics see interleaved L/R
            ref = real.reshape(n, -1)
            gen = generated.reshape(n, -1)
            m = min(ref.shape[1], gen.shape[1])
            out["mse"] = float(np.mean((ref[:, :m] - gen[:, :m]) ** 2))
            out["spectral_distance"] = float(np.mean([
                am.spectral_distance(r[:m], g[:m])
                for r, g in zip(ref, gen)]))
            out["si_snr_db"] = float(np.mean([
                am.si_snr(r[:m], g[:m]) for r, g in zip(ref, gen)]))
            try:
                out["stoi"] = float(np.mean([
                    am.stoi(r[:m], g[:m]) for r, g in zip(ref, gen)]))
                out["estoi"] = float(np.mean([
                    am.stoi(r[:m], g[:m], extended=True)
                    for r, g in zip(ref, gen)]))
                out["intelligibility_pct"] = am.stoi_to_intelligibility(
                    out["stoi"])
            except (ValueError, ImportError):
                pass
            try:
                out["nsim"] = float(np.mean([
                    am.nsim(r[:m], g[:m]) for r, g in zip(ref, gen)]))
            except ValueError:
                pass
            try:
                out["bsd"] = float(np.mean([
                    am.bsd(r[:m], g[:m]) for r, g in zip(ref, gen)]))
            except ValueError:
                pass
            try:
                out["pesq"] = float(np.mean([
                    am.pesq_score(r[:m], g[:m]) for r, g in zip(ref, gen)]))
            except ImportError:
                pass
        else:
            real_img = real.reshape(n, 28, 28)
            gen_img = generated.reshape(n, -1)[:, :784].reshape(n, 28, 28)
            out["mse"] = float(np.mean((real_img - gen_img) ** 2))
            out["psnr_db"] = im.batch_psnr(real_img, gen_img)
            out["ssim"] = im.batch_ssim(real_img, gen_img)
            if n >= 4:
                out["fid_pixel"] = im.frechet_distance(
                    real_img.reshape(n, -1), gen_img.reshape(n, -1))
                try:
                    out["kid_pixel"] = im.kernel_inception_distance(
                        real_img.reshape(n, -1), gen_img.reshape(n, -1),
                        num_subsets=5, subset_size=min(50, n))
                except ValueError:
                    pass
        return out

    def save_results(self, results: dict, path: Path | str) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(results, indent=2, default=str))
