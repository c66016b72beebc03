#!/usr/bin/env python3
"""Drive the PyTorch port of the codec on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --transforms-only   # phases 1-3 for MDCT/IMDCT

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from meanflow_audio_codec_torch/csrc (nvcc),
     the rANS coder from native/entropy.cpp and the audio loader from
     native/dataloader.cpp (g++), all sources at once,
     and print the build seconds, the ptxas report and
     the instruction mix of the MDCT's, IMDCT's and single-read GELU+GRN's
     main loops (cuobjdump);
  3. hold each kernel against its plain PyTorch version (TF32 off): the
     MDCT/IMDCT at the codec shape (8 rows x 32768 samples, W=512, hop 256),
     a ragged shape (3 rows, W=576, hop 100) and the 10 s clip shape (2 rows
     x 441000 samples, 1721 frames), and both at the train shape (the
     step's tokenize, 32 rows x 32768 samples, and the trainer's sampling
     decode of its 16 clips, [32, 127, 512]) and a streaming push's (2
     rows x 4864 samples), rtol 1e-4 / atol 1e-3; the
     three stage kernels at the train shape (2032 rows x 64 positions x 256
     or 512 channels) and ragged shapes, in bf16 and f32, with the stage
     ops' forward-AD tangents, gradients and grad-of-JVP (reverse mode
     through the tangent) against plain-op autograd, and
     both GELU+GRN kernels (single read at those shapes, two pass at a
     longer P); and time each kernel, its plain version and one library
     call (where one exists) with CUDA events, the MDCT and IMDCT at the
     10 s and train shapes too, and the two-pass GELU+GRN
     at the train shape beside the single read;
  4. the served path: ``AudioCodec.roundtrip`` at the full width of
     configs/frontier_v2.json (bf16 compute, seeded random weights) on four
     32768-sample stereo clips and one 10 s 44.1 kHz stereo clip;
  5. the train path (the config's remat honoured, as in every train phase
     below): the iMF ``make_train_step`` at frontier-v2 width with
     ``fused_stage`` on, bf16 compute, on 16 synthetic stereo clips of 32768
     samples (2032 flow rows), 2 warm-up and 10 timed steps; then the same
     with ``fused_stage`` off (the default training path, as a yardstick),
     2 warm-up and 5 timed steps;
     each path (and those of phases 7-12 and 9a) is driven with the
     kernels' launch counts (and the count of each GELU+GRN kernel) set to
     0 just before it and read just after;
  6. float32 checks: one full-width train step with ``fused_stage`` on
     against the same step with it off; the round trip and one small-batch
     fused train step on the card against the same on the CPU;
  7. (run right after phase 5, whose bare unfused step it is set beside)
     the trainer: ``python -m meanflow_audio_codec_torch.train --config
     configs/frontier_v2.json`` through its ``main`` at full width (bf16,
     ``fused_stage`` off as in the config, chunks of 16 steps, the device
     replay pool cut from 1024 clips to 64), 32 steps with a checkpoint
     every 16 and sampling at 32, then ``--resume`` to 48 steps, in a
     temporary workdir; checks the log (48 steps, finite, accepted,
     resumed at 32), the retained checkpoints, the serving file against
     the run's EMA, the WAV sample and the summary; prints the chunk time
     per step, steps/s, frames/s, peak memory, FLOPs per step, achieved
     TFLOP/s and MFU beside the bare unfused step's of phase 5; then times
     and profiles the trainer's 16-step chunk alone and counts the host
     synchronisations inside one chunk
     (``torch.cuda.set_sync_debug_mode("warn")``, with their stacks);
  8. (run right after the trainer, on its workdir) serving:
     ``AudioCodec.from_workdir`` on the workdir and on a copy holding only
     ``serving_step_00048.msgpack``, both checked to serve the run's EMA;
     a 10 s 44.1 kHz stereo clip through ``encode_bytes`` ->
     ``decode_bytes`` as MACB v1 8-bit, v1 4-bit and v2 ECSQ
     (``step_frac`` 0.5), each checked to be rANS-coded, to decode from
     bytes as in memory bit for bit, to give ``(nf-1)*hop + 2W`` finite
     samples, with the device encode, quantize + device-to-host + rANS,
     ``encode_bytes`` and ``decode_bytes`` times and the stored kbps;
     ``decode(x)`` twice without a generator equal; then the codec CLI
     (encode, info, decode) on a 48 kHz WAV;
  9. streaming: the same length of clip through ``StreamingCodec`` in
     pushes of 4096 samples (16 frames), ms per push and the real-time
     factor; the streaming encoder against batch ``encode`` and the
     streaming decoder in 16- against 64-frame chunks, within relative L2
     2e-2 (bf16 compute; the measured max error is printed);
  9a. the corpus: ``tools/make_corpus`` writes 16 FLAC and 4 WAV clips of
     4.46 s (mixed family) into a temporary directory; the frames/s of
     ``build_audio_pipeline`` over it for 20 batches of 16 x 32768 x 2,
     native with 2 threads (as the trainer builds it, ``files_skipped``
     0) and the Python stages; then ``python -m
     meanflow_audio_codec_torch.train --config configs/corpus_rehearsal.json
     --data-dir <corpus>`` through ``main`` at full width (114,472,384
     parameters, bf16, chunks of 16, ``dots_saveable``, the device pool cut
     from 1024 clips to 64), 32 steps then ``--resume`` to 48, each run
     checkpointing and sampling once, at its end; the trainer phase's
     checks of the workdir and the parameter count; chunk ms per step,
     steps/s, frames/s, peak memory, FLOPs and MFU beside the loader's
     rate, and the seconds and bytes of every checkpoint write; the exact
     stream (``--device-pool-clips 0``, the default for a corpus) for 32
     steps, its chunk ms per step beside the pooled run's and the host
     synchronisations inside its second chunk (0 required); the run served
     (``from_workdir``, the codec CLI on a FLAC clip of the corpus) and a
     10 s clip's ``encode_bytes`` / ``decode_bytes`` as v1 8-bit;
  10. (run right after serving, on the trainer's workdir) the QAT trainer:
     chain stage 2c at full width, the trainer's step-48 checkpoint and its
     metadata copied into a fresh workdir and ``python -m
     meanflow_audio_codec_torch.train --config configs/frontier_v2_qat.json
     --resume`` for 2 chunks of 16 (STE through the ECSQ 0.5 grid, remat),
     sampling at the end; chunk ms per step, peak memory, ``update_ok`` on
     every step; the run served and a 10 s clip's latents through the ECSQ
     0.5 byte path within half a step;
  11. objectives: one bare bf16 step each (median of 5 after 2 warm-ups,
     peak memory) of flow matching, mean flow, the autoencoder, iMF without
     the stop-gradient (plain and ``fused_stage``) and iMF with the learned
     weighting, at frontier-v2's batch, then one 2-step sampling pass for
     the flow objectives (Heun for flow matching); launches per objective;
  12. remat: the bare iMF step without remat, with
     ``architecture_options.remat`` under ``dots_saveable`` (each stage's
     elementwise segments recomputed) and under policy None (each stage
     recomputed whole) and with ``tpu.remat``, and the ``fused_stage``
     step without remat (step ms, peak memory),
     and their float32 gradients at one clip within relative L2 1e-5;
  13. float32 checks (phase 6) plus each objective's loss and gradients on
     the card against the CPU at one clip (relative L2 <= 1e-5), then
     profiles of one round trip and one bf16 train step with
     ``fused_stage`` on and off (device time by kernel, busy share);
  14. a ``{"kernels": [...]}`` line (launches per path: round trip, train,
     trainer, codec bytes, codec CLI, streaming, QAT trainer, the corpus
     trainer, its exact stream and serving, each objective, each remat
     setting), then the result line
     ``{"ok": true, "device": {...}}`` last.

With ``--transforms-only`` it runs phases 1-3 for the MDCT and IMDCT alone
(no instruction mix) and prints their line of results but no result line:
copied into another checkout of the port, it times that checkout's kernels
at the same shapes.

Needs one CUDA card; exits with code 2 when there is none.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import torch
import torch.nn.functional as F

from meanflow_audio_codec_torch import serialization, weights
from meanflow_audio_codec_torch import train as train_cli
from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.configs import load_config
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops import _build
from meanflow_audio_codec_torch.ops import imdct_cuda as imdct_cuda_mod
from meanflow_audio_codec_torch.ops import mdct_cuda as mdct_cuda_mod
from meanflow_audio_codec_torch.ops import stage, stage_cuda
from meanflow_audio_codec_torch.ops.imdct_cuda import imdct_cuda
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    imdct,
    imdct_scale,
    mdct,
    num_frames_for_length,
    output_length,
    windowed_basis,
)
from meanflow_audio_codec_torch.ops.mdct_cuda import mdct_cuda
from meanflow_audio_codec_torch.ops.sampling import sample, sample_dual_time
from meanflow_audio_codec_torch.ops.tokenize import (
    MDCTTokenization,
    create_tokenization_strategy,
)
from meanflow_audio_codec_torch.training import profiling
from meanflow_audio_codec_torch.training.adapter import adapter_from_config
from meanflow_audio_codec_torch.training.logging import read_log
from meanflow_audio_codec_torch.training.objectives import create_loss_strategy
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    make_optimizer,
)
from meanflow_audio_codec_torch.training.train_step import (
    make_multi_step,
    make_train_step,
)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "frontier_v2.json"
QAT_CONFIG = REPO / "configs" / "frontier_v2_qat.json"
CORPUS_CONFIG = REPO / "configs" / "corpus_rehearsal.json"
#: the corpus phase's corpus (make_corpus, mixed family), the loader's timed
#: batches and the corpus config's parameter count (the JAX package's)
CORPUS_FLAC, CORPUS_WAV, CORPUS_SECONDS = 16, 4, 4.46
LOADER_BATCHES = 20
CORPUS_PARAMS = 114_472_384
SAMPLE_RATE = 44100
RTOL, ATOL = 1e-4, 1e-3
REPEATS = 10  # timed round trips per request
TRAIN_CLIPS, CLIP_LEN = 16, 32768  # frontier-v2 batch_size and frame_size
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

KERNELS = {
    "mdct_cuda": dict(
        source="meanflow_audio_codec_torch/csrc/mdct.cu",
        replaces="meanflow_audio_codec_tpu/ops/mdct_pallas.py:94"),
    "imdct_cuda": dict(
        source="meanflow_audio_codec_torch/csrc/imdct.cu",
        replaces="meanflow_audio_codec_tpu/ops/imdct_pallas.py:96"),
    "ln_film_cuda": dict(
        source="meanflow_audio_codec_torch/csrc/stage.cu",
        replaces="meanflow_audio_codec_tpu/ops/stage_pallas.py:169"),
    "ln_norm_cuda": dict(
        source="meanflow_audio_codec_torch/csrc/stage.cu",
        replaces="meanflow_audio_codec_tpu/ops/stage_pallas.py:204"),
    "gelu_grn_cuda": dict(
        source="meanflow_audio_codec_torch/csrc/stage.cu",
        replaces="meanflow_audio_codec_tpu/ops/stage_pallas.py:235"),
}
#: stage-kernel tolerances: f32 outputs and every statistic (the same f32
#: arithmetic summed in another order); bf16 outputs (one bf16 rounding step,
#: 2**-7 relative, flips where the f32 values differ in their last bits);
#: tangents and gradients (the JVP rule's two-pass formula against autograd)
STAGE_F32 = dict(rtol=1e-4, atol=1e-5)
STAGE_BF16 = dict(rtol=1e-2, atol=1e-2)
STAGE_DIFF = dict(rtol=1e-4, atol=1e-4)
#: float32 train step, fused_stage on against off and card against CPU:
#: relative L2 of the flattened gradients / Adam first moments (the same f32
#: arithmetic in another order; read 3.2e-7 and 9.6e-7 on an H100)
TRAIN_REL_L2 = 1e-5


#: the stored formats the codec phase writes and reads (codec_cli's --bits
#: and --latent-step)
FORMATS = {"v1 8-bit": dict(bits=8), "v1 4-bit": dict(bits=4),
           "v2 ECSQ step_frac 0.5": dict(step_frac=0.5)}
BYTES_REPEATS = 5
STREAM_CHUNK = 4096  # samples per streaming push: 16 frames at hop 256
#: streaming against batch on the card, bf16 compute: the model's products
#: may take other algorithms at other row counts (relative L2, the bf16
#: tolerance of the codec's CPU parity tests)
STREAM_REL_L2 = 2e-2
#: the bare steps of the objectives and switches phase: label -> (config
#: fields over frontier_v2.json, fused_stage)
OBJECTIVES = {
    "fm": (dict(method="flow_matching", use_improved_mean_flow=False), False),
    "mf": (dict(method="mean_flow", use_improved_mean_flow=False), False),
    "ae": (dict(method="autoencoder", use_improved_mean_flow=False), False),
    "imf_no_stop_gradient": (dict(use_stop_gradient=False), False),
    "imf_no_stop_gradient_fused": (dict(use_stop_gradient=False), True),
    "imf_learned": (dict(loss_weighting="learned"), False),
}
OBJ_WARMUP, OBJ_STEPS = 2, 5
#: the remat phase: label -> (architecture_options over the config's,
#: tpu.remat, fused_stage); ``dots_saveable`` checkpoints each stage's
#: elementwise segments, policy None each stage whole (models/remat.py); the
#: fused step is timed without remat and left out of the gradient check
REMAT = {"none": (dict(remat=False), False, False),
         "stage_dots_saveable": (dict(remat=True,
                                      remat_policy="dots_saveable"), False,
                                 False),
         "stage_whole": (dict(remat=True, remat_policy=None), False, False),
         "loss_tpu_remat": (dict(remat=False), True, False),
         "none_fused": (dict(remat=False), False, True)}


def card_line() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True,
        timeout=60).stdout
    return out.strip().splitlines()[0]


def zero_launches() -> None:
    mdct_cuda_mod.launches = 0
    imdct_cuda_mod.launches = 0
    for counts in (stage_cuda.launches, stage_cuda.gelu_grn_variants):
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    return {"mdct_cuda": mdct_cuda_mod.launches,
            "imdct_cuda": imdct_cuda_mod.launches, **stage_cuda.launches,
            "gelu_grn_variants": dict(stage_cuda.gelu_grn_variants)}


def time_ms(fn, batches: int = 5, batch_ms: float = 5.0) -> float:
    """Device milliseconds per call of ``fn`` by CUDA events: the median over
    ``batches`` batches of calls, each spanning about ``batch_ms``, after a
    warm-up of at least 20 ms of calls (the clocks leave idle)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(calls: int) -> float:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    calls, spent = 1, run(1)
    while spent < 20.0:
        calls *= 2
        spent = run(calls)
    calls = max(1, math.ceil(batch_ms * calls / spent))
    return statistics.median(run(calls) / calls for _ in range(batches))


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least milliseconds the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


#: kernels whose main loop ``sass_profile`` reads: (library, mangled-name part)
SASS_KERNELS = {"mdct_cuda": ("mdct", "mdct_kernelILi4E"),
                "imdct_cuda": ("imdct", "imdct_kernelILi4E"),
                "gelu_grn_cuda single_read": (
                    "stage", "gelu_grn_single_read_kernelI13__nv_bfloat16Li8E")}


def sass_profile() -> None:
    """The instruction mix of the redesigned kernels' main loops (the largest
    loop of each, from ``cuobjdump -sass`` of the built libraries): the FMA
    share of the issue slots is what bounds a kernel that waits on neither
    memory nor barriers."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print("SASS profile: cuobjdump not found (not measured)", flush=True)
        return
    for label, (lib, part) in SASS_KERNELS.items():
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(lib))],
            check=True, capture_output=True, text=True, timeout=120).stdout
        body = next(f for f in re.split(r"\n\s*Function : ", sass)
                    if part in f.split("\n")[0])
        ops = [(int(a, 16), op.split()[-1].split(".")[0], rest)
               for a, op, rest in re.findall(
                   r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?[A-Z][A-Z0-9_.]*)"
                   r"([^;]*);", body)]
        loops = [(int(m.group(1), 16), at) for at, op, rest in ops
                 if op == "BRA" and (m := re.search(r"0x([0-9a-f]+)", rest))
                 and int(m.group(1), 16) < at]
        lo, hi = max(loops, key=lambda span: span[1] - span[0])
        mix = collections.Counter(op for at, op, _ in ops if lo <= at <= hi)
        total = sum(mix.values())
        print(f"SASS profile {label}: main loop {total} instructions, FFMA "
              f"{mix['FFMA']} ({100 * mix['FFMA'] / total:.1f}%), FMUL "
              f"{mix['FMUL']}, FADD {mix['FADD']}, MUFU {mix['MUFU']}, LDS "
              f"{mix['LDS']}; others {mix.most_common(12)}", flush=True)


def mdct_library(x2d: torch.Tensor, cfg: MDCTConfig, nf: int) -> torch.Tensor:
    """as_strided framing (``unfold``) + one matmul; timed, never used."""
    w, hop = cfg.window_size, cfg.hop_size
    need = output_length(nf, w, hop)
    x2d = F.pad(x2d, (0, max(0, need - x2d.shape[1])))
    frames = x2d.unfold(1, 2 * w, hop)[:, :nf]
    return torch.matmul(frames, windowed_basis(w, x2d.device))


def imdct_library(X: torch.Tensor, cfg: MDCTConfig) -> torch.Tensor:
    """One matmul + ``F.fold`` overlap-add; timed, never used."""
    w, hop = cfg.window_size, cfg.hop_size
    rows, nf, _ = X.shape
    frames = imdct_scale(cfg) * torch.matmul(
        X, windowed_basis(w, X.device, transposed=True))
    out = F.fold(frames.transpose(1, 2), output_size=(1, output_length(
        nf, w, hop)), kernel_size=(1, 2 * w), stride=(1, hop))
    return out.reshape(rows, -1)


def _errors(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    diff = (got - ref).abs()
    return (diff.max().item(),
            (diff / ref.abs().clamp_min(1e-6)).max().item())


def check_kernels(device: torch.device) -> dict:
    """The MDCT and IMDCT against their plain versions at the codec, ragged
    and 10 s clip shapes, at the train shape (the step's tokenize, 32 rows
    x 32768 samples, and the trainer's sampling decode, [32, 127, 512]) and
    at a streaming push's (2 rows x 4864 samples, 18 frames); times at the
    codec shape (keys ``ms``, ...), the 10 s shape (``ms_10s``, ...), the
    train shape (``ms_train``, ...) and the push (``ms_stream``, ...)."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {name: {"max_abs_err": 0.0}
               for name in ("mdct_cuda", "imdct_cuda")}
    for label, rows, length, w, hop in [
            ("codec", 8, 32768, 512, 256), ("ragged", 3, 5000, 576, 100),
            ("10s", 2, 10 * SAMPLE_RATE, 512, 256),
            ("train", 2 * TRAIN_CLIPS, CLIP_LEN, 512, 256),
            # a streaming push: 4096 new samples after the 768 carried
            ("stream", 2, STREAM_CHUNK + 768, 512, 256)]:
        cfg = MDCTConfig(w, hop)
        nf = num_frames_for_length(length, w, hop)
        out_len = output_length(nf, w, hop)
        x = torch.randn(rows, length, generator=gen, device=device)
        X = torch.randn(rows, nf, w, generator=gen, device=device)
        cases = {
            "mdct_cuda": (lambda: mdct_cuda(x, cfg), lambda: mdct(x, cfg),
                          lambda: mdct_library(x, cfg, nf),
                          2.0 * rows * nf * 2 * w * w,
                          4.0 * (rows * length + 2 * w * w + rows * nf * w)),
            "imdct_cuda": (lambda: imdct_cuda(X, cfg), lambda: imdct(X, cfg),
                           lambda: imdct_library(X, cfg),
                           2.0 * rows * nf * w * 2 * w,
                           4.0 * (rows * nf * w + 2 * w * w + rows * out_len)),
        }
        for name, (kernel, plain, library, flops, nbytes) in cases.items():
            got, ref, lib = kernel(), plain(), library()
            torch.cuda.synchronize()
            abs_err, rel_err = _errors(got, ref)
            print(f"{name} {label} rows={rows} W={w} hop={hop} nf={nf}: "
                  f"max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
                  f"(rtol {RTOL}, atol {ATOL})", flush=True)
            torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(lib, ref, rtol=RTOL, atol=ATOL)
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], abs_err)
            if label == "ragged":
                continue
            suffix = "" if label == "codec" else f"_{label}"
            res["ms" + suffix] = time_ms(kernel)
            res["plain_ms" + suffix] = time_ms(plain)
            res["library_ms" + suffix] = time_ms(library)
            (res["bound_ms" + suffix],
             res["bound_by" + suffix]) = bound(flops, nbytes)
            print(f"{name} {label} shape: kernel {res['ms' + suffix]:.4f} ms, "
                  f"plain {res['plain_ms' + suffix]:.4f} ms, library "
                  f"{res['library_ms' + suffix]:.4f} ms, bound "
                  f"{res['bound_ms' + suffix]:.4f} ms "
                  f"({res['bound_by' + suffix]})", flush=True)

    # the tokenizer's round trip through both kernels: W/hop = 2x the input
    tok = MDCTTokenization(512)
    audio = torch.randn(2, 32768, 2, generator=gen, device=device)
    back = tok.detokenize(tok.tokenize(audio))
    inner = slice(1024, 32768 - 1024)
    torch.testing.assert_close(back[:, inner], 2.0 * audio[:, inner],
                               rtol=RTOL, atol=ATOL)
    print("tokenizer round trip on the card: 2x the input within "
          f"rtol {RTOL} / atol {ATOL}", flush=True)
    return results


def synth_audio(batch: int, length: int, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """Stereo test audio: a few random tones plus noise, peak ~0.6."""
    t = torch.arange(length, device=device) / SAMPLE_RATE
    freqs = 100 + 4000 * torch.rand(batch, 4, 1, 1, generator=gen,
                                    device=device)
    phases = 6.283 * torch.rand(batch, 4, 1, 2, generator=gen, device=device)
    tones = torch.sin(6.283 * freqs * t[None, None, :, None] + phases)
    noise = 0.05 * torch.randn(batch, length, 2, generator=gen, device=device)
    return 0.12 * tones.sum(1) + noise


def roundtrip_path(device: torch.device, card: str):
    """Round trips at frontier-v2 width; returns the kernels' launch counts,
    the codec and the requests."""
    config = load_config(CONFIG)
    model = create_flow_model(config, generator=torch.Generator().manual_seed(0))
    codec = AudioCodec(model, None, config, device=device)
    n_params = sum(p.numel() for p in codec.model.parameters())
    print(f"codec: frontier_v2 width, {n_params} params, compute "
          f"{codec.model.compute_dtype}, params {next(model.parameters()).dtype}",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(1)
    requests = {"4 clips x 32768": synth_audio(4, 32768, gen, device),
                "1 clip x 10 s": synth_audio(1, 10 * SAMPLE_RATE, gen, device)}
    for audio in requests.values():  # warm-up: cuDNN/cuBLAS plans, kernels
        codec.roundtrip(audio, generator=gen)
    torch.cuda.synchronize()

    zero_launches()
    for name, audio in requests.items():
        batch, length, _ = audio.shape
        enc_ms, dec_ms = [], []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            latents, gains = codec.encode_with_gains(audio)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            recon = codec.decode(latents, generator=gen, gains=gains)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enc_ms.append(1e3 * (t1 - t0))
            dec_ms.append(1e3 * (t2 - t1))
        nf = num_frames_for_length(length, 512, 256)
        expected = (batch, (nf - 1) * 256 + 1024, 2)
        if tuple(recon.shape) != expected:
            raise AssertionError(f"{name}: shape {tuple(recon.shape)}, "
                                 f"expected {expected}")
        if not torch.isfinite(recon).all():
            raise AssertionError(f"{name}: non-finite output")
        if tuple(latents.shape) != (batch, nf, config.latent_dimension):
            raise AssertionError(f"{name}: latents {tuple(latents.shape)}")
        seconds = batch * length / SAMPLE_RATE
        total = [e + d for e, d in zip(enc_ms, dec_ms)]
        for metric, values in (("encode_ms", enc_ms), ("decode_ms", dec_ms)):
            print(f"[{card}] {name}: {metric} median "
                  f"{statistics.median(values):.3f} max {max(values):.3f} "
                  f"(n={REPEATS})", flush=True)
        rtf = statistics.median(total) / 1e3 / seconds
        print(f"[{card}] {name}: rtf median {rtf:.6f} max "
              f"{max(total) / 1e3 / seconds:.6f} ({1 / rtf:.1f}x real time, "
              f"{seconds:.3f} s of audio, n={REPEATS})", flush=True)
    launches = read_launches()
    print(f"round-trip path launches: {launches}", flush=True)
    for name in ("mdct_cuda", "imdct_cuda"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the round trip")
    return launches, codec, requests


def check_against_cpu(device: torch.device) -> None:
    """A float32 copy of the codec on the card against the same weights and
    noise on the CPU (plain versions), on one short clip."""
    config = dataclasses.replace(load_config(CONFIG), precision="float32")
    model = create_flow_model(config, generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(2)
    audio = synth_audio(1, 4096, gen, torch.device("cpu"))
    nf = num_frames_for_length(4096, 512, 256)
    noise = torch.randn(nf, config.noise_dimension, generator=gen)
    cpu = AudioCodec(model, None, config, device="cpu").roundtrip(
        audio, noise=noise)
    gpu_model = create_flow_model(config)
    gpu = AudioCodec(gpu_model, state, config, device=device).roundtrip(
        audio, noise=noise).cpu()
    abs_err, _ = _errors(gpu, cpu)
    rel_l2 = ((gpu - cpu).norm() / cpu.norm()).item()
    print(f"float32 codec, card vs CPU on one 4096-sample clip: max_abs_err "
          f"{abs_err:.3e}, rel_l2 {rel_l2:.3e} (rtol 1e-3, atol 1e-3)",
          flush=True)
    torch.testing.assert_close(gpu, cpu, rtol=1e-3, atol=1e-3)


def _stage_cases(x, s, b, x2, gamma, beta):
    """name -> (kernel, plain version, library call or None, public op, its
    arguments): the LayerNorms on ``x`` [N, P, C], GELU+GRN on ``x2``
    [N, P, 2C], as the ConvNeXt block runs them."""
    return {
        "ln_film_cuda": (lambda: stage_cuda.ln_film_cuda(x, s, b),
                         lambda: stage._ln_film_ref(x, s, b), None,
                         stage.fused_ln_film, (x, s, b)),
        "ln_norm_cuda": (lambda: stage_cuda.ln_norm_cuda(x),
                         lambda: stage._ln_norm_ref(x),
                         lambda: F.layer_norm(x, x.shape[-1:], eps=1e-6),
                         stage.fused_ln_norm, (x,)),
        "gelu_grn_cuda": (lambda: stage_cuda.gelu_grn_cuda(x2, gamma, beta),
                          lambda: stage._gelu_grn_ref(x2, gamma, beta), None,
                          stage.fused_gelu_grn, (x2, gamma, beta)),
    }


def _stage_inputs(n: int, p: int, c: int, dtype: torch.dtype,
                  gen: torch.Generator, device: torch.device):
    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=device)
                ).to(dtype)
    return (rand(n, p, c, scale=2.0), rand(n, c, scale=0.3),
            rand(n, c, scale=0.3))


def _stage_bytes(name: str, x: torch.Tensor) -> float:
    """Bytes the function must move: each input read once, each output
    written once."""
    n, p, c = x.shape
    item = x.element_size()
    if name == "gelu_grn_cuda":  # x, gamma and beta (f32); y and gx (f32)
        return 2.0 * n * p * c * item + 2 * 4 * c + 4.0 * n * c
    film = 2.0 * n * c * item if name == "ln_film_cuda" else 0.0
    return 2.0 * n * p * c * item + film + 2 * 4.0 * n * p


def _check_stage_op_calculus(op, args, tangents) -> float:
    """The public op's forward-AD tangent and gradient against autograd of
    its plain version; returns the largest tangent error."""
    import torch.autograd.forward_ad as fwAD

    ref = {stage.fused_ln_film: stage._ln_film_ref,
           stage.fused_ln_norm: stage._ln_norm_ref,
           stage.fused_gelu_grn: stage._gelu_grn_ref}[op]
    outs = []
    for fn in (op, lambda *a: ref(*a)[0]):
        with fwAD.dual_level():
            y, ty = fwAD.unpack_dual(fn(*(fwAD.make_dual(a, t)
                                          for a, t in zip(args, tangents))))
        leaves = [a.detach().clone().requires_grad_() for a in args]
        grads = torch.autograd.grad(torch.sin(fn(*leaves)).sum(), leaves)
        outs.append((y, ty, grads))
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0][0], outs[1][0], **STAGE_F32)
    torch.testing.assert_close(outs[0][1], outs[1][1], **STAGE_DIFF)
    for g, r in zip(outs[0][2], outs[1][2]):
        torch.testing.assert_close(g, r, **STAGE_DIFF)
    return (outs[0][1] - outs[1][1]).abs().max().item()


def _check_stage_grad_of_jvp(op, args, tangent) -> float:
    """Reverse mode through the public op's tangent (the objectives without
    the stop-gradient): the gradient of sum((u + 0.3 du)^2), (u, du) the
    JVP along ``tangent`` for x, with respect to every input and the
    tangent, kernel path against autograd of the plain version. Each
    gradient is held at rtol 1e-4 and an atol of 1e-4 times its largest
    magnitude, so that the check does not depend on the loss's scale (a
    zero gradient, or one off by a factor, fails); returns the largest error
    relative to that magnitude."""
    import torch.autograd.forward_ad as fwAD

    ref = {stage.fused_ln_film: stage._ln_film_ref,
           stage.fused_ln_norm: stage._ln_norm_ref,
           stage.fused_gelu_grn: stage._gelu_grn_ref}[op]
    outs = []
    for fn in (op, lambda *a: ref(*a)[0]):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        v = tangent.detach().clone().requires_grad_()
        with fwAD.dual_level(), stage.differentiable_tangents():
            u, du = fwAD.unpack_dual(fn(fwAD.make_dual(leaves[0], v),
                                        *leaves[1:]))
        outs.append(torch.autograd.grad(
            (u.float() + 0.3 * du.float()).square().sum(), leaves + [v]))
    torch.cuda.synchronize()
    errors = []
    for g, r in zip(*outs):
        scale = r.abs().max().item()
        torch.testing.assert_close(g, r, rtol=STAGE_DIFF["rtol"],
                                   atol=STAGE_DIFF["atol"] * scale)
        errors.append((g - r).abs().max().item() / scale)
    return max(errors)


def _time_op_phases(op, args) -> tuple[float, float, float]:
    """Milliseconds of the public op's forward, forward with a JVP (forward
    AD, a tangent on every floating input), and forward + backward, as the
    train step calls it."""
    import torch.autograd.forward_ad as fwAD

    tangents = [torch.randn_like(a) for a in args]
    leaves = [a.detach().requires_grad_() for a in args]
    grad_y = torch.randn_like(op(*args))

    def forward_jvp():
        with fwAD.dual_level():
            op(*(fwAD.make_dual(a, t) for a, t in zip(args, tangents)))

    return (time_ms(lambda: op(*args)), time_ms(forward_jvp),
            time_ms(lambda: torch.autograd.grad(op(*leaves), leaves,
                                                grad_y)))


def gelu_grn_two_pass(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-pass GELU+GRN kernel at any shape, past the wrapper's choice
    by shape: to hold it against the plain version and time it beside the
    single-read kernel at the train shape. Counts no launch."""
    n, p, c = x.shape
    y = torch.empty_like(x)
    gx = torch.empty((n, c), dtype=torch.float32, device=x.device)
    err = stage_cuda._kernels().gelu_grn_two_pass_forward(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        gx.data_ptr(), n, p, c, stage_cuda._DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"two-pass gelu_grn launch failed: {err}")
    return y, gx


def check_stage_kernels(device: torch.device) -> dict:
    """Kernels 3-5 against their plain versions at the train shape (LN at
    C = 256, GELU+GRN at 2C = 512), two ragged shapes and a long-P shape
    (GELU+GRN takes its two-pass kernel there), in bf16 and f32, and the
    two-pass GELU+GRN kernel at the train shape too; the public ops'
    tangents and gradients in f32 at the train shape; times of the bf16
    train shape, the dtype of the train path."""
    gen = torch.Generator(device=device).manual_seed(4)
    results = {name: {"max_abs_err": 0.0} for name in stage_cuda.launches}
    n_train = TRAIN_CLIPS * num_frames_for_length(CLIP_LEN, 512, 256)
    variants_checked = set()
    for label, (n, p, c) in [("train", (n_train, 64, 256)),
                             ("ragged", (3, 9, 40)), ("ragged", (3, 9, 41)),
                             ("long P", (4, 256, 256))]:
        for dtype in (torch.bfloat16, torch.float32):
            x, s, b = _stage_inputs(n, p, c, dtype, gen, device)
            x2 = _stage_inputs(n, p, 2 * c, dtype, gen, device)[0]
            gamma = 0.5 * torch.randn(2 * c, generator=gen, device=device)
            beta = 0.1 * torch.randn(2 * c, generator=gen, device=device)
            tol = STAGE_F32 if dtype == torch.float32 else STAGE_BF16
            cases = _stage_cases(x, s, b, x2, gamma, beta)
            variant = stage_cuda.gelu_grn_variant(x2)
            variants_checked.add(variant)
            if label == "train":  # the two-pass kernel where it is not chosen
                cases["gelu_grn_cuda two_pass"] = (
                    lambda: gelu_grn_two_pass(x2, gamma, beta),
                    *cases["gelu_grn_cuda"][1:])
                variants_checked.add("two_pass")
            for name, (kernel, plain, library, op, args) in cases.items():
                got, ref = kernel(), plain()
                torch.cuda.synchronize()
                err = (got[0].float() - ref[0].float()).abs().max().item()
                stat_err = max((g - r).abs().max().item()
                               for g, r in zip(got[1:], ref[1:]))
                kind = (f" ({variant})" if name == "gelu_grn_cuda" else "")
                print(f"{name}{kind} {label} {tuple(args[0].shape)} {dtype}: "
                      f"y max_abs_err {err:.3e}, stats {stat_err:.3e} "
                      f"(y {tol}, stats {STAGE_F32})", flush=True)
                torch.testing.assert_close(got[0], ref[0], **tol)
                for g, r in zip(got[1:], ref[1:]):
                    torch.testing.assert_close(g, r, **STAGE_F32)
                res = results[name.split()[0]]
                res["max_abs_err"] = max(res["max_abs_err"], err, stat_err)
                if label != "train":
                    continue
                if name == "gelu_grn_cuda two_pass":
                    if dtype == torch.bfloat16:  # beside the single read
                        res["two_pass_ms"] = time_ms(kernel)
                        print(f"{name} train shape bf16: kernel "
                              f"{res['two_pass_ms']:.4f} ms", flush=True)
                    continue
                if dtype == torch.float32:
                    tangents = [torch.randn(a.shape, generator=gen,
                                            device=device) for a in args]
                    terr = _check_stage_op_calculus(op, args, tangents)
                    gerr = _check_stage_grad_of_jvp(op, args, tangents[0])
                    print(f"{name} public op, f32 train shape: tangent "
                          f"max_abs_err {terr:.3e}, gradient within "
                          f"{STAGE_DIFF} of plain autograd; grad-of-JVP "
                          f"(x, parameters, tangent) max_abs_err / max|g| "
                          f"{gerr:.3e} (rtol 1e-4, atol 1e-4 max|g|)",
                          flush=True)
                    res["grad_of_jvp_rel_err"] = gerr
                    continue
                res["ms"] = time_ms(kernel)
                res["plain_ms"] = time_ms(plain)
                res["library_ms"] = (time_ms(library) if library is not None
                                     else None)
                # a normalisation pass: bound by the bytes it moves
                res["bound_ms"] = (1e3 * _stage_bytes(name, args[0])
                                   / PEAK_BYTES_PER_S)
                res["bound_by"] = "bytes"
                lib = ("none (no single PyTorch call computes it)"
                       if library is None else f"{res['library_ms']:.4f} ms")
                print(f"{name} train shape bf16: kernel {res['ms']:.4f} ms, "
                      f"plain {res['plain_ms']:.4f} ms, library {lib}, bound "
                      f"{res['bound_ms']:.4f} ms ({res['bound_by']})",
                      flush=True)
                fwd, jvp, bwd = _time_op_phases(op, args)
                print(f"{op.__name__} train shape bf16: forward {fwd:.4f} ms, "
                      f"forward + JVP {jvp:.4f} ms, forward + backward "
                      f"{bwd:.4f} ms; a train step runs 16 forwards, 8 of "
                      f"them with the JVP, and 8 backwards per op", flush=True)
    if variants_checked != set(stage_cuda.gelu_grn_variants):
        raise AssertionError(f"GELU+GRN kernels checked: {variants_checked}")
    return results


def frontier_config(precision: str, fused: bool, options: dict | None = None,
                    **fields):
    """configs/frontier_v2.json (its ``architecture_options``, remat
    included, as the file sets them) with ``precision``, ``fused_stage``,
    more ``options`` and other config ``fields`` set."""
    base = load_config(CONFIG)
    return dataclasses.replace(
        base, precision=precision,
        architecture_options=dict(base.architecture_options,
                                  fused_stage=fused, **(options or {})),
        **fields)


def train_setup(device: torch.device, fused: bool, precision: str,
                seed: int = 0, options: dict | None = None, **fields):
    """(train state, step function) for the frontier-v2 config with
    ``fused_stage``, more architecture ``options`` and config ``fields``
    set as asked, weights from ``seed``."""
    config = frontier_config(precision, fused, options, **fields)
    model = create_flow_model(
        config, generator=torch.Generator().manual_seed(seed))
    adapter = adapter_from_config(config, create_tokenization_strategy(
        config.tokenization_strategy, config.tokenization_config))
    state = TrainState(model, make_optimizer(config), config.ema_decay,
                       device=device)
    step = make_train_step(create_loss_strategy(config), adapter,
                           remat=config.remat,
                           skip_nonfinite=config.skip_nonfinite_updates)
    return state, step


def _check_step(metrics: dict, where: str) -> None:
    loss, grad_norm = metrics["loss"].item(), metrics["grad_norm"].item()
    if not (math.isfinite(loss) and math.isfinite(grad_norm)
            and metrics["update_ok"]):
        raise AssertionError(f"{where}: loss {loss}, grad_norm {grad_norm}, "
                             f"update_ok {metrics['update_ok']}")


def train_path(device: torch.device, card: str, fused: bool = True,
               steps: int = TRAIN_STEPS):
    """The iMF train step at frontier-v2 width, bf16, ``fused_stage`` as
    asked (off: the default training path, the yardstick); returns the
    launch counts of the timed steps, the state, step and batch."""
    state, step = train_setup(device, fused=fused, precision="bfloat16")
    n_params = sum(p.numel() for p in state.params)
    gen = torch.Generator(device=device).manual_seed(5)
    batch = synth_audio(TRAIN_CLIPS, CLIP_LEN, gen, device)
    rows = TRAIN_CLIPS * num_frames_for_length(CLIP_LEN, 512, 256)
    flag = "on" if fused else "off"
    print(f"train step: frontier_v2 width, fused_stage {flag}, {n_params} "
          f"params, compute {state.model.compute_dtype}, {TRAIN_CLIPS} clips "
          f"x {CLIP_LEN} samples = {rows} flow rows", flush=True)
    for i in range(TRAIN_WARMUP):
        state, metrics = step(state, batch, generator=gen)
        _check_step(metrics, f"warm-up step {i}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    step_ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        _check_step(metrics, f"timed step {i}")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    med = statistics.median(step_ms)
    print(f"[{card}] train step bf16, fused_stage {flag}: step_ms median "
          f"{med:.3f} max {max(step_ms):.3f} (n={steps}), "
          f"{rows / med * 1e3:.1f} frames/s, peak memory {peak_gb:.3f} GB; "
          f"last loss {metrics['loss'].item():.6f} grad_norm "
          f"{metrics['grad_norm'].item():.6f}, update_ok on every step",
          flush=True)
    print(f"train path launches, fused_stage {flag} ({steps} steps): "
          f"{launches}", flush=True)
    stage_kernels = tuple(stage_cuda.launches)
    for name in ("mdct_cuda", *(stage_kernels if fused else ())):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the train path")
    if not fused and any(launches[name] for name in stage_kernels):
        raise AssertionError("a stage kernel ran with fused_stage off")
    if fused and launches["gelu_grn_variants"]["single_read"] == 0:
        raise AssertionError("the single-read GELU+GRN kernel was not "
                             "launched on the train path")
    stats = {"step_ms": med, "peak_gb": peak_gb, "rows": rows}
    return launches, state, step, batch, stats


def check_fused_against_plain(device: torch.device) -> None:
    """One float32 full-width iMF loss and gradient with fused_stage on
    against the same with it off: same weights, batch, noise, t and r."""
    config = load_config(CONFIG)
    objective = create_loss_strategy(config)
    adapter = adapter_from_config(config, create_tokenization_strategy(
        config.tokenization_strategy, config.tokenization_config))
    gen = torch.Generator(device=device).manual_seed(6)
    with torch.no_grad():
        x = adapter.tokenize(synth_audio(4, CLIP_LEN, gen, device))
    noise = torch.randn(x.shape, generator=gen, device=device)
    t, r = objective.time_sampling.sample_time_pair(x.shape[0], gen,
                                                    device=device)
    out = {}
    for fused in (True, False):
        state, _ = train_setup(device, fused=fused, precision="float32")
        loss, _ = objective.loss(state.model, x, noise=noise, t=t, r=r)
        grads = torch.autograd.grad(loss, state.params)
        out[fused] = loss.detach(), torch.cat([g.reshape(-1) for g in grads])
        del state, grads
    (lf, gf), (lp, gp) = out[True], out[False]
    rel_l2 = ((gf - gp).norm() / gp.norm()).item()
    print(f"float32 train step, fused_stage on vs off (4 clips, "
          f"{x.shape[0]} rows, full width, TF32 off): loss {lf.item():.8f} vs "
          f"{lp.item():.8f}, gradient rel_l2 {rel_l2:.3e} "
          f"(loss rtol 1e-4, gradient rel_l2 <= {TRAIN_REL_L2})", flush=True)
    torch.testing.assert_close(lf, lp, rtol=1e-4, atol=0)
    if not rel_l2 <= TRAIN_REL_L2:
        raise AssertionError(f"fused vs plain gradients: rel_l2 {rel_l2}")
    torch.cuda.empty_cache()


def check_train_against_cpu(device: torch.device) -> None:
    """One small-batch float32 fused train step on the card against the same
    step on the CPU (plain versions): loss, grad_norm and Adam's first
    moment (the first update under warmup has lr 0)."""
    gen = torch.Generator().manual_seed(7)
    audio = synth_audio(1, 4096, gen, torch.device("cpu"))
    results = []
    for where in ("cpu", device):
        state, step = train_setup(torch.device(where), fused=True,
                                  precision="float32")
        if not results:
            rows = num_frames_for_length(4096, 512, 256)
            draws = (torch.randn(rows, 1024, generator=gen),
                     *create_loss_strategy(load_config(CONFIG))
                     .time_sampling.sample_time_pair(rows, gen))
        noise, t, r = (d.to(where) for d in draws)
        state, metrics = step(state, audio.to(where), noise=noise, t=t, r=r)
        _check_step(metrics, f"float32 step on {where}")
        results.append((metrics["loss"].cpu(), metrics["grad_norm"].cpu(),
                        torch.cat([m.reshape(-1).cpu() for m in state.mu])))
    (lc, gc, mc), (lg, gg, mg) = results
    rel_l2 = ((mg - mc).norm() / mc.norm()).item()
    print(f"float32 fused train step, card vs CPU on one 4096-sample clip: "
          f"loss {lg.item():.8f} vs {lc.item():.8f}, grad_norm "
          f"{gg.item():.6f} vs {gc.item():.6f}, first-moment rel_l2 "
          f"{rel_l2:.3e} (loss and grad_norm rtol 1e-4, rel_l2 <= "
          f"{TRAIN_REL_L2})", flush=True)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=0)
    torch.testing.assert_close(gg, gc, rtol=1e-4, atol=0)
    if not rel_l2 <= TRAIN_REL_L2:
        raise AssertionError(f"card vs CPU first moments: rel_l2 {rel_l2}")


def _read_wav(path: Path) -> tuple[int, int, int]:
    """(frames, channels, sample rate) of a WAV file."""
    with wave.open(str(path), "rb") as wav:
        return wav.getnframes(), wav.getnchannels(), wav.getframerate()


def _check_trainer_workdir(workdir: Path
                           ) -> tuple[list[dict], dict, dict]:
    """The trainer's records after 32 steps and a resume to 48: 48 step
    records with finite loss and grad_norm and update_ok, the resumed run
    starting at step 32, the retained checkpoints and sidecars, a serving
    file holding the run's EMA, the WAV sample and the summary. Returns the
    step records, the summary and the EMA of step 48."""
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [i for i, r in enumerate(records) if r.get("event") == "start"]
    steps = [r for r in records if "event" not in r]
    if len(starts) != 2 or [r["step"] for r in steps] != list(range(48)):
        raise AssertionError(f"trainer log: start events at {starts}, steps "
                             f"{[r['step'] for r in steps]}")
    if records[starts[1] + 1]["step"] != 32:
        raise AssertionError("the resumed run did not start at step 32")
    bad = [r["step"] for r in steps
           if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                   and r["update_ok"] is True)]
    if bad:
        raise AssertionError(f"trainer steps {bad}: non-finite or rejected")
    ckpt = workdir / "checkpoints"
    names = sorted(p.name for p in ckpt.iterdir())
    want = ["serving_step_00032.msgpack", "serving_step_00048.msgpack",
            "step_00032.metadata.json", "step_00032.msgpack",
            "step_00048.metadata.json", "step_00048.msgpack"]
    if names != want:
        raise AssertionError(f"checkpoints: {names}, expected {want}")
    full = serialization.msgpack_restore(
        (ckpt / "step_00048.msgpack").read_bytes())
    serving = serialization.msgpack_restore(
        (ckpt / "serving_step_00048.msgpack").read_bytes())
    ema = weights.flax_to_torch(full["ema_params"])
    served = weights.flax_to_torch(serving["params"])
    if serving["step"] != 48 or set(ema) != set(served) or not all(
            torch.equal(ema[k], served[k]) for k in ema):
        raise AssertionError("the serving checkpoint is not the run's EMA")
    frames, channels, rate = _read_wav(workdir / "samples" / "step_00048.wav")
    nf = num_frames_for_length(CLIP_LEN, 512, 256)
    if (frames, channels, rate) != ((nf - 1) * 256 + 1024, 2, SAMPLE_RATE):
        raise AssertionError(f"sample WAV: {frames} frames x {channels} at "
                             f"{rate} Hz")
    summary = json.loads((workdir / "summary.json").read_text())
    if not summary.get("steps_per_sec") or not summary.get("flops_per_step"):
        raise AssertionError(f"summary.json: {summary}")
    print(f"trainer workdir: 48 steps logged (resumed at 32), finite loss "
          f"and grad_norm, update_ok on every step; {names}; serving params "
          f"== the run's EMA ({len(ema)} tensors); step_00048.wav {frames} "
          f"frames x {channels}", flush=True)
    return steps, summary, ema


def trainer_path(device: torch.device, card: str, bare: dict,
                 workdir: Path):
    """``python -m meanflow_audio_codec_torch.train --config
    configs/frontier_v2.json`` through ``main``: 32 steps in chunks of 16
    with a checkpoint every 16 and sampling at 32, then ``--resume`` to 48,
    in ``workdir`` (the device pool cut from 1024 clips to 64); returns the
    kernels' launch counts and the run's EMA parameters. Prints the chunk
    time per step, steps/s, frames/s, peak memory, FLOPs, achieved TFLOP/s
    and MFU beside the same for the bare unfused step (``bare``)."""
    args = ["--config", str(CONFIG), "--steps-per-call", "16",
            "--checkpoint-step", "16", "--sample-every", "32",
            "--max-checkpoints-to-keep", "2", "--device-pool-clips", "64",
            "--workdir", str(workdir)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    for extra in (["--n-steps", "32"], ["--resume", "--n-steps", "48"]):
        if train_cli.main(args + extra) != 0:
            raise AssertionError(f"train main {extra} failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    steps, summary, ema = _check_trainer_workdir(workdir)
    print(f"trainer path launches (32 + 16 steps, 2 samplings): {launches}",
          flush=True)
    if launches["mdct_cuda"] < 48 or launches["imdct_cuda"] < 1:
        raise AssertionError("the trainer path did not run the MDCT on every "
                             "step and the IMDCT in its sampling")
    # one step_time per chunk (the chunk's time / 16); after the first chunk
    chunk_ms = [1e3 * steps[i]["step_time"] for i in (0, 16, 32)]
    med = statistics.median(chunk_ms[1:])
    flops = summary["flops_per_step"]
    peak = profiling.peak_flops(device)

    def rates(ms: float) -> str:
        tflops = flops / (ms / 1e3) / 1e12
        mfu = (f"mfu {tflops * 1e12 / peak:.4f}" if peak else
               "mfu not measured (no peak known for this card)")
        return (f"{tflops:.2f} achieved TFLOP/s, {mfu}")

    print(f"[{card}] trainer, bf16, chunks of 16: chunk time per step "
          f"{chunk_ms[0]:.3f} / {chunk_ms[1]:.3f} / {chunk_ms[2]:.3f} ms "
          f"(chunks 1-3; the first includes the start), median after the "
          f"first {med:.3f} ms, {1e3 / med:.3f} steps/s, "
          f"{bare['rows'] / med * 1e3:.1f} frames/s; summary steps_per_sec "
          f"{summary['steps_per_sec']:.3f} (run 2: 16 steps with sampling, "
          f"checkpoints and the resume), wall {wall:.1f} s for both runs; "
          f"peak memory {peak_gb:.3f} GB; {flops / 1e9:.1f} GFLOP per step, "
          f"{rates(med)}", flush=True)
    print(f"[{card}] bare step, same pass (unfused, bf16): step_ms median "
          f"{bare['step_ms']:.3f}, {1e3 / bare['step_ms']:.3f} steps/s, "
          f"{bare['rows'] / bare['step_ms'] * 1e3:.1f} frames/s, peak memory "
          f"{bare['peak_gb']:.3f} GB, {rates(bare['step_ms'])}; trainer "
          f"chunk time per step / bare step = {med / bare['step_ms']:.4f}",
          flush=True)
    return launches, ema


def count_syncs(label: str, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and print
    the host synchronisations inside the train steps, with each call site's
    stack; returns ``fn``'s result and that count."""
    import traceback
    import warnings

    # call site -> count, split by whether the chunk's steps are on the
    # stack (train_step.py) or not (switching the debug mode itself warns)
    sites = {True: collections.Counter(), False: collections.Counter()}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if "warnings" not in f.filename]
            inside = any(f.filename.endswith("train_step.py") for f in stack)
            sites[inside]["; ".join(
                f"{Path(f.filename).name}:{f.lineno} {f.name}"
                for f in stack[-4:])] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    count = sum(sites[True].values())
    print(f"host synchronisations inside {label}: {count}"
          + "".join(f"\n  {n} x {site}" for site, n in sites[True].items())
          + "".join(f"\n  outside the steps: {n} x {site}"
                    for site, n in sites[False].items()), flush=True)
    return out, count


def chunk_probe(device: torch.device, bare: dict) -> int:
    """The trainer's 16-step chunk alone (frontier-v2 config, bf16,
    ``fused_stage`` off, no data thread): its time per step with and
    without the device guard beside the bare step's, a profile of a 2-step
    chunk (device busy share), and the host
    synchronisations inside one chunk, counted by
    ``torch.cuda.set_sync_debug_mode("warn")`` with each call site's
    stack. Returns the count."""
    state, _ = train_setup(device, fused=False, precision="bfloat16")
    config = load_config(CONFIG)
    adapter = adapter_from_config(config, create_tokenization_strategy(
        config.tokenization_strategy, config.tokenization_config))
    run = make_multi_step(create_loss_strategy(config), 16, adapter,
                          skip_nonfinite=True)
    gen = torch.Generator(device).manual_seed(9)
    batches = synth_audio(16 * TRAIN_CLIPS, CLIP_LEN, gen, device).reshape(
        16, TRAIN_CLIPS, CLIP_LEN, 2)
    unguarded = make_multi_step(create_loss_strategy(config), 16, adapter)

    def per_step_ms(chunk) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(state, batches, gen)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / 16

    run(state, batches, gen)  # warm-up (the unguarded chunk runs the
    # same kernels but for the guard's)
    # guarded, unguarded, unguarded, guarded: a drift of the host's speed
    # during the probe weighs on both alike
    times = [per_step_ms(chunk) for chunk in (run, unguarded, unguarded, run)]
    guarded_ms = statistics.mean(times[0::3])
    unguarded_ms = statistics.mean(times[1:3])
    print(f"one 16-step chunk alone (no data thread), guarded / unguarded / "
          f"unguarded / guarded: {' / '.join(f'{t:.3f}' for t in times)} ms "
          f"per step; mean {guarded_ms:.3f} ms with the device guard, "
          f"{unguarded_ms:.3f} ms without ({guarded_ms / unguarded_ms:.4f}x); "
          f"{guarded_ms / bare['step_ms']:.4f} and "
          f"{unguarded_ms / bare['step_ms']:.4f} x the bare step's "
          f"{bare['step_ms']:.3f} ms", flush=True)
    # two steps suffice for the device's busy share; the profiler's own
    # bookkeeping of a 16-step chunk took over a minute
    pair = make_multi_step(create_loss_strategy(config), 2, adapter,
                           skip_nonfinite=True)
    profile("a 2-step chunk of the trainer's step, bf16",
            lambda: pair(state, batches[:2], gen))

    (state, metrics), count = count_syncs(
        "one 16-step chunk", lambda: run(state, batches, gen))
    if not bool(metrics["update_ok"].all()):
        raise AssertionError("a step of the probed chunk was rejected")
    return count



def _bare_steps(state, step, batch, gen, label: str, card: str) -> dict:
    """``OBJ_WARMUP`` then ``OBJ_STEPS`` timed steps of ``step`` on
    ``batch``; the median step ms, the peak memory of the timed steps and
    the last loss. Every step must be finite and accepted."""
    for i in range(OBJ_WARMUP):
        state, metrics = step(state, batch, generator=gen)
        _check_step(metrics, f"{label} warm-up step {i}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(state.device)
    step_ms = []
    for i in range(OBJ_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        _check_step(metrics, f"{label} timed step {i}")
    out = {"step_ms": statistics.median(step_ms),
           "peak_gb": torch.cuda.max_memory_allocated(state.device) / 1e9,
           "loss": metrics["loss"].item()}
    print(f"[{card}] {label}: step_ms median {out['step_ms']:.3f} max "
          f"{max(step_ms):.3f} (n={OBJ_STEPS} after {OBJ_WARMUP} warm-ups), "
          f"peak memory {out['peak_gb']:.3f} GB, last loss {out['loss']:.6f} "
          f"(finite), update_ok on every step", flush=True)
    return out


def objectives_path(device: torch.device, card: str) -> dict:
    """One bare step of each objective and switch of ``OBJECTIVES`` at
    frontier-v2 width (bf16, the config's remat, frontier-v2's batch of 16
    clips x 32768 samples), timed, then, for the flow objectives, one
    sampling pass of the trainer's sampler (Heun for flow matching, the
    dual-time sampler for the mean flows; autoencoders sample nothing) and
    its IMDCT decode. Each objective's launches are counted from 0; returns
    them by path name."""
    paths = {}
    gen = torch.Generator(device=device).manual_seed(12)
    batch = synth_audio(TRAIN_CLIPS, CLIP_LEN, gen, device)
    for label, (fields, fused) in OBJECTIVES.items():
        state, step = train_setup(device, fused=fused, precision="bfloat16",
                                  **fields)
        config = frontier_config("bfloat16", fused, **fields)
        adapter = adapter_from_config(config, create_tokenization_strategy(
            config.tokenization_strategy, config.tokenization_config))
        zero_launches()
        _bare_steps(state, step, batch, gen,
                    f"bare step {label}, bf16, fused_stage "
                    f"{'on' if fused else 'off'}", card)
        sampled = config.method != "autoencoder"
        if sampled:
            with torch.no_grad():
                tokens, gains = adapter.tokenize_with_gain(batch[:2])
                latents = state.model.encode(tokens)
                sampler = (sample if config.method == "flow_matching"
                           else sample_dual_time)
                flat = sampler(state.model, config.noise_dimension, latents,
                               n_steps=2, generator=gen)
                audio = adapter.detokenize_flat(
                    flat, (tokens.shape[0] // 2, tokens.shape[1]),
                    gains=gains)
            torch.cuda.synchronize()
            if not torch.isfinite(audio).all():
                raise AssertionError(f"{label}: non-finite samples")
        launches = read_launches()
        print(f"objective {label} launches ({OBJ_WARMUP + OBJ_STEPS} steps"
              f"{', one 2-step sampling' if sampled else ''}): {launches}",
              flush=True)
        wanted = ["mdct_cuda"] + (["imdct_cuda"] if sampled else [])
        if fused:
            wanted += list(stage_cuda.launches)
        for name in wanted:
            if launches[name] == 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{label} path")
        paths[f"objective_{label}"] = launches
        del state, step
        torch.cuda.empty_cache()
    return paths


def _loss_and_grads(state, objective, x, draws, whole_loss: bool):
    """The objective's loss and its flattened gradient on ``x`` with the
    given draws; the whole loss checkpointed when asked (``tpu.remat``)."""
    def loss_fn():
        return objective.loss(state.model, x, **draws)[0]

    loss = (torch.utils.checkpoint.checkpoint(loss_fn, use_reentrant=False)
            if whole_loss else loss_fn())
    grads = torch.autograd.grad(loss, state.params)
    return loss.detach().cpu(), torch.cat([g.reshape(-1).cpu()
                                           for g in grads])


def _small_batch(device: torch.device, config, gen: torch.Generator):
    """One 4096-sample clip's flat tokens for ``config``."""
    adapter = adapter_from_config(config, create_tokenization_strategy(
        config.tokenization_strategy, config.tokenization_config))
    with torch.no_grad():
        return adapter.tokenize(synth_audio(1, 4096, gen,
                                            torch.device("cpu"))).to(device)


def check_objectives_against_cpu(device: torch.device) -> None:
    """Each objective of ``OBJECTIVES`` in float32 at full width on one
    4096-sample clip: its loss and every gradient on the card against the
    same weights and draws on the CPU (plain versions); loss rtol 1e-4,
    gradient rel_l2 <= ``TRAIN_REL_L2``."""
    for label, (fields, fused) in OBJECTIVES.items():
        config = frontier_config("float32", fused, **fields)
        objective = create_loss_strategy(config)
        gen = torch.Generator().manual_seed(13)
        x = _small_batch(torch.device("cpu"), config, gen)
        out = []
        for where in ("cpu", device):
            state, _ = train_setup(torch.device(where), fused=fused,
                                   precision="float32", **fields)
            if not out:
                draws = objective.draw(state.model, x, gen)
            out.append(_loss_and_grads(
                state, objective, x.to(where),
                {k: v.to(where) for k, v in draws.items()}, False))
            del state
        (lc, gc), (lg, gg) = out
        rel_l2 = ((gg - gc).norm() / gc.norm()).item()
        print(f"float32 {label}, card vs CPU on one 4096-sample clip "
              f"({x.shape[0]} rows): loss {lg.item():.8f} vs "
              f"{lc.item():.8f}, gradient rel_l2 {rel_l2:.3e} (loss rtol "
              f"1e-4, rel_l2 <= {TRAIN_REL_L2})", flush=True)
        torch.testing.assert_close(lg, lc, rtol=1e-4, atol=0)
        if not rel_l2 <= TRAIN_REL_L2:
            raise AssertionError(f"{label} card vs CPU: rel_l2 {rel_l2}")
    torch.cuda.empty_cache()


def remat_path(device: torch.device, card: str) -> dict:
    """The bare iMF step (bf16, full width, frontier-v2's batch) without
    remat, with ``architecture_options.remat`` under ``dots_saveable`` (the
    elementwise segments recomputed) and under policy None (each stage
    recomputed whole) and with ``tpu.remat``, and the ``fused_stage`` step
    without remat: step ms, peak memory and device time of each; then the
    float32 gradients of each unfused setting at one 4096-sample clip, which
    must agree with no remat's (rel_l2 <= ``TRAIN_REL_L2``). Returns the
    launches by path name."""
    paths = {}
    gen = torch.Generator(device=device).manual_seed(14)
    batch = synth_audio(TRAIN_CLIPS, CLIP_LEN, gen, device)
    for label, (options, tpu_remat, fused) in REMAT.items():
        state, step = train_setup(device, fused=fused, precision="bfloat16",
                                  options=options, remat=tpu_remat)
        zero_launches()
        _bare_steps(state, step, batch, gen, f"bare iMF step, remat {label}",
                    card)
        paths[f"remat_{label}"] = read_launches()
        for name in ("mdct_cuda", *(stage_cuda.launches if fused else ())):
            if paths[f"remat_{label}"][name] == 0:
                raise AssertionError(f"{name} was not launched with remat "
                                     f"{label}")
        # device time apart from the host's, which moves between calls
        profile(f"one bf16 iMF step, remat {label}",
                lambda: step(state, batch, generator=gen), top=0)
        del state, step
        torch.cuda.empty_cache()
    config = frontier_config("float32", False)
    objective = create_loss_strategy(config)
    gen = torch.Generator().manual_seed(15)
    x = _small_batch(device, config, gen)
    grads = {}
    for label, (options, tpu_remat, fused) in REMAT.items():
        if fused:
            continue
        state, _ = train_setup(device, fused=False, precision="float32",
                               options=options)
        # the same perturbation in each setting, so that the blocks' layer
        # scales and GRN parameters (zero or 1e-6 at init) carry gradient
        nudge = torch.Generator().manual_seed(16)
        with torch.no_grad():
            for param in state.params:
                param.add_(0.02 * torch.randn(param.shape, generator=nudge)
                           .to(device))
        if not grads:
            draws = objective.draw(state.model, x.cpu(), gen)
            draws = {k: v.to(device) for k, v in draws.items()}
        grads[label] = _loss_and_grads(state, objective, x, draws, tpu_remat)
        del state
    (l0, g0), *others = grads.values()
    for label, (loss, g) in zip(list(grads)[1:], others):
        rel_l2 = ((g - g0).norm() / g0.norm()).item()
        print(f"float32 iMF gradients, remat {label} vs none (one 4096-sample "
              f"clip): loss {loss.item():.8f} vs {l0.item():.8f}, rel_l2 "
              f"{rel_l2:.3e} (<= {TRAIN_REL_L2})", flush=True)
        torch.testing.assert_close(loss, l0, rtol=1e-5, atol=0)
        if not rel_l2 <= TRAIN_REL_L2:
            raise AssertionError(f"remat {label}: gradient rel_l2 {rel_l2}")
    torch.cuda.empty_cache()
    return paths


def qat_trainer_path(device: torch.device, card: str, frontier: Path,
                     scratch: Path) -> dict:
    """Chain stage 2c at full width: the trainer phase's newest checkpoint
    (step 48) and its metadata copied into a fresh workdir, then ``python
    -m meanflow_audio_codec_torch.train --config configs/frontier_v2_qat.json
    --resume`` through ``main`` for 2 chunks of 16 steps (STE through the
    ECSQ 0.5 grid, the config's remat with ``dots_saveable``, the device pool
    cut to 64 clips), sampling at the end; then the run served from its
    workdir, a 10 s clip's latents through the ECSQ 0.5 byte path. Returns
    the launch counts."""
    from meanflow_audio_codec_torch.ops import latent_quant

    workdir = scratch / "qat"
    (workdir / "checkpoints").mkdir(parents=True)
    for name in ("step_00048.msgpack", "step_00048.metadata.json"):
        (workdir / "checkpoints" / name).write_bytes(
            (frontier / "checkpoints" / name).read_bytes())
    config = load_config(QAT_CONFIG)
    if (config.qat_mode, config.qat_step_frac) != ("ste", 0.5) or not (
            config.architecture_options.get("remat")):
        raise AssertionError(f"{QAT_CONFIG.name}: not the STE ECSQ 0.5 QAT "
                             "config with remat")
    args = ["--config", str(QAT_CONFIG), "--workdir", str(workdir),
            "--resume", "--n-steps", "80", "--steps-per-call", "16",
            "--checkpoint-step", "16", "--max-checkpoints-to-keep", "2",
            "--device-pool-clips", "64"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    if train_cli.main(args) != 0:
        raise AssertionError("QAT train main failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    records = read_log(workdir / "logs" / "train_log.jsonl")
    steps = [r for r in records if "event" not in r]
    if [r["step"] for r in steps] != list(range(48, 80)):
        raise AssertionError(f"QAT log steps {[r['step'] for r in steps]}")
    bad = [r["step"] for r in steps
           if not (math.isfinite(r["loss"]) and r["update_ok"] is True)]
    if bad:
        raise AssertionError(f"QAT steps {bad}: non-finite or rejected")
    chunk_ms = [1e3 * steps[i]["step_time"] for i in (0, 16)]
    print(f"[{card}] QAT trainer (frontier_v2_qat.json, resumed from the "
          f"trainer phase's step 48, 2 chunks of 16): chunk time per step "
          f"{chunk_ms[0]:.3f} / {chunk_ms[1]:.3f} ms (the first includes the "
          f"start), peak memory {peak_gb:.3f} GB, wall {wall:.1f} s; "
          f"update_ok on every step (32 of 32), last loss "
          f"{steps[-1]['loss']:.6f}", flush=True)
    print(f"QAT trainer path launches: {launches}", flush=True)
    if launches["mdct_cuda"] < 32 or launches["imdct_cuda"] < 1:
        raise AssertionError("the QAT trainer did not run the MDCT on every "
                             "step and the IMDCT in its sampling")

    codec = AudioCodec.from_workdir(workdir)
    clip = synth_audio(1, 10 * SAMPLE_RATE,
                       torch.Generator(device).manual_seed(16), device)
    latents, gains = codec.encode_with_gains(clip)
    data = codec.encode_bytes(clip, step_frac=0.5)
    stream = latent_quant.unpack_bitstream(data).to(device)
    restored = latent_quant.dequantize_latents(stream)
    err = (restored - latents.float()).abs()
    slack = (0.5 * stream.scale + 1e-5 * latents.float().abs().max())
    recon = codec.decode_bytes(data,
                               generator=torch.Generator(device).manual_seed(4))
    window, hop = codec.adapter.strategy.config.window_size, codec._hop
    nf = num_frames_for_length(clip.shape[1], window, hop)
    print(f"QAT run served: 10 s clip, {len(data)} bytes "
          f"({len(data) * 8 / 10 / 1000:.1f} kbps, ECSQ step_frac 0.5, "
          f"{latent_quant.describe_bitstream(data)['coding']}); latents "
          f"from bytes within half a step of the encoder's (max error "
          f"{err.max().item():.4e}); decode {tuple(recon.shape)}", flush=True)
    if not bool((err <= slack).all()):
        raise AssertionError("QAT run: latents from bytes off by more than "
                             "half a quantizer step")
    if (tuple(recon.shape) != (1, (nf - 1) * hop + 2 * window, 2)
            or not torch.isfinite(recon).all()):
        raise AssertionError(f"QAT run decode: {tuple(recon.shape)}")
    return launches


def _wall_ms(fn, repeats: int) -> tuple[float, object]:
    """Median host milliseconds of ``fn`` ended by a synchronise, and its
    last result."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def _same_weights(codec: AudioCodec, params: dict, what: str) -> None:
    got = codec.model.state_dict()
    if set(got) != set(params) or not all(
            torch.equal(got[k].cpu(), params[k].cpu()) for k in params):
        raise AssertionError(f"the codec from {what} does not serve the "
                             "run's EMA")


def codec_path(device: torch.device, card: str, workdir: Path,
               ema: dict, scratch: Path):
    """Serve the trainer phase's workdir (``AudioCodec.from_workdir``) and a
    copy of it holding only ``serving_step_00048.msgpack``; both must serve
    the run's EMA. Then a 10 s 44.1 kHz stereo clip through
    ``encode_bytes`` -> ``decode_bytes`` in each stored format, checking the
    rANS coding, in-memory == from-bytes decode, the output length and a
    reproducible default decode, and timing the pieces; then the codec CLI
    (encode, info, decode) on a 48 kHz WAV. Returns the launch counts of the
    bytes path and of the CLI, and the served codec."""
    from meanflow_audio_codec_torch.data.audio import write_wav
    from meanflow_audio_codec_torch.ops import latent_quant
    from meanflow_audio_codec_torch.tools import codec_cli

    t0 = time.perf_counter()
    codec = AudioCodec.from_workdir(workdir)
    load_s = time.perf_counter() - t0
    _same_weights(codec, ema, "step_00048.msgpack")
    serving = scratch / "serving_only"
    (serving / "checkpoints").mkdir(parents=True)
    (serving / "config.json").write_bytes(
        (workdir / "config.json").read_bytes())
    name = "serving_step_00048.msgpack"
    (serving / "checkpoints" / name).write_bytes(
        (workdir / "checkpoints" / name).read_bytes())
    window, hop = codec.adapter.strategy.config.window_size, codec._hop
    t0 = time.perf_counter()
    _same_weights(AudioCodec.from_workdir(serving), ema, name)
    print(f"codec: from_workdir served step_00048.msgpack's EMA "
          f"({load_s:.1f} s) and, from a copy holding only {name}, the same "
          f"weights ({time.perf_counter() - t0:.1f} s)", flush=True)

    clip = synth_audio(1, 10 * SAMPLE_RATE,
                       torch.Generator(device).manual_seed(10), device)
    seconds = clip.shape[1] / SAMPLE_RATE
    nf = num_frames_for_length(clip.shape[1], window, hop)
    expected = (1, (nf - 1) * hop + 2 * window, 2)
    for kwargs in FORMATS.values():  # warm-up: plans and the coder's build
        codec.decode_bytes(codec.encode_bytes(clip, **kwargs))
    torch.cuda.synchronize()

    zero_launches()
    for label, kwargs in FORMATS.items():
        enc_ms, (latents, gains) = _wall_ms(
            lambda: codec.encode_with_gains(clip), BYTES_REPEATS)
        pack_ms, data = _wall_ms(lambda: latent_quant.pack_bitstream(
            codec.quantize(latents, gains, **kwargs)), BYTES_REPEATS)
        bytes_ms, data = _wall_ms(lambda: codec.encode_bytes(clip, **kwargs),
                                  BYTES_REPEATS)
        gen = torch.Generator(device)
        dec_ms, recon = _wall_ms(lambda: codec.decode_bytes(
            data, generator=gen.manual_seed(4)), BYTES_REPEATS)
        header = latent_quant.describe_bitstream(data)
        if header["coding"] != "rANS":
            raise AssertionError(f"{label}: stored {header['coding']}, not "
                                 "rANS-coded")
        in_memory = codec.decode_packed(codec.encode_packed(clip, **kwargs),
                                        generator=gen.manual_seed(4))
        if not torch.equal(in_memory, recon):
            raise AssertionError(f"{label}: decode_packed != decode_bytes")
        if tuple(recon.shape) != expected or not torch.isfinite(recon).all():
            raise AssertionError(f"{label}: output {tuple(recon.shape)} "
                                 f"(expected {expected}) or not finite")
        kbps = len(data) * 8 / seconds / 1000.0
        print(f"[{card}] codec bytes, 10 s clip, {label}: device encode "
              f"{enc_ms:.3f} ms, quantize + device-to-host + rANS "
              f"{pack_ms:.3f} ms, encode_bytes {bytes_ms:.3f} ms, "
              f"decode_bytes {dec_ms:.3f} ms (medians of {BYTES_REPEATS}); "
              f"{len(data)} bytes = {kbps:.1f} kbps stored (v1 nominal "
              f"at {header['bits']} bits "
              f"{codec.bitrate_kbps(header['bits']):.1f} kbps; seeded "
              f"weights: a rate, not a quality figure); {header['coding']}, "
              f"in-memory == from-bytes decode", flush=True)
    launches = read_launches()
    print(f"codec bytes path launches (3 formats x {BYTES_REPEATS} encodes, "
          f"encode_bytes and decode_bytes, + 3 in-memory checks): "
          f"{launches}", flush=True)
    latents = codec.encode(clip)
    if not torch.equal(codec.decode(latents), codec.decode(latents)):
        raise AssertionError("decode(x) twice gave different audio")
    print("codec: decode(x) twice without a generator gives equal audio",
          flush=True)

    wav, macb, out = (scratch / "in_48k.wav", scratch / "in.macb",
                      scratch / "out.wav")
    at_48k = synth_audio(1, 10 * 48000, torch.Generator().manual_seed(11),
                         torch.device("cpu"))
    write_wav(wav, at_48k[0].numpy(), sample_rate=48000)
    zero_launches()
    for argv in (["encode", str(wav), "--workdir", str(serving), "-o",
                  str(macb)], ["info", str(macb)],
                 ["decode", str(macb), "--workdir", str(serving), "-o",
                  str(out)]):
        if codec_cli.main(argv) != 0:
            raise AssertionError(f"codec_cli {argv[0]} failed")
    cli_launches = read_launches()
    frames, channels, rate = _read_wav(out)
    nf_cli = num_frames_for_length(10 * SAMPLE_RATE, window, hop)
    if (frames, channels, rate) != ((nf_cli - 1) * hop + 2 * window, 2,
                                    SAMPLE_RATE):
        raise AssertionError(f"codec_cli decode: {frames} x {channels} at "
                             f"{rate} Hz")
    print(f"codec_cli encode -> info -> decode on a 48 kHz WAV: "
          f"{frames} frames x {channels} at {rate} Hz; launches "
          f"{cli_launches}", flush=True)
    for path, counts in (("bytes", launches), ("CLI", cli_launches)):
        for kernel in ("mdct_cuda", "imdct_cuda"):
            if counts[kernel] == 0:
                raise AssertionError(f"{kernel} was not launched on the "
                                     f"codec {path} path")
    return launches, cli_launches, codec


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    diff = (got.float() - ref.float())
    return (diff.abs().max().item(),
            (diff.norm() / ref.float().norm()).item())


def streaming_path(device: torch.device, card: str, codec: AudioCodec):
    """The 10 s clip through ``StreamingCodec`` in chunks of 4096 samples
    (16 frames); checks the streaming encoder against batch ``encode`` and
    the streaming decoder under two chunkings (16 and 64 frames). Returns
    the launch counts of the duplex run."""
    from meanflow_audio_codec_torch.streaming import (
        StreamingDecoder,
        StreamingEncoder,
    )

    clip = synth_audio(1, 10 * SAMPLE_RATE,
                       torch.Generator(device).manual_seed(12), device)
    seconds = clip.shape[1] / SAMPLE_RATE
    full = clip.shape[1] // STREAM_CHUNK * STREAM_CHUNK

    def duplex_run():
        duplex = codec.streaming(seed=0)
        push_ms, outs = [], []
        for i in range(0, full, STREAM_CHUNK):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(duplex.push(clip[:, i:i + STREAM_CHUNK]))
            torch.cuda.synchronize()
            push_ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(duplex.flush(clip[:, full:]))
        torch.cuda.synchronize()
        return push_ms, torch.cat(outs, dim=1)

    duplex_run()  # warm-up: plans at the chunk's row counts
    zero_launches()
    t0 = time.perf_counter()
    push_ms, out = duplex_run()
    total_s = time.perf_counter() - t0
    launches = read_launches()
    window, hop = codec.adapter.strategy.config.window_size, codec._hop
    nf = num_frames_for_length(clip.shape[1], window, hop)
    if (tuple(out.shape) != (1, (nf - 1) * hop + 2 * window, 2)
            or not torch.isfinite(out).all()):
        raise AssertionError(f"streaming output {tuple(out.shape)}")
    chunk_ms = STREAM_CHUNK / SAMPLE_RATE * 1e3
    print(f"[{card}] streaming, 10 s clip in {len(push_ms)} pushes of "
          f"{STREAM_CHUNK} samples: push median "
          f"{statistics.median(push_ms):.3f} ms, max {max(push_ms):.3f} ms "
          f"({chunk_ms:.1f} ms of audio each); whole stream "
          f"{total_s * 1e3:.1f} ms, "
          f"real-time factor {total_s / seconds:.5f}; latency "
          f"{codec.streaming().latency_samples} samples; launches "
          f"{launches}", flush=True)
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] == 0:
            raise AssertionError(f"{kernel} was not launched on the "
                                 "streaming path")
    duplex = codec.streaming(seed=0)
    duplex.push(clip[:, :STREAM_CHUNK])  # past the lookahead
    profile(f"4 streaming pushes of {STREAM_CHUNK} samples",
            lambda: [duplex.push(clip[:, i:i + STREAM_CHUNK]) for i in
                     range(STREAM_CHUNK, 5 * STREAM_CHUNK, STREAM_CHUNK)])

    latents, gains = codec.encode_with_gains(clip)
    enc = StreamingEncoder(codec)
    parts = [enc.push(clip[:, i:i + STREAM_CHUNK])
             for i in range(0, full, STREAM_CHUNK)]
    streamed = torch.cat(parts + [enc.flush(clip[:, full:])], dim=1)
    enc_err = _rel_l2(streamed, latents)

    def decode(step: int) -> torch.Tensor:
        dec = StreamingDecoder(codec, seed=1)
        outs = [dec.push(latents[:, i:i + step], gains=gains[:, i:i + step])
                for i in range(0, latents.shape[1], step)]
        return torch.cat(outs + [dec.flush()], dim=1)

    dec_err = _rel_l2(decode(16), decode(64))
    print(f"streaming vs batch on the card (bf16 compute): latents max_abs_err "
          f"{enc_err[0]:.3e} rel_l2 {enc_err[1]:.3e}; decode in 16- vs "
          f"64-frame chunks max_abs_err {dec_err[0]:.3e} rel_l2 "
          f"{dec_err[1]:.3e} (rel_l2 <= {STREAM_REL_L2})", flush=True)
    if not (enc_err[1] <= STREAM_REL_L2 and dec_err[1] <= STREAM_REL_L2):
        raise AssertionError("streaming disagrees with batch")
    return launches


@contextlib.contextmanager
def timed_checkpoint_writes():
    """Time every checkpoint the trainer writes (the full ``step_N``
    checkpoint with its sidecar, and the serving file): yields a list that
    fills with (file name, seconds, bytes)."""
    from meanflow_audio_codec_torch.training import checkpoints

    writes: list[tuple[str, float, int]] = []
    names = ("save_checkpoint_with_metadata", "save_serving_checkpoint")
    real = {name: getattr(checkpoints, name) for name in names}

    def timed(name):
        def write(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = Path(real[name](*args, **kwargs))
            writes.append((path.name, time.perf_counter() - t0,
                           path.stat().st_size))
            return path
        return write

    for name in names:
        setattr(checkpoints, name, timed(name))
    try:
        yield writes
    finally:
        for name in names:
            setattr(checkpoints, name, real[name])


def _print_writes(writes: list, label: str) -> None:
    for name, seconds, size in writes:
        print(f"checkpoint write ({label}): {name} {size / 1e6:.1f} MB in "
              f"{seconds:.3f} s ({size / 1e6 / seconds:.1f} MB/s; device "
              f"to host, msgpack and the file)", flush=True)


def make_test_corpus(root: Path) -> Path:
    """``tools/make_corpus`` into ``root``: ``CORPUS_FLAC`` FLAC clips of
    the mixed family (seed 0) and ``CORPUS_WAV`` WAV clips (seed 1), 4.46 s
    each, a mixed-container corpus the native loader reads whole."""
    from meanflow_audio_codec_torch.tools.make_corpus import make_corpus

    t0 = time.perf_counter()
    files = (make_corpus(root, "mixed", CORPUS_FLAC, CORPUS_SECONDS, "flac",
                         seed=0)
             + make_corpus(root, "mixed", CORPUS_WAV, CORPUS_SECONDS, "wav",
                           seed=1))
    mb = sum(p.stat().st_size for p in files) / 1e6
    print(f"corpus: make_corpus wrote {CORPUS_FLAC} FLAC + {CORPUS_WAV} WAV "
          f"clips of {CORPUS_SECONDS} s (mixed family), {mb:.1f} MB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return root


def loader_rates(corpus: Path, config) -> float:
    """``build_audio_pipeline`` over ``corpus`` at the config's batch and
    frame: the native loader with 2 producer threads (as the trainer builds
    it) and the Python stages (``native=False``), ``LOADER_BATCHES`` batches
    each after a first; returns the native loader's clips per second."""
    from meanflow_audio_codec_torch.data import native as native_mod
    from meanflow_audio_codec_torch.data.audio import build_audio_pipeline

    frame, batch = config.tokenization_config["frame_size"], config.batch_size
    nf = num_frames_for_length(frame, 512, 256)
    rates = {}
    for label, native in (("native, 2 threads", None),
                          ("Python stages", False)):
        pipeline = build_audio_pipeline(corpus, seed=config.seed,
                                        frame_size=frame, batch_size=batch,
                                        native=native)
        try:
            if isinstance(pipeline, native_mod.NativeAudioLoader) != (
                    native is None):
                raise AssertionError(f"loader ({label}): routed to "
                                     f"{type(pipeline).__name__}")
            next(pipeline)  # the first batch waits for the first decodes
            t0 = time.perf_counter()
            for _ in range(LOADER_BATCHES):
                out = next(pipeline)
            seconds = time.perf_counter() - t0
            skipped = (f", files_skipped {pipeline.files_skipped}"
                       if native is None else "")
            if native is None and pipeline.files_skipped:
                raise AssertionError(f"the loader skipped "
                                     f"{pipeline.files_skipped} files")
        finally:
            pipeline.close()
        if out.shape != (batch, frame, 2) or not bool(
                torch.from_numpy(out).isfinite().all()):
            raise AssertionError(f"loader ({label}): batch {out.shape}")
        rates[label] = LOADER_BATCHES * batch / seconds
        print(f"loader ({label}): {LOADER_BATCHES} batches of {batch} x "
              f"{frame} x 2 in {seconds:.3f} s: "
              f"{LOADER_BATCHES / seconds:.2f} batches/s, "
              f"{rates[label]:.1f} clips/s, {rates[label] * nf:.1f} MDCT "
              f"frames/s{skipped}", flush=True)
    return rates["native, 2 threads"]


def _corpus_config():
    """configs/corpus_rehearsal.json, checked to be the full-width bf16
    config whose runs save and sample only at their end."""
    config = load_config(CORPUS_CONFIG)
    options = config.architecture_options
    width = (options["channels"], options["bottleneck_dim"],
             options["lift_channels"], options["spatial"], config.num_blocks,
             config.latent_dimension)
    if (width != (512, 1024, 64, 8, 8, 256) or config.precision != "bfloat16"
            or config.steps_per_call != 16 or config.checkpoint_step < 48
            or config.sample_every < 48):
        raise AssertionError(f"{CORPUS_CONFIG.name}: width {width}, "
                             f"{config.precision}, chunks of "
                             f"{config.steps_per_call}")
    return config


def corpus_trainer_path(device: torch.device, card: str, corpus: Path,
                        workdir: Path, loader_clips_s: float):
    """``python -m meanflow_audio_codec_torch.train --config
    configs/corpus_rehearsal.json --data-dir <corpus>`` through ``main`` at
    full width (bf16, chunks of 16, the device pool cut from 1024 clips to
    64): 32 steps, then ``--resume`` to 48, each run saving and sampling
    once, at its end. Returns the launch counts, the run's EMA and its chunk
    time per step."""
    config = _corpus_config()
    args = ["--config", str(CORPUS_CONFIG), "--data-dir", str(corpus),
            "--device-pool-clips", "64", "--workdir", str(workdir)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    with timed_checkpoint_writes() as writes:
        for extra in (["--n-steps", "32"], ["--resume", "--n-steps", "48"]):
            if train_cli.main(args + extra) != 0:
                raise AssertionError(f"corpus train main {extra} failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    steps, summary, ema = _check_trainer_workdir(workdir)
    counts = {r.get("param_count") for r in read_log(
        workdir / "logs" / "train_log.jsonl") if r.get("event") == "start"}
    if counts != {CORPUS_PARAMS}:
        raise AssertionError(f"corpus trainer: {counts} parameters, "
                             f"expected {CORPUS_PARAMS}")
    print(f"corpus trainer path launches (32 + 16 steps, 2 samplings): "
          f"{launches}", flush=True)
    if launches["mdct_cuda"] < 48 or launches["imdct_cuda"] < 1:
        raise AssertionError("the corpus trainer did not run the MDCT on "
                             "every step and the IMDCT in its sampling")
    chunk_ms = [1e3 * steps[i]["step_time"] for i in (0, 16, 32)]
    med = statistics.median(chunk_ms[1:])
    rows = config.batch_size * num_frames_for_length(CLIP_LEN, 512, 256)
    flops = summary["flops_per_step"]
    peak = profiling.peak_flops(device)
    tflops = flops / (med / 1e3) / 1e12
    mfu = (f"mfu {tflops * 1e12 / peak:.4f}" if peak else
           "mfu not measured (no peak known for this card)")
    step_clips_s = config.batch_size * 1e3 / med
    print(f"[{card}] corpus trainer (corpus_rehearsal.json, "
          f"{CORPUS_PARAMS} params, bf16, chunks of 16, device pool 64 "
          f"clips): chunk time per step {chunk_ms[0]:.3f} / "
          f"{chunk_ms[1]:.3f} / {chunk_ms[2]:.3f} ms (chunks 1-3; the first "
          f"includes the start), median after the first {med:.3f} ms, "
          f"{1e3 / med:.3f} steps/s, {rows / med * 1e3:.1f} frames/s; wall "
          f"{wall:.1f} s for both runs; peak memory {peak_gb:.3f} GB; "
          f"{flops / 1e9:.1f} GFLOP per step, {tflops:.2f} achieved "
          f"TFLOP/s, {mfu}", flush=True)
    print(f"[{card}] loader against the step: the native loader sustains "
          f"{loader_clips_s:.1f} clips/s, the step consumes "
          f"{step_clips_s:.1f} clips/s ({loader_clips_s / step_clips_s:.2f}x)",
          flush=True)
    _print_writes(writes, "corpus trainer")
    if len(writes) != 4:
        raise AssertionError(f"corpus trainer wrote {len(writes)} "
                             "checkpoints, expected 2 runs x (full, serving)")
    return launches, ema, med


def corpus_exact_stream_path(device: torch.device, card: str, corpus: Path,
                             workdir: Path, pooled_ms: float) -> dict:
    """The same config without the device pool (``--device-pool-clips 0``,
    the JAX package's default for a corpus: host batches go to the card
    every chunk): 32 steps, the host synchronisations inside the second
    chunk counted. Returns the launch counts."""
    from meanflow_audio_codec_torch.training import trainer as trainer_mod

    real = trainer_mod.make_multi_step
    calls, syncs = [0], []

    def counted(*args, **kwargs):
        chunk = real(*args, **kwargs)

        def run(*a, **kw):
            calls[0] += 1
            if calls[0] != 2:
                return chunk(*a, **kw)
            out, count = count_syncs("one 16-step chunk of the exact stream",
                                     lambda: chunk(*a, **kw))
            syncs.append(count)
            return out
        return run

    args = ["--config", str(CORPUS_CONFIG), "--data-dir", str(corpus),
            "--device-pool-clips", "0", "--n-steps", "32", "--workdir",
            str(workdir)]
    trainer_mod.make_multi_step = counted
    zero_launches()
    try:
        with timed_checkpoint_writes() as writes:
            if train_cli.main(args) != 0:
                raise AssertionError("exact-stream train main failed")
    finally:
        trainer_mod.make_multi_step = real
    launches = read_launches()
    steps = [r for r in read_log(workdir / "logs" / "train_log.jsonl")
             if "event" not in r]
    if [r["step"] for r in steps] != list(range(32)) or not all(
            math.isfinite(r["loss"]) and r["update_ok"] is True
            for r in steps):
        raise AssertionError("exact stream: steps missing, non-finite or "
                             "rejected")
    summary = json.loads((workdir / "summary.json").read_text())
    if "pool_skipped_refreshes" in summary:
        raise AssertionError("the exact stream ran through a device pool")
    chunk_ms = [1e3 * steps[i]["step_time"] for i in (0, 16)]
    print(f"[{card}] corpus exact stream (no device pool): chunk time per "
          f"step {chunk_ms[0]:.3f} / {chunk_ms[1]:.3f} ms (chunks 1-2; the "
          f"first includes the start) against {pooled_ms:.3f} ms with the "
          f"pool ({chunk_ms[1] / pooled_ms:.4f}x)", flush=True)
    _print_writes(writes, "exact stream")
    print(f"corpus exact stream path launches (32 steps, 1 sampling): "
          f"{launches}", flush=True)
    if launches["mdct_cuda"] < 32 or launches["imdct_cuda"] < 1:
        raise AssertionError("the exact stream did not run the MDCT on "
                             "every step and the IMDCT in its sampling")
    if syncs != [0]:
        raise AssertionError(f"exact stream: host synchronisations inside "
                             f"a chunk: {syncs}")
    return launches


def corpus_serving_path(device: torch.device, card: str, workdir: Path,
                        corpus: Path, ema: dict, scratch: Path) -> dict:
    """Serve the corpus run: ``AudioCodec.from_workdir`` (the run's EMA,
    ``CORPUS_PARAMS`` parameters), the codec CLI (encode, info, decode) on
    one FLAC clip of the corpus, and ``encode_bytes`` / ``decode_bytes`` of
    a 10 s clip as MACB v1 8-bit, timed. Returns the launch counts."""
    from meanflow_audio_codec_torch.data.audio import load_audio_file
    from meanflow_audio_codec_torch.tools import codec_cli

    zero_launches()
    codec = AudioCodec.from_workdir(workdir)
    _same_weights(codec, ema, "step_00048.msgpack")
    n_params = sum(p.numel() for p in codec.model.parameters())
    if n_params != CORPUS_PARAMS:
        raise AssertionError(f"served corpus model: {n_params} parameters")
    window, hop = codec.adapter.strategy.config.window_size, codec._hop
    clip = sorted(corpus.glob("*.flac"))[0]
    length = load_audio_file(clip).shape[1]
    macb, out = scratch / "corpus.macb", scratch / "corpus_out.wav"
    for argv in (["encode", str(clip), "--workdir", str(workdir), "-o",
                  str(macb)], ["info", str(macb)],
                 ["decode", str(macb), "--workdir", str(workdir), "-o",
                  str(out)]):
        if codec_cli.main(argv) != 0:
            raise AssertionError(f"codec_cli {argv[0]} on {clip.name} failed")
    decoded = load_audio_file(out)
    nf = num_frames_for_length(length, window, hop)
    if decoded.shape != (2, (nf - 1) * hop + 2 * window) or not bool(
            torch.from_numpy(decoded).isfinite().all()):
        raise AssertionError(f"codec_cli on {clip.name}: {decoded.shape}")
    print(f"corpus run served: from_workdir gave the run's EMA "
          f"({n_params} params); codec_cli encode -> info -> decode on "
          f"{clip.name} ({length} samples): {decoded.shape[1]} samples x 2, "
          f"finite", flush=True)

    audio = synth_audio(1, 10 * SAMPLE_RATE,
                        torch.Generator(device).manual_seed(12), device)
    codec.decode_bytes(codec.encode_bytes(audio, bits=8))  # warm-up
    enc_ms, data = _wall_ms(lambda: codec.encode_bytes(audio, bits=8),
                            BYTES_REPEATS)
    gen = torch.Generator(device)
    dec_ms, recon = _wall_ms(lambda: codec.decode_bytes(
        data, generator=gen.manual_seed(4)), BYTES_REPEATS)
    nf = num_frames_for_length(audio.shape[1], window, hop)
    if (tuple(recon.shape) != (1, (nf - 1) * hop + 2 * window, 2)
            or not torch.isfinite(recon).all()):
        raise AssertionError(f"corpus codec bytes: {tuple(recon.shape)}")
    print(f"[{card}] corpus codec bytes, 10 s clip, v1 8-bit: encode_bytes "
          f"{enc_ms:.3f} ms, decode_bytes {dec_ms:.3f} ms (medians of "
          f"{BYTES_REPEATS}), {len(data)} bytes = "
          f"{len(data) * 8 / 10 / 1000:.1f} kbps stored (seeded weights "
          f"after 48 steps: a rate, not a quality figure)", flush=True)
    launches = read_launches()
    print(f"corpus serving path launches: {launches}", flush=True)
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] == 0:
            raise AssertionError(f"{kernel} was not launched on the corpus "
                                 "serving path")
    return launches


def corpus_phase(device: torch.device, card: str, scratch: Path) -> dict:
    """The corpus phase: a corpus from ``make_corpus``, the loader's rates,
    the full-width corpus trainer, its exact stream and serving the run;
    returns the launch counts of the three corpus paths."""
    corpus = make_test_corpus(scratch / "corpus")
    loader_clips_s = loader_rates(corpus, _corpus_config())
    paths = {}
    workdir = scratch / "corpus_run"
    paths["corpus_trainer"], ema, pooled_ms = corpus_trainer_path(
        device, card, corpus, workdir, loader_clips_s)
    torch.cuda.empty_cache()
    paths["corpus_exact_stream"] = corpus_exact_stream_path(
        device, card, corpus, scratch / "corpus_exact", pooled_ms)
    torch.cuda.empty_cache()
    paths["corpus_serving"] = corpus_serving_path(device, card, workdir,
                                                  corpus, ema, scratch)
    for label, counts in paths.items():
        stage_counts = {k: counts[k] for k in stage_cuda.launches}
        print(f"{label}: stage kernel launches {stage_counts} (fused_stage "
              "is off in the config: 0 expected)", flush=True)
    return paths


def profile(label: str, fn, top: int = 15) -> None:
    """Device time by kernel (the ``top`` kernels) for one call of ``fn``,
    and the device's busy share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"profile of {label}: no device time recorded (not measured)",
              flush=True)
        return
    print(f"profile of {label}: {len(kernels)} kernel names, device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall under the profiler "
          f"({100 * busy_ms / wall_ms:.1f}% busy)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count:<4d} "
              f"{e.key[:100]}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--transforms-only", action="store_true",
                        help="phases 1-3 for the MDCT and IMDCT alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    # the CUDA sources and the rANS coder (g++), all compilers at once
    logs = _build.build(("mdct", "imdct") if args.transforms_only
                        else _build.SOURCES + tuple(_build.HOST_SOURCES))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'cached'})", flush=True)
    for name, log in logs.items():
        kernel = ""
        for line in log.splitlines():
            entry = re.search(r"entry function '\w*?\d([a-z_]+_kernel\w*?)E[vP]",
                              line)
            if entry:
                kernel = entry.group(1)
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name} {kernel}: {line.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    if args.transforms_only:
        print(json.dumps({"transforms": check_kernels(device)}), flush=True)
        return 0
    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        """Print the seconds since the last lap (the smoke's own budget)."""
        now = time.perf_counter()
        print(f"phase time, {phase}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    sass_profile()
    results = {**check_kernels(device)}
    lap("transforms")
    results.update(check_stage_kernels(device))
    lap("stage kernels")
    paths = {}
    paths["roundtrip"], codec, requests = roundtrip_path(device, card)
    lap("round trip")
    paths["train"], state, step, batch, _ = train_path(device, card)
    profile("one bf16 train step, 16 clips x 32768",
            lambda: step(state, batch,
                         generator=torch.Generator(device).manual_seed(8)))
    del state, step, batch
    torch.cuda.empty_cache()
    _, state, step, batch, bare = train_path(device, card, fused=False,
                                             steps=5)
    profile("one bf16 train step, fused_stage off",
            lambda: step(state, batch,
                         generator=torch.Generator(device).manual_seed(8)))
    del state, step, batch
    torch.cuda.empty_cache()
    lap("train steps")
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp) / "run"
        paths["trainer"], ema = trainer_path(device, card, bare, workdir)
        torch.cuda.empty_cache()
        lap("trainer")
        paths["codec_bytes"], paths["codec_cli"], served = codec_path(
            device, card, workdir, ema, Path(tmp))
        del ema
        lap("codec")
        paths["qat_trainer"] = qat_trainer_path(device, card, workdir,
                                                Path(tmp))
        torch.cuda.empty_cache()
        lap("QAT trainer")
    paths["streaming"] = streaming_path(device, card, served)
    del served
    torch.cuda.empty_cache()
    lap("streaming")
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(corpus_phase(device, card, Path(tmp)))
    torch.cuda.empty_cache()
    lap("corpus")
    chunk_probe(device, bare)
    torch.cuda.empty_cache()
    lap("chunk probe")
    paths.update(objectives_path(device, card))
    lap("objectives")
    paths.update(remat_path(device, card))
    lap("remat")
    check_fused_against_plain(device)
    check_against_cpu(device)
    check_train_against_cpu(device)
    check_objectives_against_cpu(device)
    profile("one round trip, 4 clips x 32768",
            lambda: codec.roundtrip(
                requests["4 clips x 32768"],
                generator=torch.Generator(device).manual_seed(3)))
    lap("float32 checks")

    results["gelu_grn_cuda"]["launches_by_kernel"] = {
        variant: sum(p["gelu_grn_variants"][variant] for p in paths.values())
        for variant in stage_cuda.gelu_grn_variants}
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=sum(p[name] for p in paths.values()),
                    launches_by_path={k: p[name] for k, p in paths.items()},
                    **results[name])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
