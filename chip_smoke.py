#!/usr/bin/env python3
"""Drive the PyTorch port of the codec on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --transforms-only   # phases 1-3 for MDCT/IMDCT
    python3 chip_smoke.py --jvp-tape   # the build, then the tape probe
    python3 chip_smoke.py --parallel-only   # the build, then phase 15
    python3 chip_smoke.py --orbax-only   # the build, then phase 16
    python3 chip_smoke.py --interfaces-only   # the build, then phase 17
    python3 chip_smoke.py --proj-only   # the build, then phase 18

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from meanflow_audio_codec_torch/csrc (nvcc),
     the rANS coder from native/entropy.cpp, the audio loader from
     native/dataloader.cpp and the zstd decoder from csrc/zstd.cpp (g++),
     all sources at once,
     and print the build seconds, the ptxas report and
     the instruction mix of the MDCT's, IMDCT's and single-read GELU+GRN's
     main loops (cuobjdump);
  3. hold each kernel against its plain PyTorch version (TF32 off): the
     MDCT/IMDCT at the codec shape (8 rows x 32768 samples, W=512, hop 256),
     a ragged shape (3 rows, W=576, hop 100) and the 10 s clip shape (2 rows
     x 441000 samples, 1721 frames), and both at the train shape (the
     step's tokenize, 32 rows x 32768 samples, and the trainer's sampling
     decode of its 16 clips, [32, 127, 512]), a streaming push's (2
     rows x 4864 samples), the MLP codec's tokenize (256 rows x 65536
     samples) and decode ([256, 255, 512]), mnist + mdct's (128 rows x 784
     pixels: 2 frames), the matrix smoke's (8 rows x 512 samples, W
     256, hop 128), the timing tools' codec geometry (32 rows x 480000
     samples, W 576, hop 288) and the audio autoencoder trial's (16 rows x
     16384 samples, W 256, hop 128), rtol 1e-4 / atol 1e-3; the
     three stage kernels at the train shape (2032 rows x 64 positions x 256
     or 512 channels), benchmark_conv_mfu's ch512 rows (2048 x 64 x 512 or
     1024) and ragged shapes, in bf16 and f32, with the stage
     ops' forward-AD tangents, gradients and grad-of-JVP (reverse mode
     through the tangent) against plain-op autograd, and
     both GELU+GRN kernels (single read at those shapes, two pass at a
     longer P); and time each kernel, its plain version and one library
     call (where one exists) with CUDA events, the MDCT and IMDCT at the
     10 s and train shapes too, and the two-pass GELU+GRN
     at the train shape beside the single read; then the MDCT and IMDCT
     kernels and their plain versions at the codec shape again, in turns
     (7 rounds of one batch each, ``ms_alternating``);
  3a. gradients through the transform kernels: ``x.grad`` through
     ``mdct_cuda`` and ``imdct_cuda`` at the codec shape against the plain
     version's autograd (rtol 1e-4 / atol 1e-3), each backward launching
     the other kernel, backward ms beside forward ms; then
     ``MDCTLayer -> IMDCTLayer`` with a finite gradient (a path: its
     launches are counted);
  4. the served path: ``AudioCodec.roundtrip`` at the full width of
     configs/frontier_v2.json (bf16 compute, seeded random weights) on four
     32768-sample stereo clips and one 10 s 44.1 kHz stereo clip;
  5. the train path (the config's remat honoured, as in every train phase
     below): the iMF ``make_train_step`` at frontier-v2 width with
     ``fused_stage`` on, bf16 compute, on 16 synthetic stereo clips of 32768
     samples (2032 flow rows), 2 warm-up and 10 timed steps; then the same
     with ``fused_stage`` off (the default training path, as a yardstick),
     2 warm-up and 5 timed steps;
     each path (and those of phases 3a, 7-12, 8a, 9a, 10a and 12a-12d) is
     driven with the kernels' launch counts (and the count of each
     GELU+GRN kernel) set to 0 just before it and read just after (phase
     12d: each tool alone);
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
  8a. (right after serving, on the trainer's workdir) W8A8 int8 serving:
     ``AudioCodec.from_workdir(..., quantized=True)`` serving the same
     EMA, config.json unchanged; a 10 s clip's round trip and v1 8-bit
     bytes decoded within relative L2 0.05 of the bf16 codec's with the
     same noise, the encoder's bytes equal; per call of the quantized
     codec one MDCT launch an encode, one IMDCT launch and 72 int8 products
     a decode (none in the encoder), counted with the bf16 reference run
     outside the window; decode ms bf16 and int8 in turns at the 10
     s clip and at 4 clips x 32768, and the int8 products' time beside the
     bf16 GEMMs at their shapes and their bound; ``codec_cli decode
     --quantized``; ``evaluate_all --quantized`` at 16 examples, NFE 1; 6
     quantized streaming pushes (16 rows each: the padded int8 product),
     each of the three a counted path of its own;
  9. streaming: the same length of clip through ``StreamingCodec`` in
     pushes of 4096 samples (16 frames), ms per push and the real-time
     factor; the streaming encoder against batch ``encode`` and the
     streaming decoder in 16- against 64-frame chunks, within relative L2
     2e-2 (bf16 compute; the measured max error is printed);
  9b. the simple trainer (``training/simple_trainer``): ``train_epoch`` at
     frontier-v2 width on the card, 4 flow-matching and 4 iMF steps on
     seeded token batches, finite losses;
  9a. the corpus: ``tools/make_corpus`` writes 8 FLAC and 4 WAV clips of
     4.46 s (mixed family) into a temporary directory; the frames/s of
     ``build_audio_pipeline`` over it for 10 batches of 16 x 32768 x 2,
     native with 2 threads (as the trainer builds it, ``files_skipped``
     0) and the Python stages; then ``python -m
     meanflow_audio_codec_torch.train --config configs/corpus_rehearsal.json
     --data-dir <corpus>`` through ``main`` at full width (114,472,384
     parameters, bf16, chunks of 16, ``dots_saveable``, the device pool cut
     from 1024 clips to 64), one run of 48 steps, checkpointing (one full
     and one serving file) and sampling once, at its end; the trainer
     phase's checks of the workdir and the parameter count; chunk ms per step,
     steps/s, frames/s, peak memory, FLOPs and MFU beside the loader's
     rate, and the seconds and bytes of every checkpoint write; the exact
     stream (``--device-pool-clips 0``, the default for a corpus) for 16
     steps in chunks of 8, its chunk ms per step beside the pooled run's and the host
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
  10a. (run right after the QAT trainer, on the trainer's workdir)
     evaluation: ``python -m meanflow_audio_codec_torch.tools.eval_suite``
     through ``main`` (16 held-out clips, NFE 1, 2 and 10 with 2 timed
     runs, the ECSQ 0.5 and 8-bit stored formats, the rich family), each
     result file checked for the JAX package's key set per NFE entry
     (that of outputs/imf_frontier_v2/evaluation_results_step65k.json),
     finite values and measured kbps; one ``ComprehensiveEvaluator`` pass
     at its default 64 clips, NFE 1, 5 timed runs (the card's sampling ms,
     the host's metric seconds, peak memory); the float32 evaluation of 2
     clips x 4096 at NFE 1 on the card against the CPU's (decoded audio
     within relative L2 1e-5); ``tools/export_serving``, whose file served
     alone decodes as the full checkpoint's EMA, bit for bit; and
     ``tools/export_samples --num-clips 2`` with its WAV names checked;
  11. objectives: one bare bf16 step each (median of 3 after 1 warm-up,
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
  12a. the other families at full width, each through ``python -m
     meanflow_audio_codec_torch.train`` (``main``; chunks of 4, 8 steps
     then ``--resume`` to 16, sampling at the end of each run; the mixer
     codec and the ablation model one run of 8, the mixer's checkpoints
     taking ~15 s each): the
     MLP-Mixer codec (method=improved_mean_flow--architecture=mlp_mixer--
     dataset=audio--tokenization=mdct.json, 321,236,192 parameters, its
     128 clips cut to 3 = 765 flow rows, the most under 60 GiB: one bare
     step holds 62.7 GB at 3 clips, 82.0 GB at 4 (``--jvp-tape``); device
     pool 16 clips), the MLP
     codec (the mlp config, its 128 clips cut to 32, 8160 rows, pool 64
     clips)
     and the ablation sweep's largest model (ablation--size=large.json:
     synthetic mnist, reshape, mlp, mean flow, 16 blocks, latent 1024,
     batch 128); the workdir's log, checkpoints and parameter count
     (the JAX package's), finite samples; chunk ms per step, frames/s,
     peak memory, FLOPs and MFU; the two codecs served by
     ``AudioCodec.from_workdir``, a 10 s clip through ``roundtrip`` and
     ``encode_bytes`` / ``decode_bytes`` (v1 8-bit), timed;
  12b. the matrix: ``tools/matrix_smoke`` over all 48 configs/method=*.json
     on the card (the JAX smoke's tiny overrides), one line per config,
     then 48/48;
  12c. ``tools/evaluate_all`` through ``main`` over two configs, the corpus
     phase's run (held-out clips from its corpus) and path C's MNIST run
     (image metrics), NFE 1 and 2 at 16 examples: one CSV row per config
     and NFE; then the flag-driven trainer, ``python -m
     meanflow_audio_codec_torch.train --dataset audio --method
     improved_mean_flow --architecture convnet --architecture-options
     <frontier_v2's> ...`` without ``--config`` (16 steps in chunks of 8,
     the device pool cut to 64 clips): finite steps, ``config.json``
     holding the flags, frontier-v2's 33,813,696 parameters;
  12d. (run after phase 13, whose profiles it would otherwise precede)
     the timing tools: each ported ``tools/benchmarks`` script and
     ``tools/probes`` probe through its ``main`` in this process on the
     card (its output echoed): ``benchmark_mdct`` at its 4 configs (each
     kernel column held against the plain ``mdct_direct`` inside the
     script, rtol 1e-4 / atol 1e-3), ``benchmark_codec_geometry`` at
     ``ch256_s8_lift32`` over 16 x 10 s of 48 kHz stereo in bf16 and with
     ``--quantized``, ``benchmark_conv_mfu``'s
     ``ch512_s8_lift64_bn1024_b2048_dots`` and its ``_fused`` row,
     ``benchmark_streaming``'s ``light_ch256`` in 0.1 s chunks, the
     sampler, objectives and MF-vs-iMF scripts at their defaults (the
     sampler's NFE cut to 1 and 10, the objectives' steps from 30 to 10,
     the MF-vs-iMF steps from 400 to 20, the codec geometry's timed groups
     from 3 to 1), the five probes at their shapes (the A/B cut to 1 round
     of 2 calls a side, the int8 chain's, the int8 conv's and the stage
     probe's repeats to 1) and,
     last, the five data scripts over a 20-file synthetic WAV
     corpus; fails on an error row,
     a return code other than 0, a time or rate that is not finite and
     positive, a parameter count other than the
     JAX package's, or a launch count other than one MDCT and one IMDCT a
     codec call, 72 int8 products a quantized decoder call (in the codec
     geometry and the A/B probe's int8 calls, and as
     ``aten::_int_mm`` calls in ``probe_hlo``'s profile), all three stage
     kernels on the fused row and none on the unfused one;
  13. float32 checks (phase 6) plus each objective's loss and gradients on
     the card against the CPU at one clip (relative L2 <= 1e-5), then
     profiles of one round trip and one bf16 train step with
     ``fused_stage`` on and off (device time by kernel, busy share);
  15. (run after 12d, before the lines of 14) data-parallel training, in
     three parts: ``python -m
     meanflow_audio_codec_torch.train --config configs/frontier_v2.json``
     through ``main`` inside a one-rank NCCL group (the sharded path at
     world size 1: its sharding and mesh-pool lines, 32 steps in chunks of
     16 with the pool cut to 64 clips, the second chunk's time per step,
     the checkpoint reloaded with its EMA equal to the serving file's);
     two ranks on the one card over gloo (``torch.multiprocessing``, CUDA
     tensors), one float32 step at frontier-v2 width (warmup off, so the
     parameters move) on 8 clips each against the one-process step on
     all 16 (loss, parameters and first moments within relative L2
     1e-5), the MDCT launched on each rank; and, started first and beside
     both, ``tools/supervise`` (its torch probe of the card) over a small
     trainer child whose first launch stalls once, restarted with
     ``--resume`` to its end; the parts' wall seconds;
  16. (after 15) orbax checkpoints without JAX, tensorstore or zstandard:
     the JAX-written run ``tests/fixtures/torch_orbax_run`` (every leaf of
     its orbax directory against its msgpack twin bit for bit, then
     served by ``from_workdir`` on 2 x 32768 samples against serving the
     twin); ``python -m meanflow_audio_codec_torch.train`` on a copy of
     configs/frontier_v2.json with ``checkpoint_format: "orbax"`` (16
     steps, a checkpoint at 16, then ``--resume`` to 32; pool 64 clips),
     each orbax write followed by a msgpack checkpoint of the same state,
     each pair of checkpoints equal leaf for leaf, the seconds, bytes and
     MB/s of every write and read; and the resumed run served from its
     orbax directory, a 10 s clip's ``encode_bytes``/``decode_bytes``
     equal to those served from the msgpack twin;
  17. (after 16) the JAX package's layer interfaces at frontier-v2 width:
     ``load_config_from_json`` of configs/frontier_v2.json with section
     access equal to flat access for every field; ``make_eval_step`` of
     the config's ``ImprovedMeanFlowLoss`` with its MDCT token adapter on
     16 clips x 32768 samples (float32, TF32 off), one MDCT launch a call,
     the loss equal to ``objective.loss`` on the same tokens and draws (rel
     <= 1e-5); ``train_step`` through ``compute_loss`` for 2 float32 steps
     against ``make_train_step``'s with the same draws (losses, parameters
     and first moments within relative L2 1e-5), with ``fused_stage`` off
     and on (every stage kernel launched on the fused path, none on the
     other); ``stage_fusable`` against the wrappers' launches at 4
     geometries in bf16, f32 and f16; ``training/profiling.device_time``
     of the bf16 codec's round trip on 4 clips x 32768 beside ``time_ms``
     of the same call, 12 MDCT and 12 IMDCT launches;
  18. (after 17) the proj trials: ``meanflow_audio_codec_torch.proj.
     mnist_trial``, ``mnist_autoencoder`` and ``audio_autoencoder`` through
     ``main`` at their published widths (bf16, batch 128, 128 and 8 clips
     x 16384 samples), their steps cut from 2000/1000/1000 to
     ``PROJ_STEPS``: ms a step, peak memory, first and last loss (finite),
     the output files, and the audio trial's MDCT launches (at least one a
     step) and IMDCT launches (at least one); then one float32 step of
     each trial's model, state and step on the card against the same step
     on the CPU (same weights, batch and draws; loss rtol 1e-4, Adam's
     first moments within relative L2 1e-5);
  14. a ``{"kernels": [...]}`` line (launches per path: the transform
     layers' gradient, round trip, train, trainer, codec bytes, codec CLI,
     quantized serving, streaming, QAT trainer, eval_suite,
     the 64-clip evaluator, the exports, the corpus trainer, its exact
     stream and serving, each objective, each remat setting, the three
     family trainers, the two codecs' serving, the matrix, evaluate_all,
     the flag-driven trainer, each timing tool that launches a kernel,
     the one-rank trainer and the two ranks' step, the orbax fixture,
     trainer and serving, phase 17's eval step, its two ``train_step``
     paths and ``device_time``'s round trip, and the three proj trials),
     then the result line
     ``{"ok": true, "device": {...}}`` last.

With ``--parallel-only`` it builds, then runs phase 15 alone and prints
its launches but no result line; ``--orbax-only``, ``--interfaces-only``
and ``--proj-only`` do the same for phases 16, 17 and 18. With
``--transforms-only`` it runs phases 1-3 for the MDCT and IMDCT alone
(no instruction mix) and prints their line of results but no result line:
copied into another checkout of the port, it times that checkout's kernels
at the same shapes. With ``--jvp-tape`` it builds, then times bare bf16 iMF
steps (step ms, peak memory) with the stop-gradient JVP's tangent off the
autograd tape, as the port computes it, and on it, as the port did up to
PR 8's tree: path A's MLP-Mixer codec at 1-4 clips (each way up to its
first out-of-memory) and the frontier-v2 step with ``fused_stage`` off and
on; it prints no result line.

Needs one CUDA card; exits with code 2 when there is none.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
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
from meanflow_audio_codec_torch.configs import (
    load_config,
    load_config_from_json,
)
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops import _build
from meanflow_audio_codec_torch.ops import imdct_cuda as imdct_cuda_mod
from meanflow_audio_codec_torch.ops import mdct_cuda as mdct_cuda_mod
from meanflow_audio_codec_torch.ops import quant, stage, stage_cuda
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
from meanflow_audio_codec_torch.ops.stage import stage_fusable
from meanflow_audio_codec_torch.ops.tokenize import (
    MDCTTokenization,
    create_tokenization_strategy,
)
from meanflow_audio_codec_torch import proj
from meanflow_audio_codec_torch.proj import (
    audio_autoencoder,
    mnist_autoencoder,
    mnist_trial,
)
from meanflow_audio_codec_torch.tools.benchmarks._timing import card_line
from meanflow_audio_codec_torch.training import profiling
from meanflow_audio_codec_torch.training.adapter import adapter_from_config
from meanflow_audio_codec_torch.training.logging import read_log
from meanflow_audio_codec_torch.training.objectives import (
    ImprovedMeanFlowLoss,
    create_loss_strategy,
)
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    make_optimizer,
)
from meanflow_audio_codec_torch.training.train_step import (
    make_eval_step,
    make_multi_step,
    make_train_step,
    train_step,
)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "frontier_v2.json"
#: the other families' full-width paths: label -> (config, parameters as the
#: JAX package counts them, batch in clips (None: the config's), device
#: pool clips (None: the config's default), whether a ``--resume`` run
#: follows the first)
CONFIGS = REPO / "configs"
FAMILY_RUNS = {
    # path A: the MLP-Mixer codec, its 128 clips cut to 3 (765 flow rows):
    # one bare bf16 step holds 62.7 GB (58.4 GiB) at 3 clips and 82.0 GB at
    # 4 on an H100 80GB HBM3 (--jvp-tape); one run, no resume: each of its
    # 3.85 GB checkpoints takes ~15 s to write
    "mixer_codec": (CONFIGS / ("method=improved_mean_flow--architecture="
                              "mlp_mixer--dataset=audio--tokenization="
                              "mdct.json"), 321_236_192, 3, 16, False),
    # path B: the MLP codec, its 128 clips cut to 32 (8160 flow rows): the
    # host synthesises a batch of 128 clips in ~13 s, and the pool holds two
    "mlp_codec": (CONFIGS / ("method=improved_mean_flow--architecture=mlp--"
                            "dataset=audio--tokenization=mdct.json"),
                  28_262_272, 32, 64, True),
    # path C: the ablation sweep's largest model (mnist, reshape, mlp); one
    # run, no resume
    "ablation_large": (CONFIGS / "ablations" / "ablation--size=large.json",
                       86_005_000, None, None, False),
}
FAMILY_STEPS = 8  # steps per run: the first run, then --resume to twice
FAMILY_CHUNK = 4  # steps per call: two chunks in each run
JVP_PROBE_CLIPS = (1, 2, 3, 4)  # path A's batches in the tape probe
QAT_CONFIG = REPO / "configs" / "frontier_v2_qat.json"
CORPUS_CONFIG = REPO / "configs" / "corpus_rehearsal.json"
#: the corpus phase's corpus (make_corpus, mixed family), the loader's timed
#: batches and the corpus config's parameter count (the JAX package's)
CORPUS_FLAC, CORPUS_WAV, CORPUS_SECONDS = 8, 4, 4.46
LOADER_BATCHES = 10
CORPUS_PARAMS = 114_472_384
SAMPLE_RATE = 44100
#: the evaluation phase: eval_suite's held-out clips and NFEs, and the JAX
#: package's result file whose NFE entries give the key set to match
EVAL_CLIPS, EVAL_NFES = 16, [1, 2, 10]
EVAL_REFERENCE = (REPO / "outputs" / "imf_frontier_v2" /
                  "evaluation_results_step65k.json")
FRONTIER_PARAMS = 33_813_696  # configs/frontier_v2.json, as JAX counts them
RTOL, ATOL = 1e-4, 1e-3
REPEATS = 10  # timed round trips per request
TRAIN_CLIPS, CLIP_LEN = 16, 32768  # frontier-v2 batch_size and frame_size
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core peak, the same data sheet
#: W8A8 serving: int8 products per decoder call at frontier-v2's 8 stages (4
#: Dense and 5 convs a stage) and the int8 decode's bound against bf16's
#: (the JAX package's tests/test_quant.py bound)
INT8_PRODUCTS_PER_DECODE = 72
QUANT_REL_L2 = 0.05
SIMPLE_STEPS = 4  # train_epoch's steps per objective in the simple trainer
#: the proj trials' steps, cut from the scripts' 2000 (mnist_trial) and
#: 1000 (the autoencoders), and the examples of their card-against-CPU step
PROJ_STEPS = 64
PROJ_CHECK_ROWS, PROJ_CHECK_CLIPS = 16, 2

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
OBJ_WARMUP, OBJ_STEPS = 1, 3  # cut from 2, 5 to make room for phase 18
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


def _timed_ms(fn, calls: int) -> float:
    """Device milliseconds of ``calls`` calls of ``fn`` by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _calls_per_batch(fn, batch_ms: float) -> int:
    """Calls of ``fn`` spanning about ``batch_ms``, found after a warm-up of
    at least 20 ms of calls (the clocks leave idle)."""
    calls, spent = 1, _timed_ms(fn, 1)
    while spent < 20.0:
        calls *= 2
        spent = _timed_ms(fn, calls)
    return max(1, math.ceil(batch_ms * calls / spent))


def time_ms(fn, batches: int = 5, batch_ms: float = 5.0) -> float:
    """Device milliseconds per call of ``fn`` by CUDA events: the median over
    ``batches`` batches of calls, each spanning about ``batch_ms``, after a
    warm-up of at least 20 ms of calls (the clocks leave idle)."""
    calls = _calls_per_batch(fn, batch_ms)
    return statistics.median(_timed_ms(fn, calls) / calls
                             for _ in range(batches))


def time_alternating(fns: dict, rounds: int = 7,
                     batch_ms: float = 5.0) -> dict:
    """:func:`time_ms` of several functions in turns: each round times one
    batch of every function, one after the other, and each gets the median
    over the rounds, so a clock or a neighbour that changes during the
    measurement moves every function alike."""
    calls = {name: _calls_per_batch(fn, batch_ms) for name, fn in fns.items()}
    samples: dict = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            samples[name].append(_timed_ms(fn, calls[name]) / calls[name])
    return {name: statistics.median(v) for name, v in samples.items()}


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
    at a streaming push's (2 rows x 4864 samples, 18 frames), and at the
    shapes of the other families' paths (the MLP codec's 256 x 65536,
    mnist's 128 x 784, the matrix smoke's 8 x 512 at W 256, the audio
    autoencoder trial's 16 x 16384 at W 256); times at the codec shape
    (keys ``ms``, ...) and at each other shape but the ragged one
    (``ms_10s``, ``ms_train``, ``ms_stream``, ``ms_mlp_codec``,
    ``ms_mnist``, ``ms_matrix``, ``ms_codec_geometry`` (the timing tools'
    32 x 480000 at W 576), ``ms_proj_audio``, ...)."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {name: {"max_abs_err": 0.0}
               for name in ("mdct_cuda", "imdct_cuda")}
    for label, rows, length, w, hop in [
            ("codec", 8, 32768, 512, 256), ("ragged", 3, 5000, 576, 100),
            ("10s", 2, 10 * SAMPLE_RATE, 512, 256),
            ("train", 2 * TRAIN_CLIPS, CLIP_LEN, 512, 256),
            # a streaming push: 4096 new samples after the 768 carried
            ("stream", 2, STREAM_CHUNK + 768, 512, 256),
            # the MLP codec's step (128 stereo clips x 65536 samples)
            ("mlp_codec", 256, 65536, 512, 256),
            # mnist + mdct: 784 pixels, 2 frames of W 512
            ("mnist", 128, 784, 512, 256),
            # the matrix smoke's audio (4 stereo clips of 512, W 256)
            ("matrix", 8, 512, 256, 128),
            # the timing tools' codec geometry: 16 stereo clips of 10 s at
            # 48 kHz, W 576 (benchmark_codec_geometry, probe_codec_ab)
            ("codec_geometry", 32, 480000, 576, 288),
            # the audio autoencoder trial: 8 stereo clips of 16384, W 256
            ("proj_audio", 16, 16384, 256, 128)]:
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

    # kernel and plain version in turns at the codec shape: PR 14's one
    # reading of the IMDCT (0.0561 ms) sat 35% above every earlier one
    cfg = MDCTConfig(512, 256)
    nf = num_frames_for_length(32768, 512, 256)
    x = torch.randn(8, 32768, generator=gen, device=device)
    X = torch.randn(8, nf, 512, generator=gen, device=device)
    turns = time_alternating({
        "mdct_cuda": lambda: mdct_cuda(x, cfg),
        "mdct plain": lambda: mdct(x, cfg),
        "imdct_cuda": lambda: imdct_cuda(X, cfg),
        "imdct plain": lambda: imdct(X, cfg)})
    for name in ("mdct_cuda", "imdct_cuda"):
        res = results[name]
        res["ms_alternating"] = turns[name]
        res["plain_ms_alternating"] = turns[name.replace("_cuda", " plain")]
        print(f"{name} codec shape in turns with its plain version (7 "
              f"rounds): kernel {res['ms_alternating']:.4f} ms, plain "
              f"{res['plain_ms_alternating']:.4f} ms (alone above: kernel "
              f"{res['ms']:.4f}, plain {res['plain_ms']:.4f})", flush=True)

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


def _time_stage_kernel(res: dict, name: str, kernel, plain, library,
                       x: torch.Tensor, suffix: str) -> None:
    """Kernel, plain and library ms and the byte bound into ``res`` under
    keys ending in ``suffix``."""
    res["ms" + suffix] = time_ms(kernel)
    res["plain_ms" + suffix] = time_ms(plain)
    res["library_ms" + suffix] = (time_ms(library) if library is not None
                                  else None)
    # a normalisation pass: bound by the bytes it moves
    res["bound_ms" + suffix] = 1e3 * _stage_bytes(name, x) / PEAK_BYTES_PER_S
    res["bound_by" + suffix] = "bytes"
    lib = ("none (no single PyTorch call computes it)" if library is None
           else f"{res['library_ms' + suffix]:.4f} ms")
    print(f"{name} {tuple(x.shape)} bf16: kernel {res['ms' + suffix]:.4f} "
          f"ms, plain {res['plain_ms' + suffix]:.4f} ms, library {lib}, "
          f"bound {res['bound_ms' + suffix]:.4f} ms (bytes)", flush=True)


def check_stage_kernels(device: torch.device) -> dict:
    """Kernels 3-5 against their plain versions at the train shape (LN at
    C = 256, GELU+GRN at 2C = 512), two ragged shapes, a long-P shape
    (GELU+GRN takes its two-pass kernel there) and benchmark_conv_mfu's
    (2048 rows, LN at C = 512, GELU+GRN at 1024), in bf16 and f32, and the
    two-pass GELU+GRN kernel at the train shape too; the public ops'
    tangents and gradients in f32 at the train shape; times of the bf16
    train shape, the dtype of the train path, and of the bf16 conv_mfu
    shape (keys ending ``_conv_mfu``)."""
    gen = torch.Generator(device=device).manual_seed(4)
    results = {name: {"max_abs_err": 0.0} for name in stage_cuda.launches}
    n_train = TRAIN_CLIPS * num_frames_for_length(CLIP_LEN, 512, 256)
    variants_checked = set()
    for label, (n, p, c) in [("train", (n_train, 64, 256)),
                             ("ragged", (3, 9, 40)), ("ragged", (3, 9, 41)),
                             ("long P", (4, 256, 256)),
                             # benchmark_conv_mfu's ch512 rows at batch 2048
                             ("conv_mfu", (2048, 64, 512))]:
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
                if label == "conv_mfu" and dtype == torch.bfloat16:
                    _time_stage_kernel(res, name, kernel, plain, library,
                                       args[0], "_conv_mfu")
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
                _time_stage_kernel(res, name, kernel, plain, library,
                                   args[0], "")
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


def _check_trainer_workdir(workdir: Path, resumed: bool = True
                           ) -> tuple[list[dict], dict, dict]:
    """The trainer's records after 32 steps and a resume to 48 (or, with
    ``resumed`` False, one run of 48): 48 step records with finite loss
    and grad_norm and update_ok, the resumed run starting at step 32, the
    retained checkpoints and sidecars, a serving file holding the run's
    EMA, the WAV sample and the summary. Returns the step records, the
    summary and the EMA of step 48."""
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [i for i, r in enumerate(records) if r.get("event") == "start"]
    steps = [r for r in records if "event" not in r]
    if (len(starts) != 1 + resumed
            or [r["step"] for r in steps] != list(range(48))):
        raise AssertionError(f"trainer log: start events at {starts}, steps "
                             f"{[r['step'] for r in steps]}")
    if resumed and records[starts[1] + 1]["step"] != 32:
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
    if not resumed:
        want = [name for name in want if "00032" not in name]
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
    run = "resumed at 32" if resumed else "one run"
    print(f"trainer workdir: 48 steps logged ({run}), finite loss "
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
    64): one run of 48 steps, saving (one full and one serving checkpoint)
    and sampling once, at its end; the trainer phase holds ``--resume``.
    Returns the launch counts, the run's EMA and its chunk time per
    step."""
    config = _corpus_config()
    args = ["--config", str(CORPUS_CONFIG), "--data-dir", str(corpus),
            "--device-pool-clips", "64", "--workdir", str(workdir)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    with timed_checkpoint_writes() as writes:
        if train_cli.main(args + ["--n-steps", "48"]) != 0:
            raise AssertionError("corpus train main failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    steps, summary, ema = _check_trainer_workdir(workdir, resumed=False)
    counts = {r.get("param_count") for r in read_log(
        workdir / "logs" / "train_log.jsonl") if r.get("event") == "start"}
    if counts != {CORPUS_PARAMS}:
        raise AssertionError(f"corpus trainer: {counts} parameters, "
                             f"expected {CORPUS_PARAMS}")
    print(f"corpus trainer path launches (48 steps, 1 sampling): "
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
          f"{wall:.1f} s for the run; peak memory {peak_gb:.3f} GB; "
          f"{flops / 1e9:.1f} GFLOP per step, {tflops:.2f} achieved "
          f"TFLOP/s, {mfu}", flush=True)
    print(f"[{card}] loader against the step: the native loader sustains "
          f"{loader_clips_s:.1f} clips/s, the step consumes "
          f"{step_clips_s:.1f} clips/s ({loader_clips_s / step_clips_s:.2f}x)",
          flush=True)
    _print_writes(writes, "corpus trainer")
    if len(writes) != 2:
        raise AssertionError(f"corpus trainer wrote {len(writes)} "
                             "checkpoints, expected one full and one serving")
    return launches, ema, med


def corpus_exact_stream_path(device: torch.device, card: str, corpus: Path,
                             workdir: Path, pooled_ms: float) -> dict:
    """The same config without the device pool (``--device-pool-clips 0``,
    the JAX package's default for a corpus: host batches go to the card
    every chunk): 16 steps in chunks of 8, the host synchronisations inside
    the second chunk counted. Returns the launch counts."""
    from meanflow_audio_codec_torch.training import trainer as trainer_mod

    real = trainer_mod.make_multi_step
    calls, syncs = [0], []

    def counted(*args, **kwargs):
        chunk = real(*args, **kwargs)

        def run(*a, **kw):
            calls[0] += 1
            if calls[0] != 2:
                return chunk(*a, **kw)
            out, count = count_syncs("one 8-step chunk of the exact stream",
                                     lambda: chunk(*a, **kw))
            syncs.append(count)
            return out
        return run

    args = ["--config", str(CORPUS_CONFIG), "--data-dir", str(corpus),
            "--device-pool-clips", "0", "--n-steps", "16",
            "--steps-per-call", "8", "--workdir", str(workdir)]
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
    if [r["step"] for r in steps] != list(range(16)) or not all(
            math.isfinite(r["loss"]) and r["update_ok"] is True
            for r in steps):
        raise AssertionError("exact stream: steps missing, non-finite or "
                             "rejected")
    summary = json.loads((workdir / "summary.json").read_text())
    if "pool_skipped_refreshes" in summary:
        raise AssertionError("the exact stream ran through a device pool")
    chunk_ms = [1e3 * steps[i]["step_time"] for i in (0, 8)]
    print(f"[{card}] corpus exact stream (no device pool, chunks of 8): "
          f"chunk time per "
          f"step {chunk_ms[0]:.3f} / {chunk_ms[1]:.3f} ms (chunks 1-2; the "
          f"first includes the start) against {pooled_ms:.3f} ms with the "
          f"pool ({chunk_ms[1] / pooled_ms:.4f}x)", flush=True)
    _print_writes(writes, "exact stream")
    print(f"corpus exact stream path launches (16 steps, 1 sampling): "
          f"{launches}", flush=True)
    if launches["mdct_cuda"] < 16 or launches["imdct_cuda"] < 1:
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


# ---------------------------------------------------------------------------
# the other model families and the matrix (phases 12a, 12b)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_samples():
    """Record what the trainer's sampling writes (the decoded WAV clip or
    the PNG grid's images) and check it is finite; the PNG itself needs
    matplotlib, which the card's machine may lack."""
    from meanflow_audio_codec_torch.training import trainer as trainer_mod

    seen = []

    def check(samples, path) -> None:
        if not bool(torch.isfinite(torch.as_tensor(samples)).all()):
            raise AssertionError(f"non-finite samples for {path}")
        seen.append((Path(path).name, tuple(samples.shape)))

    real_wav, real_png = trainer_mod.write_wav, trainer_mod.plot_samples

    def write_wav(path, audio, *args, **kwargs):
        check(audio, path)
        return real_wav(path, audio, *args, **kwargs)

    def plot_samples(samples, path, *args, **kwargs):
        check(samples, path)
        return real_png(samples, path, *args, **kwargs)

    trainer_mod.write_wav, trainer_mod.plot_samples = write_wav, plot_samples
    try:
        yield seen
    finally:
        trainer_mod.write_wav, trainer_mod.plot_samples = real_wav, real_png


def family_trainer_path(device: torch.device, card: str, label: str,
                        workdir: Path) -> tuple[dict, float]:
    """One of ``FAMILY_RUNS`` through the train CLI's ``main`` at the
    config's widths: ``FAMILY_STEPS`` steps in chunks of ``FAMILY_CHUNK``,
    then (where ``FAMILY_RUNS`` says so) ``--resume`` to twice that,
    sampling at the end of each run. Checks the log, the checkpoints, the
    parameter count and the samples; prints chunk ms per step, frames/s,
    peak memory, FLOPs and MFU. Returns the launch counts and the chunk ms
    per step."""
    path, n_params, clips, pool, resume = FAMILY_RUNS[label]
    runs = 2 if resume else 1
    total = runs * FAMILY_STEPS
    config = load_config(path)
    batch = clips or config.batch_size
    args = ["--config", str(path), "--steps-per-call", str(FAMILY_CHUNK),
            "--workdir", str(workdir)]
    if clips:
        args += ["--batch-size", str(clips)]
    if pool is not None:
        args += ["--device-pool-clips", str(pool)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    with recorded_samples() as samples, timed_checkpoint_writes() as writes:
        for extra in (["--n-steps", str(FAMILY_STEPS)],
                      ["--resume", "--n-steps", str(total)])[:runs]:
            if train_cli.main(args + extra) != 0:
                raise AssertionError(f"{label}: train main {extra} failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [r for r in records if r.get("event") == "start"]
    steps = [r for r in records if "event" not in r]
    if [r["step"] for r in steps] != list(range(total)) or len(starts) != runs:
        raise AssertionError(f"{label}: steps {[r['step'] for r in steps]}")
    if {r["param_count"] for r in starts} != {n_params}:
        raise AssertionError(f"{label}: {starts[0]['param_count']} "
                             f"parameters, the JAX package counts {n_params}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               and r.get("update_ok") is not False for r in steps):
        raise AssertionError(f"{label}: a non-finite or rejected step")
    ckpt = workdir / "checkpoints"
    for name in (f"step_{FAMILY_STEPS:05d}.msgpack", f"step_{total:05d}.msgpack",
                 f"serving_step_{total:05d}.msgpack"):
        if not (ckpt / name).exists():
            raise AssertionError(f"{label}: no {name}")
    audio = config.dataset == "audio"
    ext = "wav" if audio else "png"
    if [name for name, _ in samples] != [f"step_{FAMILY_STEPS:05d}.{ext}",
                                         f"step_{total:05d}.{ext}"][:runs]:
        raise AssertionError(f"{label}: samples {samples}")
    summary = json.loads((workdir / "summary.json").read_text())
    # rows of one step: every MDCT frame of every clip (frames layout), or
    # one example per image (features layout)
    rows = batch * (num_frames_for_length(65536, 512, 256) if audio else 1)
    chunk_ms = [1e3 * steps[i]["step_time"] for i in range(0, total,
                                                           FAMILY_CHUNK)]
    ms = statistics.median(chunk_ms[1::2])
    flops = summary["flops_per_step"]
    peak = profiling.peak_flops(device)
    tflops = flops / (ms / 1e3) / 1e12
    mfu = (f"mfu {tflops * 1e12 / peak:.4f}" if peak else
           "mfu not measured (no peak known for this card)")
    print(f"{label} launches ({' + '.join([str(FAMILY_STEPS)] * runs)} "
          f"steps, {runs} sampling(s)): {launches}", flush=True)
    if launches["mdct_cuda"] < (total if config.tokenization_strategy ==
                                "mdct" else 0):
        raise AssertionError(f"{label}: the MDCT did not run on every step")
    print(f"[{card}] {label} ({path.name}, {n_params} params as JAX counts "
          f"them, {config.precision}, batch {batch} clips = {rows} flow "
          f"rows, chunks of {FAMILY_CHUNK}): chunk time per step "
          f"{' / '.join(f'{v:.3f}' for v in chunk_ms)} ms (chunks "
          f"1-{len(chunk_ms)}; 1 and 3 begin a run), median of the even "
          f"chunks {ms:.3f} ms, "
          f"{1e3 / ms:.3f} steps/s, {rows / ms * 1e3:.1f} frames/s; peak "
          f"memory {peak_gb:.3f} GB; {flops / 1e9:.1f} GFLOP per step, "
          f"{tflops:.2f} achieved TFLOP/s, {mfu}; wall {wall:.1f} s for "
          f"{runs} run(s); samples {samples} finite", flush=True)
    _print_writes(writes, label)
    return launches, ms


def family_serving_path(device: torch.device, card: str, label: str,
                        workdir: Path) -> dict:
    """Serve a family run (``AudioCodec.from_workdir``) and put a 10 s
    stereo clip through ``roundtrip`` and ``encode_bytes`` ->
    ``decode_bytes`` (v1 8-bit), timed. Returns the launch counts."""
    zero_launches()
    codec = AudioCodec.from_workdir(workdir)
    n_params = sum(p.numel() for p in codec.model.parameters())
    if n_params != FAMILY_RUNS[label][1]:
        raise AssertionError(f"{label} served: {n_params} parameters")
    audio = synth_audio(1, 10 * SAMPLE_RATE,
                        torch.Generator(device).manual_seed(13), device)
    gen = torch.Generator(device)
    codec.roundtrip(audio, generator=gen.manual_seed(1))  # warm-up
    rt_ms, recon = _wall_ms(lambda: codec.roundtrip(
        audio, generator=gen.manual_seed(1)), BYTES_REPEATS)
    codec.decode_bytes(codec.encode_bytes(audio, bits=8))  # warm-up
    enc_ms, data = _wall_ms(lambda: codec.encode_bytes(audio, bits=8),
                            BYTES_REPEATS)
    dec_ms, from_bytes = _wall_ms(lambda: codec.decode_bytes(
        data, generator=gen.manual_seed(4)), BYTES_REPEATS)
    nf = num_frames_for_length(audio.shape[1], 512, 256)
    want = (1, (nf - 1) * 256 + 1024, 2)
    for what, out in (("roundtrip", recon), ("decode_bytes", from_bytes)):
        if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label} {what}: {tuple(out.shape)}")
    latents = codec.encode(audio)
    launches = read_launches()
    print(f"[{card}] {label} served ({n_params} params; latents "
          f"{tuple(latents.shape)}), 10 s clip: roundtrip {rt_ms:.3f} ms, "
          f"encode_bytes {enc_ms:.3f} ms, decode_bytes {dec_ms:.3f} ms "
          f"(medians of {BYTES_REPEATS}), {len(data)} bytes = "
          f"{len(data) * 8 / 10 / 1000:.1f} kbps stored v1 8-bit (seeded "
          f"weights after training: a rate, not a quality figure); "
          f"launches {launches}", flush=True)
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] == 0:
            raise AssertionError(f"{kernel} was not launched serving {label}")
    return launches


def families_phase(device: torch.device, card: str, scratch: Path,
                   keep: tuple[str, ...] = ()) -> dict:
    """Paths A-C (``FAMILY_RUNS``): train, resume, and serve the codecs;
    returns the launch counts per path. The workdirs of the labels in
    ``keep`` stay under ``scratch``."""
    paths = {}
    for label in FAMILY_RUNS:
        workdir = scratch / label
        paths[f"{label}_trainer"], _ = family_trainer_path(device, card,
                                                           label, workdir)
        torch.cuda.empty_cache()
        if label.endswith("_codec"):
            paths[f"{label}_serving"] = family_serving_path(device, card,
                                                            label, workdir)
            torch.cuda.empty_cache()
        if label not in keep:
            shutil.rmtree(workdir)
    return paths


def matrix_phase(device: torch.device, scratch: Path) -> dict:
    """Path D: ``tools/matrix_smoke`` over all 48 configs/method=*.json on
    the card; every one must end on a finite loss. Returns the launch
    counts."""
    from meanflow_audio_codec_torch.tools import matrix_smoke

    paths = sorted(CONFIGS.glob("method=*.json"))
    if len(paths) != 48:
        raise AssertionError(f"{len(paths)} matrix configs, expected 48")
    zero_launches()
    with recorded_samples():
        results = matrix_smoke.run(paths, scratch / "matrix",
                                   device=str(device))
    launches = read_launches()
    passed = sum(r["ok"] for r in results)
    print(f"{passed}/{len(paths)}; matrix launches {launches}", flush=True)
    if passed != len(paths):
        raise AssertionError(f"matrix smoke: {passed}/{len(paths)} passed")
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] == 0:
            raise AssertionError(f"{kernel} was not launched in the matrix")
    return launches


# ---------------------------------------------------------------------------
# evaluation (phase 12c)
# ---------------------------------------------------------------------------


def _finite_numbers(node, where: str) -> None:
    """Raise unless every number in a result dict is finite."""
    if isinstance(node, dict):
        for key, value in node.items():
            _finite_numbers(value, f"{where}.{key}")
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        if not math.isfinite(node):
            raise AssertionError(f"{where} = {node}")


def eval_suite_path(device: torch.device, card: str, workdir: Path) -> dict:
    """``python -m meanflow_audio_codec_torch.tools.eval_suite`` through
    ``main`` on the trainer phase's frontier-v2 workdir: 16 held-out clips,
    NFE 1, 2 and 10 with 2 timed runs, the ECSQ 0.5 and 8-bit stored
    formats and the rich family. Checks every result file (the JAX
    package's key set per NFE entry, finite values, measured kbps > 0) and
    that the MDCT and IMDCT kernels ran. Returns the launch counts."""
    from meanflow_audio_codec_torch.tools import eval_suite

    want_keys = set(json.loads(EVAL_REFERENCE.read_text())["nfe_sweep"]["1"])
    want_keys.discard("pesq")
    for old in workdir.glob("evaluation_results*.json"):
        old.unlink()
    zero_launches()
    t0 = time.perf_counter()
    if eval_suite.main(["--workdir", str(workdir), "--num-samples",
                        str(EVAL_CLIPS), "--nfe", *map(str, EVAL_NFES),
                        "--timing-runs", "2", "--cross-family", "rich"]) != 0:
        raise AssertionError("eval_suite main failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    passes = {"evaluation_results.json": EVAL_NFES,
              "evaluation_results_ecsq0.5.json": [1],
              "evaluation_results_bits8.json": [1],
              "evaluation_results_rich.json": [1, 10]}
    written = sorted(p.name for p in workdir.glob("evaluation_results*.json"))
    if written != sorted(passes):
        raise AssertionError(f"eval_suite wrote {written}")
    for name, nfes in passes.items():
        results = json.loads((workdir / name).read_text())
        _finite_numbers(results, name)
        if list(results["nfe_sweep"]) != [str(n) for n in nfes]:
            raise AssertionError(f"{name}: NFEs {list(results['nfe_sweep'])}")
        for nfe, entry in results["nfe_sweep"].items():
            if set(entry) != want_keys:
                raise AssertionError(f"{name} nfe {nfe}: keys {sorted(entry)}"
                                     f", the JAX package's {sorted(want_keys)}")
        kbps = results.get("bitstream_kbps_measured")
        if ("ecsq" in name or "bits" in name) and not kbps > 0:
            raise AssertionError(f"{name}: bitstream_kbps_measured {kbps}")
        line = ", ".join(
            f"nfe {nfe}: sampling {1e3 * e['inference']['mean_sec']:.3f} ms "
            f"(first {1e3 * e['first_call_sec']:.3f}), mse {e['mse']:.5f}, "
            f"si_snr {e['si_snr_db']:.3f} dB, stoi {e['stoi']:.4f}, nsim "
            f"{e['nsim']:.4f}, bsd {e['bsd']:.4f}"
            for nfe, e in results["nfe_sweep"].items())
        print(f"[{card}] eval_suite {name} ({EVAL_CLIPS} clips x {CLIP_LEN}, "
              f"seeded weights after 48 steps: the path works, not a "
              f"quality figure): {line}"
              + (f"; {kbps:.3f} kbps stored" if kbps else ""), flush=True)
    print(f"[{card}] eval_suite: 4 passes, 7 NFE entries in {wall:.1f} s; "
          f"launches {launches}", flush=True)
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] == 0:
            raise AssertionError(f"{kernel} was not launched in eval_suite")
    return launches


def evaluator_timing_path(device: torch.device, card: str,
                          workdir: Path) -> dict:
    """One ``ComprehensiveEvaluator`` pass on the frontier-v2 run at its
    default 64 clips, NFE 1, 5 timed runs: the card's sampling time, the
    host's metric time (``_quality``) and the peak memory. Returns the
    launch counts."""
    from meanflow_audio_codec_torch.evaluators import ComprehensiveEvaluator
    from meanflow_audio_codec_torch.tools.evaluate_all import (
        find_checkpoint_for,
        load_real_data,
    )

    config = load_config(workdir / "config.json")
    data = load_real_data(config, 64, synthetic_family="tonal")
    evaluator = ComprehensiveEvaluator(find_checkpoint_for(config), config,
                                       nfe_list=[1], num_samples=64,
                                       timing_runs=5)
    host = []
    quality = evaluator._quality

    def timed_quality(real, generated):
        t0 = time.perf_counter()
        out = quality(real, generated)
        host.append(time.perf_counter() - t0)
        return out

    evaluator._quality = timed_quality
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    results = evaluator.evaluate(data)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    entry = results["nfe_sweep"]["1"]
    _finite_numbers(results, "evaluator")
    timing = entry["inference"]
    rows = 64 * num_frames_for_length(CLIP_LEN, 512, 256)
    print(f"[{card}] ComprehensiveEvaluator, frontier-v2 bf16, 64 clips x "
          f"{CLIP_LEN} ({rows} flow rows), NFE 1: sampling mean "
          f"{1e3 * timing['mean_sec']:.3f} ms, p50 "
          f"{1e3 * timing['p50_sec']:.3f} ms, min {1e3 * timing['min_sec']:.3f}"
          f" ms (5 runs; first call {1e3 * entry['first_call_sec']:.3f} ms); "
          f"host metrics (_quality: mse, spectral distance, SI-SNR, STOI, "
          f"eSTOI, NSIM, BSD per clip) {host[0]:.3f} s; evaluate() wall "
          f"{wall:.3f} s; peak memory {peak_gb:.3f} GB; launches {launches}",
          flush=True)
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] == 0:
            raise AssertionError(f"{kernel} was not launched evaluating")
    return launches


def check_evaluator_against_cpu(device: torch.device, workdir: Path) -> None:
    """The frontier-v2 run's checkpoint evaluated in float32 at NFE 1 on 2
    clips of 4096 samples, on the card and on the CPU with the same start
    noise: the decoded audio within relative L2 1e-5."""
    from meanflow_audio_codec_torch.evaluators import ComprehensiveEvaluator
    from meanflow_audio_codec_torch.tools.evaluate_all import (
        find_checkpoint_for,
    )

    config = load_config(workdir / "config.json")
    config = dataclasses.replace(
        config, precision="float32",
        tokenization_config={**config.tokenization_config,
                             "frame_size": 4096})
    clips = synth_audio(2, 4096, torch.Generator(device).manual_seed(21),
                        device).cpu().numpy()
    rows = 2 * num_frames_for_length(4096, 512, 256)
    noise = {1: torch.randn(rows, config.noise_dimension,
                            generator=torch.Generator().manual_seed(22))}
    decoded = []  # the card's, then the CPU's
    for where in (device, torch.device("cpu")):
        evaluator = ComprehensiveEvaluator(find_checkpoint_for(config),
                                           config, nfe_list=[1],
                                           timing_runs=0, device=where)
        quality = evaluator._quality

        def keep(real, generated, quality=quality):
            decoded.append(generated)
            return quality(real, generated)

        evaluator._quality = keep
        evaluator.evaluate(clips, noise=noise)
    got, ref = (torch.from_numpy(d).double() for d in decoded)
    rel = ((got - ref).norm() / ref.norm()).item()
    print(f"evaluator float32 NFE 1, 2 clips x 4096 ({rows} rows), card vs "
          f"CPU: decoded audio {tuple(got.shape)}, relative L2 {rel:.3e}",
          flush=True)
    if not rel <= TRAIN_REL_L2 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"evaluator card vs CPU: relative L2 {rel:.3e}")


def export_path(device: torch.device, card: str, workdir: Path,
                scratch: Path) -> dict:
    """``tools/export_serving`` on the frontier-v2 workdir, then
    ``AudioCodec.from_workdir`` on a copy holding only its serving file
    decodes a clip exactly as the full checkpoint's EMA does; then
    ``tools/export_samples --num-clips 2`` with the WAV names checked.
    Returns the launch counts."""
    from meanflow_audio_codec_torch.tools import export_samples, export_serving

    zero_launches()
    t0 = time.perf_counter()
    if export_serving.main(["--workdir", str(workdir)]) != 0:
        raise AssertionError("export_serving main failed")
    export_s = time.perf_counter() - t0
    serving = sorted(workdir.glob("checkpoints/serving_step_*.msgpack"))[-1]
    only = scratch / "exported_serving_only"
    (only / "checkpoints").mkdir(parents=True)
    shutil.copy(workdir / "config.json", only)
    shutil.copy(serving, only / "checkpoints")
    clip = synth_audio(1, CLIP_LEN, torch.Generator(device).manual_seed(23),
                       device)
    outs = [AudioCodec.from_workdir(path).roundtrip(
        clip, generator=torch.Generator(device).manual_seed(24))
            for path in (workdir, only)]
    if not torch.equal(*outs):
        raise AssertionError("the exported serving file does not decode as "
                             "the full checkpoint's EMA")
    out_dir = scratch / "samples"
    if export_samples.main(["--workdir", str(workdir), "--num-clips", "2",
                            "--out-dir", str(out_dir)]) != 0:
        raise AssertionError("export_samples main failed")
    sidecar = json.loads((out_dir / "export_samples.json").read_text())
    names = sorted(p.name for p in out_dir.glob("*.wav"))
    want = sorted([f"heldout_{i}_{kind}.wav" for i in range(2)
                   for kind in ("original", "recon_nfe1")]
                  + [f"bitstream_{i}_original.wav" for i in range(2)]
                  + [f"bitstream_{i}_recon_{row['kbps_measured']:.0f}kbps.wav"
                     for i, row in enumerate(sidecar["bitstream"])])
    if names != want or set(sidecar) != {"workdir", "nfe", "num_clips",
                                         "frame_size", "heldout",
                                         "bitstream"}:
        raise AssertionError(f"export_samples wrote {names}, sidecar "
                             f"{sorted(sidecar)}")
    launches = read_launches()
    print(f"[{card}] export_serving {serving.name} "
          f"({serving.stat().st_size / 1e6:.1f} MB) in {export_s:.2f} s, "
          f"served alone it decodes as the full checkpoint's EMA (bit for "
          f"bit); export_samples: {names}; launches {launches}", flush=True)
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] == 0:
            raise AssertionError(f"{kernel} was not launched exporting")
    return launches


def evaluate_all_path(device: torch.device, card: str, corpus_run: Path,
                      mnist_run: Path, scratch: Path) -> dict:
    """``tools/evaluate_all`` through ``main`` over a directory holding two
    configs: the corpus phase's run (its held-out clips from the corpus, at
    ``seed+1``) and the ablation run of path C (MNIST, image metrics), NFE 1
    and 2 at 16 examples; one CSV row per config and NFE. Returns the
    launch counts."""
    from meanflow_audio_codec_torch.tools import evaluate_all

    configs_dir = scratch / "eval_configs"
    configs_dir.mkdir()
    for name, run in (("corpus_run", corpus_run),
                      ("ablation_large", mnist_run)):
        shutil.copy(run / "config.json", configs_dir / f"{name}.json")
    csv_path = scratch / "metrics.csv"
    zero_launches()
    t0 = time.perf_counter()
    if evaluate_all.main(["--configs", str(configs_dir), "--nfe", "1", "2",
                          "--num-samples", "16", "--timing-runs", "1",
                          "--csv", str(csv_path)]) != 0:
        raise AssertionError("evaluate_all main failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    lines = csv_path.read_text().splitlines()
    rows = [line.split(",")[:6] for line in lines[1:]]
    want = [[name, method, arch, dataset, tok, nfe]
            for name, method, arch, dataset, tok in (
                ("ablation_large", "mean_flow", "mlp", "mnist", "reshape"),
                ("corpus_run", "improved_mean_flow", "convnet", "audio",
                 "mdct"))
            for nfe in ("1", "2")]
    if sorted(rows) != sorted(want):
        raise AssertionError(f"evaluate_all rows {rows}")
    for name, run in (("corpus_run", corpus_run),
                      ("ablation_large", mnist_run)):
        results = json.loads((run / "evaluation_results.json").read_text())
        _finite_numbers(results, name)
        entry = results["nfe_sweep"]["1"]
        metric = ("si_snr_db", "stoi") if name == "corpus_run" else (
            "psnr_db", "ssim")
        print(f"[{card}] evaluate_all {name}: {results['param_count']} "
              f"parameters, nfe 1 sampling "
              f"{1e3 * entry['inference']['mean_sec']:.3f} ms, mse "
              f"{entry['mse']:.5f}, {metric[0]} {entry[metric[0]]:.4f}, "
              f"{metric[1]} {entry[metric[1]]:.4f}", flush=True)
    print(f"[{card}] evaluate_all: {len(rows)} CSV rows (2 configs x 2 NFE) "
          f"in {wall:.1f} s; launches {launches}", flush=True)
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] == 0:
            raise AssertionError(f"{kernel} was not launched in evaluate_all")
    return launches


def flag_trainer_path(device: torch.device, card: str,
                      scratch: Path) -> dict:
    """The flag-driven trainer: ``python -m meanflow_audio_codec_torch.train
    --dataset audio --method improved_mean_flow --architecture convnet
    --architecture-options <frontier_v2's> --condition-dimension 256
    --latent-dimension 256 --num-blocks 8 --frame-size 32768 --window-size
    512 --coeff-scale 4 --batch-size 16 --n-steps 16 --steps-per-call 8
    --precision bfloat16`` through ``main``, without ``--config`` (the
    device pool cut from 1024 clips to 64, as in the trainer phase). Checks
    every step finite, ``config.json`` holding the flags' values and the
    tokenized width (1024 where ``create_audio_config`` says 196608), and
    the JAX package's parameter count of frontier-v2. Returns the launch
    counts."""
    workdir = scratch / "flag_run"
    frontier = load_config(CONFIG)
    tok = frontier.tokenization_config
    flags = {"--dataset": "audio", "--method": "improved_mean_flow",
             "--architecture": "convnet",
             "--architecture-options": json.dumps(
                 frontier.architecture_options),
             "--condition-dimension": str(frontier.condition_dimension),
             "--latent-dimension": str(frontier.latent_dimension),
             "--num-blocks": str(frontier.num_blocks),
             "--frame-size": str(CLIP_LEN),
             "--window-size": str(tok["window_size"]),
             "--coeff-scale": f"{tok['coeff_scale']:g}",
             "--batch-size": str(TRAIN_CLIPS), "--n-steps": "16",
             "--steps-per-call": "8", "--precision": frontier.precision,
             "--device-pool-clips": "64", "--workdir": str(workdir)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    if train_cli.main([a for kv in flags.items() for a in kv]) != 0:
        raise AssertionError("flag-driven train main failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [r for r in records if r.get("event") == "start"]
    steps = [r for r in records if "event" not in r]
    if [r["step"] for r in steps] != list(range(16)) or not all(
            math.isfinite(r["loss"]) for r in steps):
        raise AssertionError(f"flag run steps {steps}")
    if starts[0]["param_count"] != FRONTIER_PARAMS:
        raise AssertionError(f"flag run: {starts[0]['param_count']} "
                             f"parameters, frontier-v2 has {FRONTIER_PARAMS}")
    saved = json.loads((workdir / "config.json").read_text())
    model, tok_saved = saved["model"], saved["dataset"]["tokenization_config"]
    got = (saved["dataset"]["dataset"], saved["method"]["method"],
           saved["method"]["use_improved_mean_flow"], model["architecture"],
           model["architecture_options"], model["condition_dimension"],
           model["latent_dimension"], model["num_blocks"],
           model["noise_dimension"], tok_saved["frame_size"],
           tok_saved["window_size"], tok_saved["coeff_scale"],
           tok_saved["device_pool_clips"], saved["base"]["batch_size"],
           saved["base"]["n_steps"], saved["tpu"]["steps_per_call"],
           saved["tpu"]["precision"])
    want = ("audio", "improved_mean_flow", True, "convnet",
            frontier.architecture_options, frontier.condition_dimension,
            frontier.latent_dimension, frontier.num_blocks,
            frontier.noise_dimension, CLIP_LEN, tok["window_size"],
            tok["coeff_scale"], 64, TRAIN_CLIPS, 16, 8, frontier.precision)
    if got != want:
        raise AssertionError(f"flag run config.json {got}, flags {want}")
    chunk_ms = [1e3 * steps[i]["step_time"] for i in (0, 8)]
    print(f"[{card}] flag-driven trainer (no --config; frontier-v2 widths, "
          f"{int(starts[0]['param_count'])} params as JAX counts them, "
          f"effective "
          f"noise dimension {model['noise_dimension']}): chunk time per step "
          f"{chunk_ms[0]:.3f} / {chunk_ms[1]:.3f} ms (the first includes "
          f"the start), last loss {steps[-1]['loss']:.6f}, peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB, wall "
          f"{wall:.1f} s; launches {launches}", flush=True)
    if launches["mdct_cuda"] < 16:
        raise AssertionError("the flag-driven run did not tokenize on the "
                             "MDCT kernel at every step")
    return launches


def _on_tape_jvp(model, z, tz, t, r, latents, differentiable):
    """The stop-gradient JVP as the port ran it up to PR 8's tree: one
    dual forward on the autograd tape, du/dt detached after it (the tape
    probe's yardstick; ``objectives._jvp`` is the port's)."""
    import torch.autograd.forward_ad as fwAD

    from meanflow_audio_codec_torch.training.objectives import _time_pair

    with fwAD.dual_level(), stage.differentiable_tangents(differentiable):
        z_dual = fwAD.make_dual(z, tz.to(z.dtype))
        t_dual = fwAD.make_dual(t, torch.ones_like(t))
        out = fwAD.unpack_dual(model(z_dual, _time_pair(t_dual, t_dual - r),
                                     latents))
        return out.primal, out.tangent


def jvp_tape_probe(device: torch.device, card: str) -> None:
    """Peak memory and ms of bare bf16 iMF steps with the stop-gradient
    tangent off the autograd tape (the port) and on it (``_on_tape_jvp``):
    path A's MLP-Mixer codec at ``JVP_PROBE_CLIPS`` clips of 65536 samples
    (each way up to its first out-of-memory), and the frontier-v2 step
    (16 clips x 32768, the config's remat) with ``fused_stage`` off and
    on."""
    from meanflow_audio_codec_torch.training import objectives
    from meanflow_audio_codec_torch.training.trainer import (
        effective_noise_dimension,
    )

    port_jvp = objectives._jvp
    gen = torch.Generator(device=device).manual_seed(21)
    config = load_config(FAMILY_RUNS["mixer_codec"][0])
    # the trainer's width: the noise of one frame (W 512 stereo)
    config = dataclasses.replace(
        config, noise_dimension=effective_noise_dimension(config))
    cases = [(f"mixer codec, {clips} clip(s)", clips)
             for clips in JVP_PROBE_CLIPS]
    cases += [(f"frontier_v2, fused_stage {'on' if fused else 'off'}", fused)
              for fused in (False, True)]
    for tape, jvp in (("off the tape (the port)", port_jvp),
                      ("on the tape (PR 8's)", _on_tape_jvp)):
        objectives._jvp = jvp
        full = False
        try:
            for label, arg in cases:
                if label.startswith("mixer"):
                    if full:
                        continue
                    model = create_flow_model(
                        config, generator=torch.Generator().manual_seed(0))
                    state = TrainState(model, make_optimizer(config),
                                       config.ema_decay, device=device)
                    adapter = adapter_from_config(
                        config, create_tokenization_strategy(
                            config.tokenization_strategy,
                            config.tokenization_config))
                    # the guard on, as in frontier-v2, for ``update_ok``
                    step = make_train_step(create_loss_strategy(config),
                                           adapter, remat=config.remat,
                                           skip_nonfinite=True)
                    batch = synth_audio(arg, 65536, gen, device)
                else:
                    state, step = train_setup(device, fused=arg,
                                              precision="bfloat16")
                    batch = synth_audio(TRAIN_CLIPS, CLIP_LEN, gen, device)
                try:
                    _bare_steps(state, step, batch, gen,
                                f"tape probe, {label}, tangent {tape}", card)
                except torch.cuda.OutOfMemoryError:
                    print(f"[{card}] tape probe, {label}, tangent {tape}: "
                          "out of memory", flush=True)
                    full = label.startswith("mixer")
                del state, step, batch
                torch.cuda.empty_cache()
        finally:
            objectives._jvp = port_jvp


# ---------------------------------------------------------------------------
# transform gradients, W8A8 int8 serving, the simple trainer (phases 3a,
# 8a, 9b)
# ---------------------------------------------------------------------------


def check_transform_gradients(device: torch.device, results: dict) -> dict:
    """``x.grad`` through ``mdct_cuda`` and ``imdct_cuda`` at the codec
    shape (8 rows x 32768 samples, W 512, hop 256) against the plain
    version's autograd on the card (rtol 1e-4 / atol 1e-3); each backward
    launches the other kernel once; backward ms (``backward_ms``, the plain
    version's ``plain_backward_ms``) beside the forward's. Then the path:
    ``MDCTLayer -> IMDCTLayer`` on a stereo batch with a finite, nonzero
    gradient, its launches returned."""
    from meanflow_audio_codec_torch.ops.mdct_layers import IMDCTLayer, MDCTLayer

    cfg = MDCTConfig(512, 256)
    gen = torch.Generator(device).manual_seed(20)
    nf = num_frames_for_length(32768, 512, 256)
    cases = {"mdct_cuda": (mdct_cuda, mdct, (8, 32768), imdct_cuda_mod),
             "imdct_cuda": (imdct_cuda, imdct, (8, nf, 512), mdct_cuda_mod)}
    for name, (kernel, plain, shape, other) in cases.items():
        x = torch.randn(shape, generator=gen, device=device)
        grads, times = [], []
        for fn in (kernel, plain):
            a = x.clone().requires_grad_(True)
            y = fn(a, cfg)
            cot = torch.randn(y.shape, device=device,
                              generator=torch.Generator(device).manual_seed(21))
            before = other.launches
            (grad,) = torch.autograd.grad(y, a, cot, retain_graph=True)
            torch.cuda.synchronize()
            if fn is kernel and other.launches != before + 1:
                raise AssertionError(f"{name}'s backward did not launch "
                                     f"{other.__name__.split('.')[-1]}")
            grads.append(grad)
            times.append(time_ms(lambda: torch.autograd.grad(
                y, a, cot, retain_graph=True)))
        abs_err, rel_err = _errors(grads[0], grads[1])
        if not grads[0].abs().max() > 0:
            raise AssertionError(f"{name}: zero gradient on the card")
        torch.testing.assert_close(grads[0], grads[1], rtol=RTOL, atol=ATOL)
        res = results[name]
        res["backward_ms"], res["plain_backward_ms"] = times
        res["backward_max_abs_err"] = abs_err
        print(f"{name} backward, codec shape {tuple(shape)}: x.grad against "
              f"the plain version's autograd max_abs_err {abs_err:.3e} "
              f"max_rel_err {rel_err:.3e} (rtol {RTOL}, atol {ATOL}); "
              f"backward {times[0]:.4f} ms (plain {times[1]:.4f} ms) beside "
              f"forward {res['ms']:.4f} ms", flush=True)

    stereo = torch.randn(4, 32768, 2, generator=gen, device=device,
                         requires_grad=True)
    layers = (MDCTLayer(512, 256), IMDCTLayer(512, 256))
    zero_launches()
    layers[1](layers[0](stereo)).square().sum().backward()
    torch.cuda.synchronize()
    launches = read_launches()
    if not (torch.isfinite(stereo.grad).all() and stereo.grad.abs().max() > 0):
        raise AssertionError("MDCTLayer -> IMDCTLayer: gradient not finite "
                             "or zero")
    print(f"MDCTLayer -> IMDCTLayer on the card, 4 stereo clips x 32768: "
          f"finite nonzero gradient; launches {launches}", flush=True)
    for kernel in ("mdct_cuda", "imdct_cuda"):
        if launches[kernel] != 2:
            raise AssertionError(f"{kernel}: {launches[kernel]} launches on "
                                 "the layers' forward and backward, not 2")
    return launches


def _int8_shapes(codec: AudioCodec, latents, gains) -> list:
    """The (rows, K, N) of each int8 product of one decode."""
    shapes = []
    product = quant._int_product

    def record(a, w):
        shapes.append((a.shape[0], a.shape[1], w.shape[0]))
        return product(a, w)

    quant._int_product = record
    try:
        codec.decode(latents, gains=gains,
                     generator=torch.Generator(codec.device).manual_seed(0))
    finally:
        quant._int_product = product
    return shapes


def int8_product_times(shapes: list, card: str, label: str) -> dict:
    """One decoder call's int8 products (``torch._int_mm``) timed with CUDA
    events at their shapes, beside the bf16 GEMMs they replace (one
    ``F.linear`` each) and their bound: 2 M K N operations at the dense int8
    peak (1979 TOPS) against the int8 operands read and the int32 result
    written at 3.35 TB/s, per distinct shape, times its count."""
    gen = torch.Generator("cuda").manual_seed(22)
    total = dict(ms=0.0, bf16_ms=0.0, bound_ms=0.0)
    bound_by = collections.Counter()
    for (rows, k, n), count in collections.Counter(shapes).items():
        a = torch.randint(-127, 128, (rows, k), generator=gen,
                          device="cuda").to(torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen,
                          device="cuda").to(torch.int8)
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ms = time_ms(lambda: quant.int_product_card(a, w))
        bf16_ms = time_ms(lambda: F.linear(ab, wb))
        t_ops = 2.0 * rows * k * n / PEAK_INT8_OPS
        t_bytes = (rows * k + k * n + 4.0 * rows * n) / PEAK_BYTES_PER_S
        total["ms"] += count * ms
        total["bf16_ms"] += count * bf16_ms
        total["bound_ms"] += count * 1e3 * max(t_ops, t_bytes)
        bound_by["operations" if t_ops >= t_bytes else "bytes"] += count
        print(f"[{card}] int8 product {label} M={rows} K={k} N={n} x{count}: "
              f"_int_mm {ms:.4f} ms, bf16 F.linear {bf16_ms:.4f} ms, bound "
              f"{1e3 * max(t_ops, t_bytes):.4f} ms", flush=True)
    total["bound_by"] = dict(bound_by)
    return total


def quantized_serving_path(device: torch.device, card: str, workdir: Path,
                           scratch: Path, bf16: AudioCodec) -> dict:
    """Serve the trainer phase's run through the W8A8 int8 decoder
    (``AudioCodec.from_workdir(..., quantized=True)``) beside its bf16
    codec ``bf16`` on the same checkpoint: the same parameters and
    config.json left as it was; a 10 s clip's round trip and its v1 8-bit
    bytes decoded within relative L2 0.05 of bf16's (same noise), the
    encoder's bytes equal; per quantized call one MDCT launch an encode,
    one IMDCT launch and 72 int8 products a decode, none in the encoder
    (the bf16 reference runs after the counted window); decode ms of
    both at the 10 s clip (1721 rows) and the round trip's batch (4 clips x
    32768, 508 rows), in turns bf16, int8, int8, bf16; the int8 products'
    time; ``codec_cli decode --quantized``; ``evaluate_all --quantized`` at
    16 examples, NFE 1; a streaming run of 6 pushes (16 rows each: the
    padded ``_int_mm``). Returns the launch counts of the served round trip
    and bytes, of the CLI, of ``evaluate_all`` and of the streaming run,
    each counted alone."""
    from meanflow_audio_codec_torch.tools import codec_cli, evaluate_all

    on_disk = (workdir / "config.json").read_bytes()
    codec = AudioCodec.from_workdir(workdir, quantized=True)
    _same_weights(codec, bf16.model.state_dict(), "the quantized load")
    gen = torch.Generator(device).manual_seed(13)
    requests = {"10 s clip": synth_audio(1, 10 * SAMPLE_RATE, gen, device),
                "4 clips x 32768": synth_audio(4, 32768, gen, device)}
    for audio in requests.values():  # warm-up: plans at these row counts
        codec.roundtrip(audio, generator=gen)
    torch.cuda.synchronize()

    def expect(call: str, mdct_n: int, imdct_n: int, products: int) -> None:
        """The launches and int8 products since the window opened."""
        got = (mdct_cuda_mod.launches, imdct_cuda_mod.launches,
               quant.int8_products)
        if got != (mdct_n, imdct_n, products):
            raise AssertionError(
                f"after the quantized {call}: MDCT, IMDCT launches and int8 "
                f"products {got}, not {(mdct_n, imdct_n, products)}")

    clip = requests["10 s clip"]
    zero_launches()
    quant.int8_products = 0
    latents, gains = codec.encode_with_gains(clip)
    expect("encode", 1, 0, 0)
    out = codec.decode(latents, gains=gains,
                       generator=torch.Generator(device).manual_seed(4))
    expect("decode", 1, 1, INT8_PRODUCTS_PER_DECODE)
    q_data = codec.encode_bytes(clip, bits=8)
    expect("encode_bytes", 2, 1, INT8_PRODUCTS_PER_DECODE)
    q_bytes = codec.decode_bytes(q_data, generator=gen.manual_seed(5))
    expect("decode_bytes", 2, 2, 2 * INT8_PRODUCTS_PER_DECODE)
    torch.cuda.synchronize()
    launches = read_launches()
    # the bf16 reference, outside the counted window
    ref = bf16.decode(latents, gains=gains,
                      generator=torch.Generator(device).manual_seed(4))
    data = bf16.encode_bytes(clip, bits=8)
    if q_data != data:
        raise AssertionError("the quantized codec's encoder bytes differ "
                             "from bf16's")
    b_bytes = bf16.decode_bytes(data, generator=gen.manual_seed(5))
    errors = {"round trip": _rel_l2(out, ref), "bytes": _rel_l2(q_bytes,
                                                                b_bytes)}
    for what, (abs_err, rel) in errors.items():
        print(f"[{card}] int8 vs bf16 decode, 10 s clip, {what}: "
              f"max_abs_err {abs_err:.3e} rel_l2 {rel:.4e} "
              f"(<= {QUANT_REL_L2})", flush=True)
        if not (rel <= QUANT_REL_L2 and torch.isfinite(out).all()):
            raise AssertionError(f"int8 decode off bf16's: {what} {rel}")
    print(f"[{card}] quantized serving: {INT8_PRODUCTS_PER_DECODE} int8 "
          f"products and one IMDCT launch per decoder call, one MDCT launch "
          f"per encode, no int8 product in the encoder; launches "
          f"{launches}", flush=True)

    for name, audio in requests.items():
        lat, gn = bf16.encode_with_gains(audio)
        times = {"bf16": [], "int8": []}
        for which in ("bf16", "int8", "int8", "bf16"):
            served = codec if which == "int8" else bf16
            ms, _ = _wall_ms(lambda: served.decode(
                lat, gains=gn, generator=gen.manual_seed(6)), REPEATS)
            times[which].append(ms)
        rows = lat.shape[0] * lat.shape[1]
        print(f"[{card}] decode ms, {name} ({rows} rows), medians of "
              f"{REPEATS} in turns bf16/int8/int8/bf16: bf16 "
              f"{times['bf16'][0]:.3f}, {times['bf16'][1]:.3f}; int8 "
              f"{times['int8'][0]:.3f}, {times['int8'][1]:.3f}", flush=True)
        products = int8_product_times(_int8_shapes(codec, lat, gn), card,
                                      name)
        print(f"[{card}] int8 products of one decoder call, {name}: "
              f"{products['ms']:.4f} ms (the bf16 GEMMs at the same shapes "
              f"{products['bf16_ms']:.4f} ms), bound "
              f"{products['bound_ms']:.4f} ms ({products['bound_by']})",
              flush=True)

    def counted(label: str, kernels: tuple, fn) -> dict:
        """Run ``fn`` in a launch window of its own; every kernel in
        ``kernels`` must launch and the int8 decoder must run."""
        zero_launches()
        quant.int8_products = 0
        fn()
        torch.cuda.synchronize()
        counts = read_launches()
        for kernel in kernels:
            if counts[kernel] == 0:
                raise AssertionError(f"{kernel} was not launched by "
                                     f"{label}")
        if quant.int8_products == 0:
            raise AssertionError(f"{label} ran no int8 product")
        return counts

    macb, wav = scratch / "int8.macb", scratch / "int8.wav"
    macb.write_bytes(data)

    def cli_decode() -> None:
        if codec_cli.main(["decode", str(macb), "--workdir", str(workdir),
                           "--quantized", "-o", str(wav)]) != 0:
            raise AssertionError("codec_cli decode --quantized failed")

    paths = {"quantized_serving": launches,
             "quantized_cli": counted("codec_cli decode --quantized",
                                      ("imdct_cuda",), cli_decode)}
    frames, channels, rate = _read_wav(wav)
    if quant.int8_products != INT8_PRODUCTS_PER_DECODE or channels != 2:
        raise AssertionError(f"codec_cli decode --quantized: "
                             f"{quant.int8_products} int8 products, "
                             f"{channels} channels")
    print(f"codec_cli decode --quantized: {frames} frames x {channels} at "
          f"{rate} Hz, {quant.int8_products} int8 products; launches "
          f"{paths['quantized_cli']}", flush=True)

    configs_dir = scratch / "int8_configs"
    configs_dir.mkdir()
    shutil.copy(workdir / "config.json", configs_dir / "frontier_v2.json")
    csv_path = scratch / "int8_metrics.csv"
    t0 = time.perf_counter()
    paths["quantized_evaluate_all"] = counted(
        "evaluate_all --quantized", ("mdct_cuda", "imdct_cuda"),
        lambda: evaluate_all.main([
            "--configs", str(configs_dir), "--quantized", "--nfe", "1",
            "--num-samples", "16", "--timing-runs", "1", "--csv",
            str(csv_path), "--results-name", "evaluation_results_int8.json"]))
    results = json.loads((workdir / "evaluation_results_int8.json"
                          ).read_text())
    _finite_numbers(results, "evaluate_all --quantized")
    entry = results["nfe_sweep"]["1"]
    if len(csv_path.read_text().splitlines()) != 2:
        raise AssertionError("evaluate_all --quantized wrote no row")
    print(f"[{card}] evaluate_all --quantized, 16 clips, NFE 1: "
          f"{time.perf_counter() - t0:.1f} s, sampling "
          f"{1e3 * entry['inference']['mean_sec']:.3f} ms, si_snr_db "
          f"{entry['si_snr_db']:.3f}, {quant.int8_products} int8 products; "
          f"launches {paths['quantized_evaluate_all']}", flush=True)

    duplex = codec.streaming(seed=0)
    outs = []
    paths["quantized_streaming"] = counted(
        "quantized streaming", ("mdct_cuda", "imdct_cuda"),
        lambda: outs.extend(duplex.push(clip[:, i:i + STREAM_CHUNK])
                            for i in range(0, 6 * STREAM_CHUNK,
                                           STREAM_CHUNK)))
    pushed = torch.cat(outs, dim=1)
    if not torch.isfinite(pushed).all():
        raise AssertionError("quantized streaming: not finite")
    print(f"[{card}] quantized streaming, 6 pushes of {STREAM_CHUNK} "
          f"samples: {pushed.shape[1]} samples out, finite, "
          f"{quant.int8_products} int8 products (rows <= 16 padded); "
          f"launches {paths['quantized_streaming']}", flush=True)
    if (workdir / "config.json").read_bytes() != on_disk:
        raise AssertionError("quantized serving changed config.json")
    return paths


#: the timing tools' parameter counts, as the JAX package counts the same
#: geometries (tests/test_torch_benchmarks.py holds them against it)
TIMING_PARAMS = {"ch256_s8_lift32": 36_335_428,
                 "ch512_s8_lift64_bn1024_b2048_dots": 118_042_692,
                 "ch512_s8_lift64_bn1024_b2048_dots_fused": 118_042_692}
#: the rates and times in the tools' rows: finite and positive on the card
_TIMED_KEY = re.compile(r"^ms_|(ms|sec|rtf|tops|tflops|mfu|speedup)$")
#: the phase's cuts (the tools' own defaults otherwise), for its time: the
#: sampler's NFE 50 and 250 (26 s), the MF-vs-iMF script's 400 steps, the codec
#: A/B's 4 rounds (14 s a round at ch512), the int8 probes' 3 repeats (the
#: stage probe's and the int8 conv's to 1: 19.3 and 6.9 s at 2)
TIMING_CUTS = {"benchmark_sampler": ["--nfe", "1", "10"],
               "benchmark_train_objectives": ["--steps", "10"],
               "benchmark_meanflow_vs_improved": ["--steps", "20"],
               "probe_codec_ab": ["--rounds", "1"],
               "probe_int8": ["--repeats", "1"],
               "probe_int8_conv": ["--repeats", "1"],
               "probe_stage_q": ["--repeats", "1"]}
#: cuts of the tools' module constants, set for the phase: the codec
#: geometry's timed groups (3 x 10 calls: 32.0 s int8) and the A/B's calls
#: a side per round (5: 17.5 s at 1 round)
TIMING_CONSTANTS = {
    "meanflow_audio_codec_torch.tools.benchmarks.benchmark_codec_geometry":
        {"GROUPS": 1},
    "meanflow_audio_codec_torch.tools.probes.probe_codec_ab": {"CALLS": 2}}


@contextlib.contextmanager
def cut_tool_constants():
    """``TIMING_CONSTANTS`` set on their modules, restored on exit."""
    import importlib

    kept = {}
    try:
        for name, constants in TIMING_CONSTANTS.items():
            module = importlib.import_module(name)
            for constant, value in constants.items():
                kept[module, constant] = getattr(module, constant)
                setattr(module, constant, value)
                print(f"--- {name.rsplit('.', 1)[1]}.{constant} cut from "
                      f"{kept[module, constant]} to {value}", flush=True)
        yield
    finally:
        for (module, constant), value in kept.items():
            setattr(module, constant, value)


def run_tool(card: str, module, *argv: str) -> list[dict]:
    """A timing tool's ``main`` in-process on the card: its output echoed,
    its JSON rows returned. Fails on a return code other than 0, a first
    line other than the card's, an error row, or a rate or time that is not
    a finite positive number."""
    name = module.__name__.rsplit(".", 1)[1]
    cut = TIMING_CUTS.get(name, [])
    argv = list(argv) + cut
    print(f"--- {name} {' '.join(argv)}"
          f"{' (cut from the defaults: ' + ' '.join(cut) + ')' if cut else ''}",
          flush=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    text = out.getvalue()
    print(text, end="", flush=True)
    print(f"--- {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    lines = text.splitlines()
    if rc != 0 or not lines or lines[0] != card:
        raise AssertionError(f"{name}: rc {rc}, first line {lines[:1]}")
    rows = [json.loads(line) for line in lines[1:] if line.startswith("{")]
    for row in rows:
        if "error" in row:
            raise AssertionError(f"{name}: error row {row}")
        for key, value in row.items():
            if _TIMED_KEY.search(key) and not (
                    isinstance(value, (int, float)) and math.isfinite(value)
                    and value > 0):
                raise AssertionError(f"{name}: {key} = {value!r} in {row}")
    if not rows:
        raise AssertionError(f"{name}: no rows")
    return rows


def _expect(path: str, launches: dict, **counts: int) -> None:
    for kernel, want in counts.items():
        got = launches[kernel]
        if got != want:
            raise AssertionError(f"{path}: {kernel} launched {got} times, "
                                 f"expected {want}")


def timing_tools_phase(card: str, scratch: Path) -> dict:
    """Every ported timing tool through its ``main`` on the card (phase 12d);
    returns the launch counts of each tool that launches a kernel."""
    from meanflow_audio_codec_torch.tools.benchmarks import (
        benchmark_audio_decoders,
        benchmark_audio_loader,
        benchmark_codec_geometry,
        benchmark_conv_mfu,
        benchmark_mdct,
        benchmark_meanflow_vs_improved,
        benchmark_pipeline_stages,
        benchmark_prefetch,
        benchmark_sampler,
        benchmark_streaming,
        benchmark_train_objectives,
        benchmark_vs_torch,
    )
    from meanflow_audio_codec_torch.tools.probes import (
        probe_codec_ab,
        probe_hlo,
        probe_int8,
        probe_int8_conv,
        probe_stage_q,
    )

    paths = {}
    none = dict(mdct_cuda=0, imdct_cuda=0, ln_film_cuda=0, ln_norm_cuda=0,
                gelu_grn_cuda=0)

    def counted(label: str, module, *argv: str) -> list[dict]:
        zero_launches()
        quant.int8_products = 0
        rows = run_tool(card, module, *argv)
        torch.cuda.synchronize()
        paths[label] = read_launches()
        paths[label]["int8_products"] = quant.int8_products
        print(f"{label} launches: {paths[label]}", flush=True)
        torch.cuda.empty_cache()
        return rows

    # the MDCT: each config's kernel column checked, warmed up and timed
    counted("timing_mdct", benchmark_mdct)
    _expect("timing_mdct", paths["timing_mdct"], **dict(
        none, mdct_cuda=len(benchmark_mdct.CONFIGS)
        * (benchmark_mdct.ITERS + 2)))

    # the codec geometry, bf16 and W8A8: one MDCT and one IMDCT a call (a
    # warm-up, then the timed groups)
    calls = 1 + benchmark_codec_geometry.GROUPS * benchmark_codec_geometry.ITERS
    for label, extra in (("timing_codec_geometry", ()),
                         ("timing_codec_geometry_int8", ("--quantized",))):
        (row,) = counted(label, benchmark_codec_geometry, "--configs",
                         "ch256_s8_lift32", *extra)
        _expect(label, paths[label], **dict(none, mdct_cuda=calls,
                                            imdct_cuda=calls))
        want = INT8_PRODUCTS_PER_DECODE * calls if extra else 0
        if paths[label]["int8_products"] != want:
            raise AssertionError(f"{label}: {paths[label]['int8_products']} "
                                 f"int8 products, expected {want}")
        if row["params_m"] != round(TIMING_PARAMS["ch256_s8_lift32"] / 1e6,
                                    1):
            raise AssertionError(f"{label}: params_m {row['params_m']}")

    # the train step's MFU: the fused row through the stage kernels only
    for config in ("ch512_s8_lift64_bn1024_b2048_dots",
                   "ch512_s8_lift64_bn1024_b2048_dots_fused"):
        label = ("timing_conv_mfu_fused" if config.endswith("_fused")
                 else "timing_conv_mfu")
        (row,) = counted(label, benchmark_conv_mfu, "--configs", config)
        launches = paths[label]
        stages = [launches[k] for k in ("ln_film_cuda", "ln_norm_cuda",
                                        "gelu_grn_cuda")]
        if (launches["mdct_cuda"] or launches["imdct_cuda"]
                or (min(stages) == 0 if label.endswith("fused")
                    else max(stages) != 0)):
            raise AssertionError(f"{label}: launches {launches}")
        if row["params_m"] != round(TIMING_PARAMS[config] / 1e6, 1):
            raise AssertionError(f"{label}: params_m {row['params_m']}")

    # streaming: each push encodes and decodes a chunk (3 warm-up pushes,
    # then the timed ones)
    pushes = 32
    counted("timing_streaming", benchmark_streaming, "--configs",
            "light_ch256", "--chunk-seconds", "0.1", "--pushes", str(pushes))
    _expect("timing_streaming", paths["timing_streaming"], **dict(
        none, mdct_cuda=3 + pushes, imdct_cuda=3 + pushes))

    # the samplers and objectives (MLP flows: no kernel on their path)
    for module in (benchmark_sampler, benchmark_train_objectives,
                   benchmark_meanflow_vs_improved):
        counted("timing_" + module.__name__.rsplit(".", 1)[1], module)

    # the int8 probes, then the kernels of one quantized codec call
    for module in (probe_int8, probe_int8_conv, probe_stage_q):
        run_tool(card, module)
    counted("timing_probe_codec_ab", probe_codec_ab)
    rounds = int(TIMING_CUTS["probe_codec_ab"][1])
    side_calls = 1 + rounds * probe_codec_ab.CALLS  # a warm-up, the rounds
    _expect("timing_probe_codec_ab", paths["timing_probe_codec_ab"], **dict(
        none, mdct_cuda=2 * side_calls, imdct_cuda=2 * side_calls,
        int8_products=INT8_PRODUCTS_PER_DECODE * side_calls))
    (hlo,) = counted("timing_probe_hlo", probe_hlo)  # a warm-up call, then
    _expect("timing_probe_hlo", paths["timing_probe_hlo"], **dict(
        none, mdct_cuda=2, imdct_cuda=2))             # the profiled one
    # the profiler's count of int8 GEMM kernels is printed, not held: late
    # in this process torch.profiler missed some library kernels (a cuDNN
    # conv, a cuBLAS GEMM) on an H100 host, where the CPU-side op count
    # held
    if not (hlo["int_mm_calls"] == hlo["expected_per_decoder_call"]
            == INT8_PRODUCTS_PER_DECODE):
        raise AssertionError(f"probe_hlo: {hlo}")

    # the host-side data path over a small synthetic corpus
    corpus = scratch / "timing_corpus"
    corpus.mkdir()
    benchmark_pipeline_stages.make_corpus(corpus, 20, seconds=4.0)
    data = ("--data-dir", str(corpus))
    run_tool(card, benchmark_audio_decoders, "--n-files", "8", "--seconds",
             "2.0", "--repeats", "2")
    run_tool(card, benchmark_audio_loader, *data, "--timed", "20")
    run_tool(card, benchmark_pipeline_stages, *data)
    run_tool(card, benchmark_prefetch, *data)
    run_tool(card, benchmark_vs_torch, *data, "--timed", "10")
    return paths


def simple_trainer_path(device: torch.device, card: str) -> None:
    """``training/simple_trainer``: ``train_epoch`` at frontier-v2 width
    (bf16) on the card, 4 flow-matching then 4 iMF steps on seeded token
    batches (2032 rows of 1024, the train step's); finite losses."""
    from meanflow_audio_codec_torch.training import simple_trainer

    config = load_config(CONFIG)
    gen = torch.Generator(device).manual_seed(23)
    batches = [torch.randn(2 * TRAIN_CLIPS * 127, config.noise_dimension,
                           generator=gen, device=device)
               for _ in range(SIMPLE_STEPS)]
    for improved in (False, True):
        state = simple_trainer.create_train_state(
            create_flow_model(config), torch.Generator().manual_seed(0),
            len(batches[0]), device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = simple_trainer.train_epoch(
            state, gen, batches, use_improved_mean_flow=improved)
        seconds = time.perf_counter() - t0
        if not math.isfinite(loss) or state.step != SIMPLE_STEPS:
            raise AssertionError(f"simple trainer: loss {loss}, step "
                                 f"{state.step}")
        print(f"[{card}] simple trainer, {'iMF' if improved else 'FM'}: "
              f"{SIMPLE_STEPS} steps of {len(batches[0])} token rows in "
              f"{seconds:.2f} s (first step included), mean loss "
              f"{loss:.5f}", flush=True)
        del state
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# data-parallel training (phase 15)
# ---------------------------------------------------------------------------

#: the one-rank trainer: two chunks of 16 (the second one timed)
PARALLEL_STEPS = 32
#: the supervised child: seconds of silence before the supervisor restarts
#: it (10 s killed a child still importing torch beside part 1 on a loaded
#: H100 host)
SUPERVISE_STALL = 20
#: the supervised child's first launch hangs once its final full checkpoint
#: is written, before the serving file; ``--resume`` then finishes the run
STALL_CHILD = """
print("child: started", flush=True)
import sys, time
from pathlib import Path
from meanflow_audio_codec_torch import train
from meanflow_audio_codec_torch.training import checkpoints
marker = Path(sys.argv[1])
if not marker.exists():
    marker.write_text("stalled")
    def hang(*args, **kwargs):
        print("child: stalling before the serving checkpoint", flush=True)
        time.sleep(3600)
    checkpoints.save_serving_checkpoint = hang
sys.exit(train.main(sys.argv[2:]))
"""


def _free_address() -> str:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{sock.getsockname()[1]}"


class _Tee(io.StringIO):
    """Keeps what is printed and prints it."""

    def write(self, text: str) -> int:
        sys.__stdout__.write(text)
        return super().write(text)


def _data_parallel_rank(rank: int, address: str, out: str) -> None:
    """One rank of phase 15's two: one float32 step at frontier-v2 width on
    its 8 of the 16 clips, tensors on card 0, the gradient averaged over
    gloo; saves its loss, parameters, first moments and launches."""
    import torch.distributed as dist

    from meanflow_audio_codec_torch.parallel import (
        create_mesh,
        initialize_distributed,
        shard_state,
    )
    from meanflow_audio_codec_torch.parallel.mesh import local_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    initialize_distributed(address, 2, rank, backend="gloo", device=device)
    try:
        state, step = train_setup(device, fused=False, precision="float32",
                                  warmup_steps=0)
        mesh = create_mesh(data=2, model=1, device_type="cuda")
        state = shard_state(state, mesh)
        batch = synth_audio(TRAIN_CLIPS, CLIP_LEN,
                            torch.Generator(device).manual_seed(21), device)
        zero_launches()
        state, metrics = step(state, local_batch(batch, mesh),
                              generator=torch.Generator(device).manual_seed(22))
        torch.cuda.synchronize()
        torch.save({"loss": metrics["loss"].item(),
                    "params": torch.cat([p.detach().reshape(-1).cpu()
                                         for p in state.params]),
                    "mu": torch.cat([m.reshape(-1).cpu() for m in state.mu]),
                    "launches": read_launches()}, out.format(rank=rank))
    finally:
        dist.destroy_process_group()


def _one_rank_trainer(device: torch.device, card: str, workdir: Path) -> dict:
    """Part 1: ``python -m meanflow_audio_codec_torch.train --config
    configs/frontier_v2.json`` through ``main`` inside a one-rank NCCL
    group: the sharded path at world size 1."""
    import torch.distributed as dist

    from meanflow_audio_codec_torch.parallel import initialize_distributed
    from meanflow_audio_codec_torch.training.trainer import load_flow_state

    args = ["--config", str(CONFIG), "--steps-per-call", "16",
            "--n-steps", str(PARALLEL_STEPS), "--checkpoint-step",
            str(PARALLEL_STEPS), "--sample-every", str(PARALLEL_STEPS),
            "--device-pool-clips", "64", "--workdir", str(workdir)]
    initialize_distributed(_free_address(), 1, 0, backend="nccl",
                           device=device)
    try:
        zero_launches()
        printed = _Tee()
        with contextlib.redirect_stdout(printed):
            if train_cli.main(args) != 0:
                raise AssertionError("the one-rank trainer failed")
        launches = read_launches()
    finally:
        dist.destroy_process_group()
    out = printed.getvalue()
    for line in ("Sharding over mesh {'data': 1, 'model': 1}: batch 16 -> "
                 "16 per device",
                 "Mesh device replay pool: 64 clips (64/device over 1 data "
                 "shards), async int16 refresh"):
        if line not in out:
            raise AssertionError(f"the one-rank trainer did not print {line!r}")
    steps = [r for r in read_log(workdir / "logs" / "train_log.jsonl")
             if "event" not in r]
    if [r["step"] for r in steps] != list(range(PARALLEL_STEPS)) or not all(
            math.isfinite(r["loss"]) and r["update_ok"] is True
            for r in steps):
        raise AssertionError("the one-rank trainer's log")
    ckpt = workdir / "checkpoints" / f"step_{PARALLEL_STEPS:05d}.msgpack"
    state, _ = load_flow_state(ckpt, load_config(workdir / "config.json"),
                               device=device)
    serving = serialization.msgpack_restore(
        (ckpt.parent / f"serving_step_{PARALLEL_STEPS:05d}.msgpack")
        .read_bytes())
    served = weights.flax_to_torch(serving["params"])
    if state.step != PARALLEL_STEPS or not all(
            torch.equal(e.cpu(), served[n])
            for n, e in zip(state.names, state.ema)):
        raise AssertionError("the reloaded checkpoint is not the run's: "
                             f"step {state.step}, EMA != serving file")
    if launches["mdct_cuda"] < PARALLEL_STEPS or launches["imdct_cuda"] < 1:
        raise AssertionError(f"one-rank trainer launches {launches}")
    ms = 1e3 * steps[16]["step_time"]
    print(f"[{card}] one-rank NCCL trainer, frontier_v2, bf16: chunk time "
          f"per step {1e3 * steps[0]['step_time']:.3f} / {ms:.3f} ms (chunks "
          f"1-2; the first includes the start); step_{PARALLEL_STEPS:05d} "
          f"reloaded (step {state.step}, EMA == serving file); launches "
          f"{launches}", flush=True)
    return launches


def _two_ranks_one_card(device: torch.device, card: str,
                        scratch: Path) -> dict:
    """Part 2: two gloo ranks on card 0, one float32 step at frontier-v2
    width, against the one-process step on all 16 clips."""
    state, step = train_setup(device, fused=False, precision="float32",
                              warmup_steps=0)
    batch = synth_audio(TRAIN_CLIPS, CLIP_LEN,
                        torch.Generator(device).manual_seed(21), device)
    state, metrics = step(state, batch,
                          generator=torch.Generator(device).manual_seed(22))
    want = {"loss": metrics["loss"].item(),
            "params": torch.cat([p.detach().reshape(-1).cpu()
                                 for p in state.params]),
            "mu": torch.cat([m.reshape(-1).cpu() for m in state.mu])}
    del state, step, batch, metrics
    torch.cuda.empty_cache()
    out = str(scratch / "rank{rank}.pt")
    torch.multiprocessing.start_processes(
        _data_parallel_rank, args=(_free_address(), out), nprocs=2,
        start_method="spawn")
    total = None
    for rank in range(2):
        got = torch.load(out.format(rank=rank))
        errors = {name: float((got[name] - want[name]).norm()
                              / want[name].norm()) for name in ("params", "mu")}
        loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        print(f"two gloo ranks on one card, rank {rank}: float32 step on 8 "
              f"of 16 clips, loss {got['loss']:.8f} vs one process "
              f"{want['loss']:.8f} (rel {loss_err:.2e}), rel_l2 params "
              f"{errors['params']:.3e}, first moments {errors['mu']:.3e} "
              f"(<= {TRAIN_REL_L2}); launches {got['launches']}", flush=True)
        if not (loss_err <= TRAIN_REL_L2 and max(errors.values())
                <= TRAIN_REL_L2):
            raise AssertionError(f"rank {rank} differs from one process")
        if got["launches"]["mdct_cuda"] == 0:
            raise AssertionError(f"rank {rank} launched no MDCT")
        total = got["launches"] if total is None else {
            k: (v + total[k] if isinstance(v, int) else
                {n: c + total[k][n] for n, c in v.items()})
            for k, v in got["launches"].items()}
    return total


def _supervised_restart(card: str, scratch: Path) -> subprocess.Popen:
    """Part 3, started: ``tools/supervise`` (its torch probe) over a trainer
    child that stalls once, at a small width; returns the process."""
    config = json.loads(CONFIG.read_text())
    config["base"].update(batch_size=4, n_steps=8)
    config["model"].update(num_blocks=2)
    config["model"]["architecture_options"].update(channels=64,
                                                   bottleneck_dim=128)
    config["dataset"]["tokenization_config"].update(device_pool_clips=16)
    config["training"].update(sample_every=8, checkpoint_step=8)
    config["tpu"].update(steps_per_call=4)
    (scratch / "small.json").write_text(json.dumps(config))
    (scratch / "stall_child.py").write_text(STALL_CHILD)
    child = (f"{sys.executable} -u {scratch / 'stall_child.py'} "
             f"{scratch / 'stalled'}")
    log = (scratch / "supervise.log").open("w")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (str(REPO), os.environ.get("PYTHONPATH")))))
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "meanflow_audio_codec_torch.tools."
         "supervise", "--stall-timeout", str(SUPERVISE_STALL),
         "--max-restarts", "1", "--probe-timeout", "120",
         "--max-outage-wait", "60", "--command", child, "--",
         "--config", str(scratch / "small.json"),
         "--workdir", str(scratch / "supervised")],
        stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env)


def _check_supervised(proc: subprocess.Popen, scratch: Path) -> None:
    rc = proc.wait(timeout=300)
    out = (scratch / "supervise.log").read_text()
    print("\n".join("  supervise | " + line
                    for line in out.splitlines()[-12:]), flush=True)
    wants = ("child: stalling before the serving checkpoint",
             f"no output for {SUPERVISE_STALL}s", "--resume",
             "Resumed from step 8", "completed after 1 restart(s)")
    missing = [w for w in wants if w not in out]
    ckpt = scratch / "supervised" / "checkpoints"
    if rc != 0 or missing or not (ckpt / "serving_step_00008.msgpack"
                                  ).exists():
        raise AssertionError(f"supervise: rc {rc}, missing {missing}")


def parallel_phase(device: torch.device, card: str, scratch: Path) -> dict:
    """Phase 15: ``supervise`` restarting a stalled trainer child (started
    first; it mostly waits), beside the one-rank NCCL trainer and then two
    gloo ranks on the card against one process. Returns the launch counts
    per path."""
    t0 = time.perf_counter()
    supervised = _supervised_restart(card, scratch)
    try:
        paths = {"parallel_trainer": _one_rank_trainer(
            device, card, scratch / "one_rank")}
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        paths["parallel_dp_step"] = _two_ranks_one_card(device, card, scratch)
        t2 = time.perf_counter()
        _check_supervised(supervised, scratch)
    finally:
        if supervised.poll() is None:
            supervised.kill()
            supervised.wait()
    t3 = time.perf_counter()
    print(f"[{card}] parallel phase: one-rank trainer {t1 - t0:.1f} s, two "
          f"ranks on one card {t2 - t1:.1f} s, supervised restart "
          f"{t3 - t0:.1f} s (beside both)", flush=True)
    return paths


# ---------------------------------------------------------------------------
# orbax checkpoints (phase 16)
# ---------------------------------------------------------------------------

#: a tiny convnet run whose orbax checkpoint the JAX package wrote, with the
#: same state in msgpack beside it (tests/make_torch_orbax_fixture.py)
ORBAX_FIXTURE = REPO / "tests" / "fixtures" / "torch_orbax_run"
ORBAX_STEPS = 16  # the first run's steps; --resume takes it to twice this


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _flat_leaves(tree, prefix: str = "") -> dict:
    """The array leaves of a checkpoint's tree by path (a list's items by
    index, as a state dict keys them), as CPU tensors."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for key, value in items:
        name = f"{prefix}/{key}"
        if isinstance(value, (dict, list)):
            out.update(_flat_leaves(value, name))
        elif value is not None:
            out[name] = torch.as_tensor(value).cpu()
    return out


def _same_leaves(got: dict, want: dict, what: str) -> int:
    """Every leaf of ``got`` equal to ``want``'s, dtype and bits; returns
    the number of leaves."""
    got, want = _flat_leaves(got), _flat_leaves(want)
    bad = sorted(set(got) ^ set(want)) + [
        k for k in sorted(set(got) & set(want))
        if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"{what}: leaves differ: {bad[:5]}")
    return len(got)


def _orbax_fixture_path(device: torch.device, card: str) -> dict:
    """Part (a): the JAX-written fixture read without JAX, tensorstore or
    zstandard: every leaf against its msgpack twin bit for bit, then served
    with ``from_workdir`` against serving the twin."""
    from meanflow_audio_codec_torch.training import checkpoints
    from meanflow_audio_codec_torch.training.trainer import load_flow_state

    config = load_config(ORBAX_FIXTURE / "config.json")
    orbax_dir = checkpoints.find_latest_checkpoint(
        ORBAX_FIXTURE / "checkpoints")
    twin = ORBAX_FIXTURE / "twin" / orbax_dir.name.replace(".orbax",
                                                           ".msgpack")
    state, _ = load_flow_state(twin, config, device=device)
    tree = checkpoints.read_checkpoint_orbax(orbax_dir, state)
    want = checkpoints.read_checkpoint(twin)
    for t in (tree, want):
        del t["ema_decay"]
    n = _same_leaves(tree, want, f"{orbax_dir.name} against its twin")
    clip = synth_audio(2, CLIP_LEN, torch.Generator(device).manual_seed(30),
                       device)
    zero_launches()
    codec = AudioCodec.from_workdir(ORBAX_FIXTURE, device=device)
    out = codec.roundtrip(clip, generator=torch.Generator(device)
                          .manual_seed(31))
    torch.cuda.synchronize()
    launches = read_launches()
    twin_codec = AudioCodec.from_checkpoint(twin, config, device=device)
    ref = twin_codec.roundtrip(clip, generator=torch.Generator(device)
                               .manual_seed(31))
    if not torch.isfinite(out).all() or not torch.equal(out, ref):
        raise AssertionError("serving the JAX-written orbax run differs from "
                             "serving its msgpack twin")
    if launches["mdct_cuda"] == 0 or launches["imdct_cuda"] == 0:
        raise AssertionError(f"orbax fixture serving launches {launches}")
    print(f"orbax fixture: {orbax_dir.name} (written by the JAX package) "
          f"read without JAX/tensorstore/zstandard, {n} leaves == "
          f"{twin.name} bit for bit; from_workdir round trip of 2 x "
          f"{CLIP_LEN} == the twin's, shape {tuple(out.shape)}; launches "
          f"{launches}", flush=True)
    return launches


def _orbax_trainer_path(scratch: Path, writes: list) -> dict:
    """Part (b): the trainer at full frontier-v2 width writing orbax
    checkpoints: ``ORBAX_STEPS`` steps with a checkpoint at the end, then
    ``--resume`` to twice that; each orbax write is timed and followed by a
    msgpack checkpoint of the same state (``writes``)."""
    from meanflow_audio_codec_torch.training import checkpoints

    config = json.loads(CONFIG.read_text())
    config["training"]["checkpoint_format"] = "orbax"
    config_path = scratch / "frontier_v2_orbax.json"
    config_path.write_text(json.dumps(config))
    workdir = scratch / "orbax_run"
    args = ["--config", str(config_path), "--steps-per-call",
            str(ORBAX_STEPS), "--checkpoint-step", str(ORBAX_STEPS),
            "--sample-every", str(2 * ORBAX_STEPS),
            "--max-checkpoints-to-keep", "2", "--device-pool-clips", "64",
            "--workdir", str(workdir)]
    real = checkpoints.save_checkpoint_orbax

    def timed(state, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = real(state, path)
        orbax_s = time.perf_counter() - t0
        twin = scratch / path.name.replace(".orbax", ".msgpack")
        t0 = time.perf_counter()
        checkpoints.save_checkpoint(state, twin)
        writes.append((path, orbax_s, twin, time.perf_counter() - t0))
        return path

    checkpoints.save_checkpoint_orbax = timed
    zero_launches()
    try:
        for extra in (["--n-steps", str(ORBAX_STEPS)],
                      ["--resume", "--n-steps", str(2 * ORBAX_STEPS)]):
            if train_cli.main(args + extra) != 0:
                raise AssertionError(f"train main {extra} failed")
    finally:
        checkpoints.save_checkpoint_orbax = real
    launches = read_launches()
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [i for i, r in enumerate(records) if r.get("event") == "start"]
    steps = [r["step"] for r in records if "event" not in r]
    if (len(starts) != 2 or steps != list(range(2 * ORBAX_STEPS))
            or records[starts[1] + 1]["step"] != ORBAX_STEPS):
        raise AssertionError(f"orbax trainer log: starts {starts}, steps "
                             f"{steps}")
    ckpt = workdir / "checkpoints"
    for step in (ORBAX_STEPS, 2 * ORBAX_STEPS):
        sidecar = json.loads((ckpt / f"step_{step:05d}.metadata.json")
                             .read_text())
        if not (ckpt / f"step_{step:05d}.orbax").is_dir() or sidecar[
                "format"] != "orbax":
            raise AssertionError(f"step {step}: no orbax directory or a "
                                 f"sidecar of format {sidecar['format']!r}")
    if launches["mdct_cuda"] < 2 * ORBAX_STEPS or launches["imdct_cuda"] < 1:
        raise AssertionError(f"orbax trainer launches {launches}")
    print(f"orbax trainer: frontier_v2 with checkpoint_format orbax, "
          f"{ORBAX_STEPS} steps then --resume (resumed at step "
          f"{ORBAX_STEPS}) to {2 * ORBAX_STEPS}; "
          f"{sorted(p.name for p in ckpt.iterdir())}; launches {launches}",
          flush=True)
    return launches


def _orbax_reads(card: str, writes: list) -> Path:
    """Each orbax checkpoint's leaves against the msgpack checkpoint of the
    same state, with the seconds and rates of every write and read; returns
    the newest msgpack twin."""
    from meanflow_audio_codec_torch.training import checkpoints
    from meanflow_audio_codec_torch.training.orbax import pytree

    for path, orbax_w, twin, msgpack_w in writes:
        for fmt, size, w in (("orbax", _dir_bytes(path), orbax_w),
                             ("msgpack", twin.stat().st_size, msgpack_w)):
            print(f"[{card}] checkpoint write, {fmt}, {path.stem}: {size} "
                  f"bytes in {w:.3f} s ({size / 1e6 / w:.1f} MB/s)",
                  flush=True)
    # the trainer writes its last checkpoint twice (the checkpoint step and
    # the run's end); each is read once
    for path, twin in dict((p, t) for p, _, t, _ in writes).items():
        t0 = time.perf_counter()
        restored = pytree.restore_pytree(path)
        orbax_r = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = checkpoints.read_checkpoint(twin)
        msgpack_r = time.perf_counter() - t0
        del want["ema_decay"]  # kept by the train state, not by orbax
        n = _same_leaves(restored, want, f"{path.name} against msgpack")
        for fmt, size, r in (("orbax", _dir_bytes(path), orbax_r),
                             ("msgpack", twin.stat().st_size, msgpack_r)):
            print(f"[{card}] checkpoint read, {fmt}, {path.stem} ({n} "
                  f"leaves == the other format's, {FRONTIER_PARAMS} params "
                  f"x 4 f32 arrays): {size} bytes in {r:.3f} s "
                  f"({size / 1e6 / r:.1f} MB/s)", flush=True)
    return writes[-1][2]


def _orbax_serving_path(device: torch.device, card: str, workdir: Path,
                        twin: Path) -> dict:
    """Part (c): ``from_workdir`` serves the resumed run from its newest
    orbax directory; a 10 s clip's stored bytes and decoded audio equal
    those served from the msgpack twin of the same state."""
    config = load_config(workdir / "config.json")
    clip = synth_audio(1, 10 * SAMPLE_RATE,
                       torch.Generator(device).manual_seed(32), device)
    zero_launches()
    codec = AudioCodec.from_workdir(workdir, device=device)
    data = codec.encode_bytes(clip)
    out = codec.decode_bytes(data, generator=torch.Generator(device)
                             .manual_seed(33))
    torch.cuda.synchronize()
    launches = read_launches()
    ref_codec = AudioCodec.from_checkpoint(twin, config, device=device)
    ref_data = ref_codec.encode_bytes(clip)
    ref = ref_codec.decode_bytes(ref_data, generator=torch.Generator(device)
                                 .manual_seed(33))
    if data != ref_data or not torch.equal(out, ref):
        raise AssertionError("serving the orbax run differs from serving its "
                             "msgpack twin")
    if not torch.isfinite(out).all():
        raise AssertionError("orbax serving: non-finite output")
    if launches["mdct_cuda"] == 0 or launches["imdct_cuda"] == 0:
        raise AssertionError(f"orbax serving launches {launches}")
    print(f"[{card}] orbax serving: from_workdir on the resumed run, 10 s "
          f"clip, {len(data)} bytes == the msgpack twin's, decoded audio "
          f"equal, shape {tuple(out.shape)}; launches {launches}", flush=True)
    return launches


def orbax_phase(device: torch.device, card: str, scratch: Path) -> dict:
    """Phase 16: orbax checkpoints on the card's host without JAX,
    tensorstore or zstandard. Returns the launch counts per path."""
    t0 = time.perf_counter()
    paths = {"orbax_fixture": _orbax_fixture_path(device, card)}
    t1 = time.perf_counter()
    writes: list = []
    paths["orbax_trainer"] = _orbax_trainer_path(scratch, writes)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    twin = _orbax_reads(card, writes)
    t3 = time.perf_counter()
    paths["orbax_serving"] = _orbax_serving_path(
        device, card, scratch / "orbax_run", twin)
    torch.cuda.empty_cache()
    print(f"[{card}] orbax phase: fixture {t1 - t0:.1f} s, trainer "
          f"{t2 - t1:.1f} s, reads {t3 - t2:.1f} s, serving "
          f"{time.perf_counter() - t3:.1f} s", flush=True)
    return paths


#: phase 17: the eval step's clips and the train steps compared per path
INTERFACE_STEPS = 2
#: stage_fusable against the wrappers: [B, spatial**2, channels] geometries
FUSABLE_GEOMETRIES = [(8, 256), (8, 512), (4, 64), (3, 48)]


def _sections_equal_flat(config) -> int:
    """Section access equals flat access for every field of the sectioned
    config (the flat ``workdir`` is a str, the flat dict fields ``{}`` when
    unset); returns the number of fields."""
    count = 0
    for name in ("base", "model", "dataset_config", "method_config",
                 "training", "tpu"):
        section = getattr(config, name)
        for f in dataclasses.fields(section):
            value, flat = getattr(section, f.name), getattr(config, f.name)
            if f.name == "workdir" and flat is not None:
                flat = Path(flat)
            if f.name in ("architecture_options", "tokenization_config"):
                value = value or {}
            if flat != value:
                raise AssertionError(f"{name}.{f.name}: section {value!r}, "
                                     f"flat {flat!r}")
            count += 1
    return count


def _interface_train(device: torch.device, card: str, fused: bool,
                     batch: torch.Tensor) -> dict:
    """``train_step`` through ``compute_loss`` for INTERFACE_STEPS steps
    against ``make_train_step`` with the same weights and draws (float32);
    returns the launches of the ``train_step`` calls and their tokenize."""
    # warmup off, so that both steps move the parameters
    state, step = train_setup(device, fused=fused, precision="float32",
                              warmup_steps=0)
    twin, _ = train_setup(device, fused=fused, precision="float32",
                          warmup_steps=0)
    config = frontier_config("float32", fused)
    objective = create_loss_strategy(config)
    adapter = adapter_from_config(config, create_tokenization_strategy(
        config.tokenization_strategy, config.tokenization_config))
    gen = torch.Generator(device=device).manual_seed(17)
    zero_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        x = adapter.tokenize(batch)
    draws, losses = [], []
    for _ in range(INTERFACE_STEPS):
        d = objective.draws_for(state, x, gen)
        state, loss = train_step(state, None, x, objective, **d)
        draws.append(d)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for d, loss in zip(draws, losses):
        twin, metrics = step(twin, batch, **d)
        rel = _rel_l2(loss, metrics["loss"])[1]
        if not (math.isfinite(loss.item()) and rel <= TRAIN_REL_L2):
            raise AssertionError(f"train_step loss {loss.item()} against "
                                 f"{metrics['loss'].item()} (rel {rel})")
    rel_params = _rel_l2(state._params, twin._params)[1]
    rel_mu = _rel_l2(state._mu, twin._mu)[1]
    flag = "on" if fused else "off"
    print(f"[{card}] train_step (compute_loss) float32, fused_stage {flag}, "
          f"{TRAIN_CLIPS} clips x {CLIP_LEN}: {INTERFACE_STEPS} steps in "
          f"{seconds:.3f} s; losses "
          f"{[round(v.item(), 6) for v in losses]} against make_train_step's, "
          f"parameters rel_l2 {rel_params:.3e}, first moments rel_l2 "
          f"{rel_mu:.3e} (<= {TRAIN_REL_L2}); launches {launches}",
          flush=True)
    if not (rel_params <= TRAIN_REL_L2 and rel_mu <= TRAIN_REL_L2):
        raise AssertionError("train_step against make_train_step: params "
                             f"{rel_params}, first moments {rel_mu}")
    stage_kernels = tuple(stage_cuda.launches)
    if launches["mdct_cuda"] != 1:
        raise AssertionError(f"the tokenize launched {launches['mdct_cuda']} "
                             "MDCTs, expected 1")
    if fused and not all(launches[name] for name in stage_kernels):
        raise AssertionError("a stage kernel was not launched by the fused "
                             f"compute_loss: {launches}")
    if not fused and any(launches[name] for name in stage_kernels):
        raise AssertionError("a stage kernel ran with fused_stage off")
    del state, twin, step
    torch.cuda.empty_cache()
    return launches


def _check_stage_fusable(device: torch.device, card: str) -> None:
    """``stage_fusable`` against the wrappers: each fused op on a [2, S*S,
    C] tensor of each dtype launches its kernel exactly where the rule
    says (float16 raises the wrappers' TypeError, launching nothing)."""
    if not stage_fusable(8, 256, torch.bfloat16):
        raise AssertionError("stage_fusable(8, 256, bf16) is False")
    checked = 0
    gen = torch.Generator(device=device).manual_seed(18)
    for spatial, channels in FUSABLE_GEOMETRIES:
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            x = torch.randn(2, spatial * spatial, channels, generator=gen,
                            device=device).to(dtype)
            x2 = torch.randn(2, spatial * spatial, 2 * channels,
                             generator=gen, device=device).to(dtype)
            film = torch.zeros(2, channels, device=device, dtype=dtype)
            grn = torch.zeros(2 * channels, device=device)
            zero_launches()
            launched = True
            try:
                stage.fused_ln_film(x, film, film)
                stage.fused_ln_norm(x)
                stage.fused_gelu_grn(x2, grn, grn)
            except TypeError:
                launched = False
            torch.cuda.synchronize()
            counts = read_launches()
            ran = [counts[name] for name in stage_cuda.launches]
            if launched and ran != [1, 1, 1]:
                raise AssertionError(f"{spatial}x{channels} {dtype}: {ran}")
            if launched != stage_fusable(spatial, channels, dtype):
                raise AssertionError(
                    f"stage_fusable({spatial}, {channels}, {dtype}) is "
                    f"{stage_fusable(spatial, channels, dtype)}, the wrappers "
                    f"launched: {launched}")
            checked += 1
    print(f"[{card}] stage_fusable agrees with the wrappers' launches at "
          f"{checked} geometries x dtypes ({FUSABLE_GEOMETRIES}; bf16, f32 "
          "launch, f16 does not)", flush=True)


def interfaces_phase(device: torch.device, card: str) -> dict:
    """Phase 17: the JAX package's layer interfaces on the card at
    frontier-v2 width. Returns the launch counts per path."""
    t0 = time.perf_counter()
    config = load_config_from_json(CONFIG)
    fields = _sections_equal_flat(config)
    print(f"load_config_from_json(frontier_v2.json): {type(config).__name__}"
          f", section access equals flat access for {fields} fields",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(19)
    batch = synth_audio(TRAIN_CLIPS, CLIP_LEN, gen, device)
    paths = {}

    # the validation step: tokenize (the MDCT kernel) -> the iMF loss
    state, _ = train_setup(device, fused=False, precision="float32")
    f32 = frontier_config("float32", False)
    objective = create_loss_strategy(f32)
    if not isinstance(objective, ImprovedMeanFlowLoss):
        raise AssertionError(f"frontier_v2's objective is {objective}")
    adapter = adapter_from_config(f32, MDCTTokenization(
        f32.tokenization_config["window_size"]))
    evaluate = make_eval_step(objective, adapter)
    with torch.no_grad():
        x = adapter.tokenize(batch)
    draws = objective.draws_for(state, x, gen)
    evaluate(state, None, batch, **draws)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t1 = time.perf_counter()
    outs = [evaluate(state, None, batch, **draws)
            for _ in range(INTERFACE_STEPS)]
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t1) / INTERFACE_STEPS
    paths["interfaces_eval"] = read_launches()
    with torch.no_grad():
        ref, _ = objective.loss(state.model, x, **draws)
    rel = _rel_l2(outs[-1]["loss"], ref)[1]
    print(f"[{card}] make_eval_step(ImprovedMeanFlowLoss, MDCT adapter) "
          f"float32, TF32 off, {TRAIN_CLIPS} clips x {CLIP_LEN} ({x.shape[0]}"
          f" rows): {eval_ms:.3f} ms a call, loss {outs[-1]['loss'].item():.8f}"
          f" against objective.loss {ref.item():.8f} (rel {rel:.3e}, <= 1e-5)"
          f", mse {outs[-1]['mse'].item():.6f}; launches "
          f"{paths['interfaces_eval']}", flush=True)
    if not rel <= 1e-5 or set(outs[-1]) != {"loss", "mse"}:
        raise AssertionError(f"eval step: rel {rel}, keys {set(outs[-1])}")
    if paths["interfaces_eval"]["mdct_cuda"] != INTERFACE_STEPS:
        raise AssertionError("the eval step launched "
                             f"{paths['interfaces_eval']['mdct_cuda']} MDCTs"
                             f" in {INTERFACE_STEPS} calls, expected 1 each")
    del state, outs
    torch.cuda.empty_cache()

    paths["interfaces_train_step"] = _interface_train(device, card, False,
                                                      batch)
    paths["interfaces_train_step_fused"] = _interface_train(device, card,
                                                            True, batch)
    _check_stage_fusable(device, card)

    # device_time of the round trip, beside time_ms of the same call
    model = create_flow_model(config, generator=torch.Generator().manual_seed(0))
    codec = AudioCodec(model, None, config, device=device)
    audio = synth_audio(4, CLIP_LEN, gen, device)
    round_gen = torch.Generator(device=device).manual_seed(20)

    def roundtrip():
        return codec.roundtrip(audio, generator=round_gen)

    zero_launches()
    seconds = profiling.device_time(roundtrip, iters=10, warmup=2)
    paths["interfaces_device_time"] = read_launches()
    events_ms = time_ms(roundtrip, batches=3)
    print(f"[{card}] device_time(codec.roundtrip, 4 clips x {CLIP_LEN}, "
          f"bf16): {1e3 * seconds:.3f} ms a call (host clock, 10 calls ended "
          f"by synchronize and a host read) beside time_ms {events_ms:.3f} "
          f"ms (CUDA events); launches "
          f"{paths['interfaces_device_time']}", flush=True)
    if not (seconds > 0 and paths["interfaces_device_time"]["mdct_cuda"]
            == paths["interfaces_device_time"]["imdct_cuda"] == 12):
        raise AssertionError(f"device_time {seconds}, launches "
                             f"{paths['interfaces_device_time']}")
    del codec, model
    torch.cuda.empty_cache()
    print(f"[{card}] interfaces phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


# ---------------------------------------------------------------------------
# the proj trials (phase 18)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def timed_train_loop(module):
    """Record the seconds (the card synchronised at both ends) and the
    losses of each ``train`` loop a trial module's ``main`` runs."""
    real, runs = module.train, []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = real(*args, **kwargs)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, losses))
        return state, losses

    module.train = timed
    try:
        yield runs
    finally:
        module.train = real


def _proj_trial(module, device: torch.device, card: str, scratch: Path,
                widths: str) -> dict:
    """One trial through ``main`` at its published widths, ``PROJ_STEPS``
    steps; returns its launch counts."""
    name = module.__name__.rsplit(".", 1)[1]
    workdir = scratch / name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    t0 = time.perf_counter()
    with timed_train_loop(module) as runs:
        if module.main(["--steps", str(PROJ_STEPS), "--workdir",
                        str(workdir)]) != 0:
            raise AssertionError(f"proj {name}: main failed")
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    ((seconds, losses),) = runs
    if len(losses) != PROJ_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"proj {name}: losses {losses}")
    ms = 1e3 * seconds / PROJ_STEPS
    outputs = sorted(p.name for p in workdir.iterdir())
    print(f"[{card}] proj {name} ({widths}; {PROJ_STEPS} steps, the "
          f"script's {1000 if 'autoencoder' in name else 2000} cut): "
          f"{ms:.3f} ms a step (the loop's wall, the card synchronised at "
          f"both ends), peak memory {peak_gb:.3f} GB, loss {losses[0]:.6f} "
          f"-> {losses[-1]:.6f}; main's wall {wall:.1f} s; outputs "
          f"{outputs}; launches {launches}", flush=True)
    return launches


def _proj_step_against_cpu(device: torch.device) -> None:
    """One float32 step of each trial's model, state and step on the card
    against the CPU (``proj.step_against_cpu``): the same weights, batch
    and draws."""
    gen = torch.Generator().manual_seed(19)
    mnist = torch.rand(PROJ_CHECK_ROWS, 784, generator=gen) * 2 - 1
    audio = synth_audio(PROJ_CHECK_CLIPS, 16384, gen, torch.device("cpu"))
    draws = ImprovedMeanFlowLoss().draw(
        mnist_trial.build_model(compute_dtype=torch.float32), mnist,
        torch.Generator().manual_seed(20))
    trials = {
        "mnist_trial": (mnist_trial.build_model, mnist_trial.build_step(),
                        mnist, draws),
        "mnist_autoencoder": (mnist_autoencoder.build_model,
                              mnist_autoencoder.build_step(), mnist, {}),
        "audio_autoencoder": (
            audio_autoencoder.build_model, audio_autoencoder.build_step(
                audio_autoencoder.build_tokenizer()), audio, {})}
    for name, (build_model, step, batch, given) in trials.items():
        loss_cpu, loss_card, rel = proj.step_against_cpu(
            build_model, step, batch, device, **given)
        print(f"proj {name}, float32 step, card vs CPU: loss "
              f"{loss_card:.8f} vs {loss_cpu:.8f}, first-moment rel_l2 "
              f"{rel:.3e} (loss rtol 1e-4, rel_l2 <= {TRAIN_REL_L2})",
              flush=True)
        if not (abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
                and rel <= TRAIN_REL_L2):
            raise AssertionError(f"proj {name} card vs CPU: loss "
                                 f"{loss_card} vs {loss_cpu}, rel_l2 {rel}")


def proj_phase(device: torch.device, card: str, scratch: Path) -> dict:
    """Phase 18: the three proj trials at their published widths, then
    each one's float32 step against the CPU; returns the launch counts."""
    paths = {}
    for module, widths in (
            (mnist_trial, "ConditionalConvFlow(784, 128, 4, 128), bf16, "
                          "batch 128"),
            (mnist_autoencoder, "MLPMixerAutoencoder(784, 16, 64, 64, 64, "
                                "256, 256), bf16, batch 128"),
            (audio_autoencoder, "MLPMixerAutoencoder(512, 8, 64, 32, 32, "
                                "256, 256), bf16, 8 clips x 16384, W 256 "
                                "stereo frame tokens")):
        name = module.__name__.rsplit(".", 1)[1]
        paths[f"proj_{name}"] = _proj_trial(module, device, card, scratch,
                                            widths)
        torch.cuda.empty_cache()
    audio = paths["proj_audio_autoencoder"]
    print(f"proj audio_autoencoder: {audio['mdct_cuda']} MDCT and "
          f"{audio['imdct_cuda']} IMDCT launches over {PROJ_STEPS} steps "
          "and the held-out reconstruction", flush=True)
    if audio["mdct_cuda"] < PROJ_STEPS or audio["imdct_cuda"] < 1:
        raise AssertionError("the audio trial did not run the MDCT on every "
                             "step and the IMDCT in its reconstruction")
    _proj_step_against_cpu(device)
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
    parser.add_argument("--jvp-tape", action="store_true",
                        help="the build, then the stop-gradient JVP's "
                             "tangent off and on the autograd tape alone")
    parser.add_argument("--parallel-only", action="store_true",
                        help="the build, then phase 15 (data-parallel "
                             "training) alone")
    parser.add_argument("--orbax-only", action="store_true",
                        help="the build, then phase 16 (orbax checkpoints) "
                             "alone")
    parser.add_argument("--interfaces-only", action="store_true",
                        help="the build, then phase 17 (the layer "
                             "interfaces) alone")
    parser.add_argument("--proj-only", action="store_true",
                        help="the build, then phase 18 (the proj trials) "
                             "alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line(device)
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    # the CUDA sources and the rANS coder (g++), all compilers at once
    logs = _build.build(
        ("mdct", "imdct") if args.transforms_only
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
    if args.jvp_tape:
        jvp_tape_probe(device, card)
        return 0
    if args.parallel_only:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"parallel": parallel_phase(device, card,
                                                         Path(tmp))}),
                  flush=True)
        return 0
    if args.orbax_only:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"orbax": orbax_phase(device, card, Path(tmp))}),
                  flush=True)
        return 0
    if args.interfaces_only:
        print(json.dumps({"interfaces": interfaces_phase(device, card)}),
              flush=True)
        return 0
    if args.proj_only:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"proj": proj_phase(device, card, Path(tmp))}),
                  flush=True)
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
    paths = {"transform_gradients": check_transform_gradients(device,
                                                              results)}
    lap("transform gradients")
    results.update(check_stage_kernels(device))
    lap("stage kernels")
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
        paths.update(quantized_serving_path(device, card, workdir,
                                            Path(tmp), served))
        torch.cuda.empty_cache()
        lap("quantized serving")
        paths["qat_trainer"] = qat_trainer_path(device, card, workdir,
                                                Path(tmp))
        torch.cuda.empty_cache()
        lap("QAT trainer")
        paths["eval_suite"] = eval_suite_path(device, card, workdir)
        torch.cuda.empty_cache()
        paths["evaluator"] = evaluator_timing_path(device, card, workdir)
        torch.cuda.empty_cache()
        check_evaluator_against_cpu(device, workdir)
        paths["export"] = export_path(device, card, workdir, Path(tmp))
        torch.cuda.empty_cache()
        lap("evaluation")
    paths["streaming"] = streaming_path(device, card, served)
    del served
    torch.cuda.empty_cache()
    lap("streaming")
    simple_trainer_path(device, card)
    lap("simple trainer")
    with tempfile.TemporaryDirectory() as corpus_tmp:
        corpus_scratch = Path(corpus_tmp)
        paths.update(corpus_phase(device, card, corpus_scratch))
        # the corpus run stays for evaluate_all (12c); its exact stream goes
        shutil.rmtree(corpus_scratch / "corpus_exact")
        torch.cuda.empty_cache()
        lap("corpus")
        chunk_probe(device, bare)
        torch.cuda.empty_cache()
        lap("chunk probe")
        paths.update(objectives_path(device, card))
        lap("objectives")
        paths.update(remat_path(device, card))
        lap("remat")
        with tempfile.TemporaryDirectory() as tmp:
            paths.update(families_phase(device, card, Path(tmp),
                                        keep=("ablation_large",)))
            lap("families")
            paths["matrix"] = matrix_phase(device, Path(tmp))
            torch.cuda.empty_cache()
            lap("matrix")
            paths["evaluate_all"] = evaluate_all_path(
                device, card, corpus_scratch / "corpus_run",
                Path(tmp) / "ablation_large", Path(tmp))
            torch.cuda.empty_cache()
            paths["flag_trainer"] = flag_trainer_path(device, card, Path(tmp))
            torch.cuda.empty_cache()
            lap("evaluate_all and the flag-driven trainer")
    check_fused_against_plain(device)
    check_against_cpu(device)
    check_train_against_cpu(device)
    check_objectives_against_cpu(device)
    profile("one round trip, 4 clips x 32768",
            lambda: codec.roundtrip(
                requests["4 clips x 32768"],
                generator=torch.Generator(device).manual_seed(3)))
    lap("float32 checks")
    # after phase 13's profiles: late in one process, after the timing
    # tools, torch.profiler missed some library kernels on an H100 host
    with tempfile.TemporaryDirectory() as tmp, cut_tool_constants():
        paths.update(timing_tools_phase(card, Path(tmp)))
    lap("timing tools")
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(parallel_phase(device, card, Path(tmp)))
    lap("parallel")
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(orbax_phase(device, card, Path(tmp)))
    lap("orbax")
    paths.update(interfaces_phase(device, card))
    lap("interfaces")
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(proj_phase(device, card, Path(tmp)))
    lap("proj trials")

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
