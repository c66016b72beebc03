#!/usr/bin/env python3
"""Drive the PyTorch port of the codec on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --transforms-only   # phases 1-3 for MDCT/IMDCT

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from meanflow_audio_codec_torch/csrc (nvcc,
     all sources at once) and print the build seconds, the ptxas report and
     the instruction mix of the MDCT's, IMDCT's and single-read GELU+GRN's
     main loops (cuobjdump);
  3. hold each kernel against its plain PyTorch version (TF32 off): the
     MDCT/IMDCT at the codec shape (8 rows x 32768 samples, W=512, hop 256),
     a ragged shape (3 rows, W=576, hop 100) and the 10 s clip shape (2 rows
     x 441000 samples, 1721 frames), and the MDCT also at the train step's
     tokenize (32 rows x 32768 samples), rtol 1e-4 / atol 1e-3; the
     three stage kernels at the train shape (2032 rows x 64 positions x 256
     or 512 channels) and ragged shapes, in bf16 and f32, with the stage
     ops' forward-AD tangents and gradients against plain-op autograd, and
     both GELU+GRN kernels (single read at those shapes, two pass at a
     longer P); and time each kernel, its plain version and one library
     call (where one exists) with CUDA events, the MDCT and IMDCT at the
     10 s shape too, the MDCT at the train shape and the two-pass GELU+GRN
     at the train shape beside the single read;
  4. the served path: ``AudioCodec.roundtrip`` at the full width of
     configs/frontier_v2.json (bf16 compute, seeded random weights) on four
     32768-sample stereo clips and one 10 s 44.1 kHz stereo clip;
  5. the train path: the iMF ``make_train_step`` at frontier-v2 width with
     ``fused_stage`` on, bf16 compute, on 16 synthetic stereo clips of 32768
     samples (2032 flow rows), 2 warm-up and 10 timed steps; then the same
     with ``fused_stage`` off (the default training path, as a yardstick),
     2 warm-up and 5 timed steps;
     each path is driven with the kernels' launch counts (and the count of
     each GELU+GRN kernel) set to 0 just before it and read just after;
  6. float32 checks: one full-width train step with ``fused_stage`` on
     against the same step with it off; the round trip and one small-batch
     fused train step on the card against the same on the CPU;
  7. profiles of one round trip and one bf16 train step with ``fused_stage``
     on and off (device time by kernel, busy share);
  8. a ``{"kernels": [...]}`` line, then the result line
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
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

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
from meanflow_audio_codec_torch.ops.tokenize import (
    MDCTTokenization,
    create_tokenization_strategy,
)
from meanflow_audio_codec_torch.training.adapter import adapter_from_config
from meanflow_audio_codec_torch.training.objectives import create_loss_strategy
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    make_optimizer,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "frontier_v2.json"
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
    and 10 s clip shapes, the MDCT also at the train step's tokenize; times
    at the codec shape (keys ``ms``, ...), the 10 s shape (``ms_10s``, ...)
    and the MDCT's at the train shape (``ms_train``, ...)."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {name: {"max_abs_err": 0.0}
               for name in ("mdct_cuda", "imdct_cuda")}
    for label, rows, length, w, hop in [
            ("codec", 8, 32768, 512, 256), ("ragged", 3, 5000, 576, 100),
            ("10s", 2, 10 * SAMPLE_RATE, 512, 256),
            ("train", 2 * TRAIN_CLIPS, CLIP_LEN, 512, 256)]:
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
        if label == "train":  # the train step tokenizes; it runs no IMDCT
            del cases["imdct_cuda"]
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
                    print(f"{name} public op, f32 train shape: tangent "
                          f"max_abs_err {terr:.3e}, gradient within "
                          f"{STAGE_DIFF} of plain autograd", flush=True)
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


def train_setup(device: torch.device, fused: bool, precision: str,
                seed: int = 0):
    """(train state, step function) for the frontier-v2 config with
    ``fused_stage`` set as asked, weights from ``seed``."""
    base = load_config(CONFIG)
    config = dataclasses.replace(
        base, precision=precision,
        architecture_options=dict(base.architecture_options,
                                  fused_stage=fused))
    model = create_flow_model(
        config, generator=torch.Generator().manual_seed(seed))
    adapter = adapter_from_config(config, create_tokenization_strategy(
        config.tokenization_strategy, config.tokenization_config))
    state = TrainState(model, make_optimizer(config), config.ema_decay,
                       device=device)
    step = make_train_step(create_loss_strategy(config), adapter,
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
    return launches, state, step, batch


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


def profile(label: str, fn) -> None:
    """Device time by kernel for one call of ``fn``, and the device's busy
    share of its wall time."""
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
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
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
    logs = _build.build(("mdct", "imdct") if args.transforms_only
                        else _build.SOURCES)
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
    sass_profile()

    results = {**check_kernels(device), **check_stage_kernels(device)}
    paths = {}
    paths["roundtrip"], codec, requests = roundtrip_path(device, card)
    paths["train"], state, step, batch = train_path(device, card)
    profile("one bf16 train step, 16 clips x 32768",
            lambda: step(state, batch,
                         generator=torch.Generator(device).manual_seed(8)))
    del state, step, batch
    torch.cuda.empty_cache()
    _, state, step, batch = train_path(device, card, fused=False, steps=5)
    profile("one bf16 train step, fused_stage off",
            lambda: step(state, batch,
                         generator=torch.Generator(device).manual_seed(8)))
    del state, step, batch
    torch.cuda.empty_cache()
    check_fused_against_plain(device)
    check_against_cpu(device)
    check_train_against_cpu(device)
    profile("one round trip, 4 clips x 32768",
            lambda: codec.roundtrip(
                requests["4 clips x 32768"],
                generator=torch.Generator(device).manual_seed(3)))

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
