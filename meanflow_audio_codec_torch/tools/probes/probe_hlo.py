"""Probe: do the int8 products survive into what the card runs? The
kernels ``torch.profiler`` records for one W8A8 int8 codec call.

Counterpart of ``meanflow_audio_codec_tpu/tools/probes/probe_hlo.py``, which
counts the convolutions and dots of the compiled XLA program by output
dtype. PyTorch compiles no program, so the card's answer is its kernel
list: one call of ``benchmark_codec_geometry``'s codec (MDCT -> encode ->
one int8 decoder call -> IMDCT) at the quality geometry
(``ch512_s8_lift64_bn1024``, 16 clips of 10 s), after one warm-up call,
under the profiler. It prints the kernels by device time, then one JSON
row: the ``aten::_int_mm`` calls, the device kernels those calls launched
(the int8 GEMMs) with their names, beside the products one decoder call
makes at this geometry (72: 4 Dense layers and 5 convolutions in each of
8 stages)::

    {"int_mm_calls", "int8_gemm_kernels", "expected_per_decoder_call",
     "int8_gemm_kernel_names", "kernels", "device_busy_ms"}

On the CPU there are no device kernels (``device_busy_ms`` None) and the
products run as int32 ``mm`` (``int_mm_calls`` 0).

    python -m meanflow_audio_codec_torch.tools.probes.probe_hlo
"""

from __future__ import annotations

import argparse
import collections
import json

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from meanflow_audio_codec_torch.evaluators.performance import force_completion
from meanflow_audio_codec_torch.tools.benchmarks._timing import start
from meanflow_audio_codec_torch.tools.benchmarks.benchmark_codec_geometry import (
    CLIP_SECONDS,
    build_model,
    codec,
    seeded_audio,
    tokenizer,
)
from meanflow_audio_codec_torch.tools.probes.probe_codec_ab import CLIPS, GEO

#: int8 products in one decoder call: 4 Dense layers (bottleneck in, lift,
#: bottleneck out, out) and 5 convolutions (the 1x1 lift, the block's 3x3,
#: expand and contract, the 1x1 back) in each stage
PRODUCTS_PER_STAGE = 9
TOP = 15


def kernel_report(prof) -> dict:
    """The ``aten::_int_mm`` calls and the device kernels they launched,
    and every device kernel by name: count and milliseconds."""
    events = prof.events()
    int_mm = [e for e in events if e.name == "aten::_int_mm"]
    gemm_names = collections.Counter(k.name for e in int_mm
                                     for k in e.kernels)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == DeviceType.CUDA:
            kernels[e.name][0] += 1
            kernels[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    return {"int_mm_calls": len(int_mm),
            "int8_gemm_kernels": sum(gemm_names.values()),
            "int8_gemm_kernel_names": dict(gemm_names),
            "kernels": {name: {"count": n, "ms": ms}
                        for name, (n, ms) in kernels.items()}}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    tok = tokenizer()
    model = build_model(device, quantized=True, **GEO)
    audio = seeded_audio(CLIPS, CLIP_SECONDS, device)
    force_completion(codec(model, tok, audio))
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        force_completion(codec(model, tok, audio))
    report = kernel_report(prof)
    ranked = sorted(report["kernels"].items(), key=lambda kv: -kv[1]["ms"])
    busy = sum(k["ms"] for k in report["kernels"].values())
    print(f"{len(ranked)} kernel names, {busy:.3f} ms of device time",
          flush=True)
    for name, k in ranked[:TOP]:
        print(f"  {k['ms']:8.3f} ms x{k['count']:<4d} {name[:100]}",
              flush=True)
    print(json.dumps({
        "int_mm_calls": report["int_mm_calls"],
        "int8_gemm_kernels": report["int8_gemm_kernels"],
        "expected_per_decoder_call": PRODUCTS_PER_STAGE * GEO["num_blocks"],
        "int8_gemm_kernel_names": report["int8_gemm_kernel_names"],
        "kernels": len(ranked),
        "device_busy_ms": busy if device.type == "cuda" else None}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
