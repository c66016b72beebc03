"""The port's int8 probes (meanflow_audio_codec_torch/tools/probes) on the
CPU: the int8 chain and the int8 3x3 conv equal the JAX probes' bodies bit
for bit (integer arithmetic), ``probe_hlo``'s kernel report counts only the
kernels ``aten::_int_mm`` launched, and every probe's ``main`` runs with
``--device cpu`` at tiny sizes (its size constants patched) and raises
without a card by default. The JAX
probes run at import and are not imported: their bodies are restated here
at tiny shapes."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from meanflow_audio_codec_torch.tools.probes import (
    probe_codec_ab,
    probe_hlo,
    probe_int8,
    probe_int8_conv,
    probe_stage_q,
)

TINY = dict(num_blocks=2, channels=8, bottleneck_dim=16, spatial=4,
            lift_channels=4)


def test_int8_chain_equals_jax():
    """Eight int8 products, int32 sums wrapped to int8 between them, as
    ``lax.dot_general(..., preferred_element_type=int32).astype(int8)``."""
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 127, (32, 32), dtype=np.int8)
    b = rng.integers(-127, 127, (32, 32), dtype=np.int8)
    x = jnp.asarray(a)
    for _ in range(probe_int8.CHAIN):
        x = jax.lax.dot_general(
            x, jnp.asarray(b), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32).astype(jnp.int8)
    got = probe_int8.mm_i8(torch.from_numpy(a),
                           torch.from_numpy(b).t().contiguous())
    np.testing.assert_array_equal(got.numpy(), np.asarray(x))


def test_int8_conv_equals_jax():
    """The SAME 3x3 conv of int8 codes (NHWC, HWIO), int32 sums >> 8 as
    int8, as ``lax.conv_general_dilated`` with int32 accumulation."""
    rng = np.random.default_rng(1)
    b, s, c = 3, 4, 16
    x = rng.integers(-127, 127, (b, s, s, c), dtype=np.int8)
    k = rng.integers(-127, 127, (3, 3, c, c), dtype=np.int8)
    dn = jax.lax.conv_dimension_numbers((b, s, s, c), (3, 3, c, c),
                                        ("NHWC", "HWIO", "NHWC"))
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=dn, preferred_element_type=jnp.int32)
    want = np.asarray((y >> 8).astype(jnp.int8))
    k_rows = torch.from_numpy(k).permute(3, 2, 0, 1).reshape(c, -1)
    got = probe_int8_conv.conv_i8(torch.from_numpy(x), k_rows.contiguous())
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_report_counts_the_int_mm_kernels_only():
    """The int8 GEMMs are the kernels the ``aten::_int_mm`` calls launched;
    the kernel list counts each device event once (a CPU op's ``kernels``
    repeat them)."""
    def op(name, *kernels):
        return SimpleNamespace(name=name, device_type=DeviceType.CPU,
                               kernels=[SimpleNamespace(name=k)
                                        for k in kernels])

    def kernel(name, ms):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               kernels=[], time_range=SimpleNamespace(
                                   start=10.0, end=10.0 + 1e3 * ms))

    events = [op("aten::_int_mm", "sm90_gemm_s8"),
              op("aten::_int_mm", "sm90_gemm_s8"),
              op("aten::mm", "gemm_bf16"), op("aten::add"),
              kernel("sm90_gemm_s8", 0.5), kernel("sm90_gemm_s8", 0.25),
              kernel("gemm_bf16", 1.0)]
    report = probe_hlo.kernel_report(SimpleNamespace(events=lambda: events))
    assert report["int_mm_calls"] == 2
    assert report["int8_gemm_kernels"] == 2
    assert report["int8_gemm_kernel_names"] == {"sm90_gemm_s8": 2}
    assert report["kernels"] == {"sm90_gemm_s8": {"count": 2, "ms": 0.75},
                                 "gemm_bf16": {"count": 1, "ms": 1.0}}


def _rows(capsys) -> list[dict]:
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"  # the card line: no card
    return [json.loads(line) for line in lines[1:] if line.startswith("{")]


#: probe -> (argv, its size constants at tiny values, the keys of each row)
MAINS = {
    "probe_int8": (probe_int8, ["--repeats", "1"], {"N": 64},
                   [{"dtype", "ms", "tops"}] * 2),
    "probe_int8_conv": (probe_int8_conv, ["--repeats", "1"],
                        {"B": 4, "C": 16}, [{"dtype", "ms", "tops"}] * 2),
    "probe_stage_q": (probe_stage_q, ["--repeats", "1"], {"B": 8},
                      [{"case", "ms"}] * 4),
    "probe_codec_ab": (
        probe_codec_ab, ["--rounds", "2"],
        {"GEO": TINY, "CLIPS": 1, "CLIP_SECONDS": 0.05},
        [{"round", "quantized", "ms"}] * 4
        + [{"bf16_best_ms", "bf16_rtf", "int8_best_ms", "int8_rtf",
            "speedup"}]),
    "probe_hlo": (
        probe_hlo, [], {"GEO": TINY, "CLIPS": 1, "CLIP_SECONDS": 0.05},
        [{"int_mm_calls", "int8_gemm_kernels", "expected_per_decoder_call",
          "int8_gemm_kernel_names", "kernels", "device_busy_ms"}]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_probe_runs_on_the_cpu(name, monkeypatch, capsys):
    module, argv, sizes, keys = MAINS[name]
    for constant, value in sizes.items():
        monkeypatch.setattr(module, constant, value)
    assert module.main(argv + ["--device", "cpu"]) == 0
    rows = _rows(capsys)
    assert [set(row) for row in rows] == keys
    if name == "probe_hlo":  # on the CPU the products are int32 mm
        assert rows[0]["device_busy_ms"] is None
        assert rows[0]["int_mm_calls"] == 0
        assert rows[0]["expected_per_decoder_call"] == 9 * 2


@pytest.mark.parametrize("name", sorted(MAINS))
def test_probe_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        MAINS[name][0].main([])
