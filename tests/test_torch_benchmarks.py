"""The port's timing tools (meanflow_audio_codec_torch/tools/benchmarks) on
the CPU: their tables equal the JAX package's, their geometries hold the
JAX package's parameter counts, the codec-geometry call equals JAX's with
the same weights, and every ``main`` runs at tiny arguments with
``--device cpu`` (JAX's row keys), prints an error row and returns 1 for a config that raises
(a stated departure: JAX's scripts return 0), and raises without a card
by default. The JAX mains are not run: their jit compiles are the cost.

Tolerance of the codec call: rtol 1e-4 / atol 1e-5 in float32, on the
CPU's plain transforms (the two packages sum the same f32 products in
other orders).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow
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
from meanflow_audio_codec_torch.weights import flax_to_torch
from meanflow_audio_codec_tpu.models import (
    ConditionalConvFlow as JaxConditionalConvFlow,
)
from meanflow_audio_codec_tpu.ops import MDCTConfig as JaxMDCTConfig
from meanflow_audio_codec_tpu.ops import MDCTTokenization as JaxTokenization
from meanflow_audio_codec_tpu.tools.benchmarks import (
    benchmark_audio_decoders as jax_audio_decoders,
)
from meanflow_audio_codec_tpu.tools.benchmarks import (
    benchmark_codec_geometry as jax_codec_geometry,
)
from meanflow_audio_codec_tpu.tools.benchmarks import (
    benchmark_conv_mfu as jax_conv_mfu,
)
from meanflow_audio_codec_tpu.tools.benchmarks import (
    benchmark_mdct as jax_mdct,
)
from meanflow_audio_codec_tpu.tools.benchmarks import (
    benchmark_streaming as jax_streaming,
)
from meanflow_audio_codec_tpu.tools.benchmarks import (
    benchmark_train_objectives as jax_train_objectives,
)

TINY = dict(num_blocks=2, channels=8, bottleneck_dim=16, spatial=4,
            lift_channels=4)
#: model knobs of a conv_mfu row that are not its geometry
RUN_KNOBS = ("batch", "scan_k", "remat", "remat_policy", "fused_stage")


@pytest.mark.parametrize("port,ref,attr", [
    (benchmark_mdct, jax_mdct, "CONFIGS"),
    (benchmark_codec_geometry, jax_codec_geometry, "CONFIGS"),
    (benchmark_codec_geometry, jax_codec_geometry, "SAMPLE_RATE"),
    (benchmark_codec_geometry, jax_codec_geometry, "WINDOW"),
    (benchmark_codec_geometry, jax_codec_geometry, "CLIP_SECONDS"),
    (benchmark_conv_mfu, jax_conv_mfu, "CONFIGS"),
    (benchmark_streaming, jax_streaming, "GEOMETRIES"),
    (benchmark_streaming, jax_streaming, "SAMPLE_RATE"),
    (benchmark_streaming, jax_streaming, "WINDOW"),
], ids=lambda v: v if isinstance(v, str) else v.__name__.rsplit(".", 1)[1])
def test_tables_equal_jax(port, ref, attr):
    assert getattr(port, attr) == getattr(ref, attr)


@pytest.mark.parametrize("port,ref,attr", [
    (benchmark_train_objectives, jax_train_objectives, "OBJECTIVES"),
    (benchmark_audio_decoders, jax_audio_decoders, "BACKENDS"),
], ids=["objectives", "decoder backends"])
def test_named_tables_equal_jax(port, ref, attr):
    ours, theirs = getattr(port, attr), getattr(ref, attr)
    assert list(ours) == list(theirs)
    if attr == "BACKENDS":  # (decoder, file suffix)
        assert ([s for _, s in ours.values()]
                == [s for _, s in theirs.values()])


@functools.cache
def _jax_count(geometry: tuple) -> int:
    model = JaxConditionalConvFlow(noise_dimension=1152,
                                   condition_dimension=256,
                                   latent_dimension=256, dtype=jnp.bfloat16,
                                   **dict(geometry))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 1152)), jnp.zeros((4, 2)),
        method="init_all"))
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))


def _port_count(geometry: tuple) -> int:
    with torch.device("meta"):
        model = ConditionalConvFlow(noise_dimension=1152,
                                    condition_dimension=256,
                                    latent_dimension=256, **dict(geometry))
    return sum(p.numel() for p in model.parameters())


def _geometry(kwargs: dict) -> tuple:
    geometry = {k: v for k, v in kwargs.items() if k not in RUN_KNOBS}
    geometry.setdefault("num_blocks", 8)
    return tuple(sorted(geometry.items()))


_MFU_GEOMETRIES = {}
for _name, _kwargs in benchmark_conv_mfu.CONFIGS.items():
    _MFU_GEOMETRIES.setdefault(_geometry(_kwargs), _name)
PARAM_CASES = ([("codec_geometry", name, _geometry(kwargs)) for name, kwargs
                in benchmark_codec_geometry.CONFIGS.items()]
               + [("conv_mfu", name, geometry) for geometry, name
                  in _MFU_GEOMETRIES.items()])


@pytest.mark.parametrize("table,name,geometry", PARAM_CASES,
                         ids=[f"{t}-{n}" for t, n, _ in PARAM_CASES])
def test_parameter_counts_equal_jax(table, name, geometry):
    """Each codec geometry and one row of each distinct conv_mfu geometry
    (the run knobs change no parameter): the port's count on the meta
    device equals JAX's through ``jax.eval_shape`` of ``init``."""
    assert _port_count(geometry) == _jax_count(geometry)


@pytest.mark.parametrize("name", sorted(chip_smoke.TIMING_PARAMS))
def test_the_smokes_parameter_counts_are_jaxs(name):
    table = (benchmark_codec_geometry.CONFIGS if name.startswith("ch256")
             else benchmark_conv_mfu.CONFIGS)
    assert chip_smoke.TIMING_PARAMS[name] == _jax_count(
        _geometry(table[name]))


def test_codec_call_matches_jax():
    """``codec`` (MDCT -> encode -> one decoder call at (t=1, h=1) -> IMDCT)
    on 1 clip of 0.05 s at channels 8, float32, with the same seeded
    weights in both packages, against the body of the JAX script's
    ``codec``."""
    kw = dict(num_blocks=2, channels=8, bottleneck_dim=16, spatial=8,
              lift_channels=4)
    noise_dim = 2 * jax_codec_geometry.WINDOW
    jmodel = JaxConditionalConvFlow(noise_dimension=noise_dim,
                                    condition_dimension=256,
                                    latent_dimension=256,
                                    dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((4, noise_dim)), jnp.zeros((4, 2)),
        method="init_all"))["params"]
    rng = np.random.default_rng(0)

    def weight(leaf):  # seeded, of JAX's shape, at variance 1 / fan-in
        fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 100
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    params = jax.tree_util.tree_map(weight, shapes)
    jtok = JaxTokenization(config=JaxMDCTConfig(
        window_size=jax_codec_geometry.WINDOW, normalize=True))

    @jax.jit
    def jax_codec(params, audio):
        tokens = jtok.tokenize(audio)
        b, nf, width = tokens.shape
        frames = tokens.reshape(b * nf, width)
        latents = jmodel.apply({"params": params}, frames, method="encode")
        t = jnp.ones((frames.shape[0], 1), dtype=frames.dtype)
        pair = jnp.concatenate([t, t], axis=-1)
        u = jmodel.apply({"params": params}, frames, pair, latents)
        decoded = (frames - u.astype(frames.dtype)).reshape(b, nf, width)
        return jtok.detokenize(decoded)

    audio = benchmark_codec_geometry.seeded_audio(1, 0.05, torch.device(
        "cpu"))
    want = np.asarray(jax_codec(params, jnp.asarray(audio.numpy())))
    model = benchmark_codec_geometry.build_model(
        torch.device("cpu"), compute_dtype=torch.float32, **kw)
    model.load_state_dict(flax_to_torch(params), strict=True)
    got = benchmark_codec_geometry.codec(
        model, benchmark_codec_geometry.tokenizer(), audio).numpy()
    assert got.shape == want.shape == (1, 2880, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _rows(capsys) -> list[dict]:
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"  # the card line: no card
    return [json.loads(line) for line in lines[1:]]


#: script -> (tiny argv, the keys of each row: JAX's)
MAINS = {
    "benchmark_mdct": (["--batch", "2"], [
        {"T", "W", "numpy_ms", "direct_ms", "speedup", "fft_ms"}] * 2),
    "benchmark_codec_geometry": (
        ["--configs", "ch256_s8_lift32", "--batch-clips", "1",
         "--clip-seconds", "0.05"],
        [{"config", *TINY, "quantized", "params_m", "wall_ms", "rtf"}]),
    "benchmark_conv_mfu": (
        ["--configs", "ch512_s8_lift64_bn1024_b2048_dots_fused"],
        [{"config", *TINY, "remat_policy", "fused_stage", "params_m",
          "batch", "steps_per_sec", "step_gflop", "mfu", "tflops"}
         - {"num_blocks"}]),
    "benchmark_streaming": (
        ["--configs", "light_ch256", "--chunk-seconds", "0.02",
         "--pushes", "3"],
        [{"config", "params_m", "chunk_ms", "push_wall_ms", "p90_wall_ms",
          "streaming_rtf", "realtime_load", "latency_ms"}]),
    "benchmark_sampler": (
        ["--noise-dim", "16", "--batch", "4", "--nfe", "1", "2"],
        [{"nfe", "sampler", "batch", "ms_per_batch", "ms_per_sample"}] * 4),
    "benchmark_train_objectives": (
        ["--noise-dim", "16", "--batch", "4", "--blocks", "2", "--steps",
         "2"],
        [{"objective", "batch", "dim", "blocks", "steps_per_sec",
          "gflop_per_step", "mse_first", "mse_last"}] * 4),
    "benchmark_meanflow_vs_improved": (
        ["--steps", "2", "--batch", "4", "--dim", "8", "--objectives",
         "mean_flow"],
        [{"objective", "step", "loss", "mse"}] * 2
        + [{"objective", "steps_per_sec"}]),
    "benchmark_audio_loader": (
        ["--frame-size", "4096", "--batch-size", "2", "--warmup", "1",
         "--timed", "2"],
        [{"prefetch", "first_batch_ms", "batches_per_sec",
          "msamples_per_sec"}] * 3),
    "benchmark_pipeline_stages": (
        ["--n-files", "3", "--frame-size", "4096", "--batch-size", "2",
         "--buffer-size", "4"],
        [{"stage", "files", "sec", "files_per_sec"}]
        + [{"stage", "frames", "sec", "frames_per_sec"}] * 2
        + [{"stage", "batches", "sec", "batches_per_sec"}] * 3),
    "benchmark_prefetch": (
        ["--file-counts", "2", "--prefetch-levels", "0", "2",
         "--frame-size", "4096"],
        [{"prefetch", "n_files", "frames", "sec", "frames_per_sec"}] * 2),
    "benchmark_vs_torch": (
        ["--frame-size", "4096", "--batch-size", "2", "--warmup", "1",
         "--timed", "2"],
        [{"loader", "first_ms", "batches_per_sec", "msamples_per_sec"}] * 3
        + [{"native_vs_torch"}]),
}
MODULES = {module.__name__.rsplit(".", 1)[1]: module for module in (
    benchmark_audio_decoders, benchmark_audio_loader,
    benchmark_codec_geometry, benchmark_conv_mfu, benchmark_mdct,
    benchmark_meanflow_vs_improved, benchmark_pipeline_stages,
    benchmark_prefetch, benchmark_sampler, benchmark_streaming,
    benchmark_train_objectives, benchmark_vs_torch)}


@pytest.fixture
def tiny_tables(monkeypatch):
    """The heavy tables cut to a tiny geometry under their own names."""
    monkeypatch.setattr(benchmark_mdct, "CONFIGS", [(2048, 512), (1024, 128)])
    monkeypatch.setitem(benchmark_codec_geometry.CONFIGS, "ch256_s8_lift32",
                        dict(TINY))
    monkeypatch.setitem(
        benchmark_conv_mfu.CONFIGS, "ch512_s8_lift64_bn1024_b2048_dots_fused",
        dict(TINY, batch=4, scan_k=2, remat=True,
             remat_policy="dots_saveable", fused_stage=True))
    monkeypatch.setitem(benchmark_streaming.GEOMETRIES, "light_ch256",
                        dict(TINY))


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_the_cpu(name, tiny_tables, capsys):
    argv, keys = MAINS[name]
    assert MODULES[name].main(argv + ["--device", "cpu"]) == 0
    rows = _rows(capsys)
    assert [set(row) for row in rows] == keys
    for row in rows:
        for key, value in row.items():
            if key.endswith(("_ms", "_sec", "per_sec", "rtf")):
                assert np.isfinite(value) and value >= 0, (key, row)


def test_benchmark_audio_decoders(capsys):
    """Mirror of tests/test_tools.py::test_benchmark_audio_decoders:
    available backends emit rate rows, missing ones skip rows."""
    rc = benchmark_audio_decoders.main(["--n-files", "3", "--seconds", "0.2",
                                        "--repeats", "1", "--device", "cpu"])
    assert rc == 0
    by_backend = {r["backend"]: r for r in _rows(capsys)}
    assert {"stdlib_wave", "native_cpp", "native_cpp_flac", "soundfile",
            "librosa", "minimp3py", "sdl_mixer"} <= set(by_backend)
    wave_row = by_backend["stdlib_wave"]
    assert wave_row["files"] == 3 and wave_row["files_per_sec"] > 0
    assert by_backend["native_cpp_flac"]["files"] == 3
    assert by_backend["minimp3py"].get("skipped")  # no mp3 decoder here


@pytest.mark.parametrize("name,bench,configs,argv", [
    ("benchmark_codec_geometry", "bench_geometry",
     ["ch256_s8_lift32", "r1_flagship_ch32"], []),
    ("benchmark_conv_mfu", "bench_config",
     ["r1_baseline", "ch128_s16_dense"], []),
    ("benchmark_streaming", "bench_streaming",
     ["light_ch256"], ["--chunk-seconds", "0.1", "1.0"]),
])
def test_a_config_that_raises_prints_its_error_row_and_fails(
        name, bench, configs, argv, monkeypatch, capsys):
    """The stated departure: a failing config still leaves its error row
    (and the other configs' rows), but ``main`` returns 1, where the JAX
    scripts return 0."""
    def out_of_memory(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(MODULES[name], bench, out_of_memory)
    assert MODULES[name].main(["--configs", *configs, *argv, "--device",
                               "cpu"]) == 1
    rows = _rows(capsys)
    assert all(row["error"] == "OutOfMemoryError: CUDA out of memory"
               for row in rows)
    labels = [row["config"] for row in rows]
    assert labels == (configs if not argv else [configs[0]] * 2)
    if argv:  # streaming labels each failed (config, chunk) pair
        assert [row["chunk_seconds"] for row in rows] == [0.1, 1.0]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        MODULES[name].main([])
