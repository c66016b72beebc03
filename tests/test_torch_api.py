"""PyTorch port: the JAX package's public interface on the port.

Names: every name a JAX ``__init__`` exports (and the package's lazy
top-level names) resolves in the port's subpackage of the same name; every
public top-level name of a JAX module is defined somewhere in the port or
mapped by ``DEPARTURES`` to the port name that takes its place.
Parameters: every parameter of every public JAX function and class the name
walk pairs with a port object is the port object's, reached through its
``**options`` (``FORWARDS``), or a ``FRAMEWORK_SWAPS`` entry naming the
port parameter in its place; ``adapter_from_config(mode=...)``, the JAX
keyword names, the inert conv-flow fields and ``create_flow_model``'s dtype
override against JAX's. Configs:
every JSON under ``configs/`` reads to the same dict, flat fields, sections,
schema and documentation in both packages; ``print_config_diff`` prints the
same text; a bad value in each section raises in both; the deprecated
``output_dir``/``run_name`` give the same ``workdir`` and warning.
Objectives: ``compute_loss`` and ``train_step`` for FM, MF and iMF, and
``make_eval_step`` with an MDCT and a reshape tokenizer, against JAX's on
a small convnet flow, with the draws JAX takes from its key passed in.
Tolerances are ``tests/test_torch_objectives.py``'s: loss rtol 1e-4,
gradients rtol 1e-3 / atol 1e-5 of each leaf's largest, parameters after
an AdamW step atol 1e-2 of the learning rate (``tests/test_torch_train.py``:
Adam moves each by about the rate whatever the gradient's size). The FFT
threshold: ``mdct``/``imdct`` at W 256 (the FFT path at threshold 256) and
W 128 (the direct path) against JAX's, rtol 1e-4 / atol 1e-3. Also the
repaired device defaults, ``stage_fusable``, ``device_time`` and that
importing the subpackages builds nothing.
"""

import ast
import dataclasses
import functools
import importlib
import inspect
import socket
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import meanflow_audio_codec_tpu as jpkg
from meanflow_audio_codec_tpu.configs import config as jconfig
from meanflow_audio_codec_tpu.models import conv_flow as jconv
from meanflow_audio_codec_tpu.models.train_state import (
    TrainState as JaxTrainState,
)
from meanflow_audio_codec_tpu.ops import losses as jlosses
from meanflow_audio_codec_tpu.ops import stage_pallas as jstage
from meanflow_audio_codec_tpu.ops import time_sampling as jtime
from meanflow_audio_codec_tpu.ops import tokenize as jtok
from meanflow_audio_codec_tpu.training import objectives as jobj
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.training.trainer import (
    adapter_from_config as jax_adapter_from_config,
)
from meanflow_audio_codec_tpu.training.trainer import (
    make_optimizer as jax_make_optimizer,
)
from meanflow_audio_codec_torch import configs, weights
from meanflow_audio_codec_torch.models import conv_flow
from meanflow_audio_codec_torch.models.factories import (
    create_conv_flow,
    create_flow_model,
)
from meanflow_audio_codec_torch.ops import losses, stage, stage_cuda
from meanflow_audio_codec_torch.ops import time_sampling as ttime
from meanflow_audio_codec_torch.ops import tokenize as ttok
from meanflow_audio_codec_torch.ops.mdct_layers import IMDCTLayer, MDCTLayer
from meanflow_audio_codec_torch.training import objectives as tobj
from meanflow_audio_codec_torch.training import profiling
from meanflow_audio_codec_torch.training.adapter import (
    adapter_from_config,
    resolve_flatten_mode,
)
from meanflow_audio_codec_torch.training.logging import (
    collect_experiment_metadata,
    generate_config_diff,
)
from meanflow_audio_codec_torch.training.optim import TrainState, make_optimizer

# the modules, not the package's functions of the same names
jmdct = importlib.import_module("meanflow_audio_codec_tpu.ops.mdct")
jstep = importlib.import_module("meanflow_audio_codec_tpu.training.train_step")
tmdct = importlib.import_module("meanflow_audio_codec_torch.ops.mdct")
ttrain = importlib.import_module("meanflow_audio_codec_torch.training.train_step")

REPO = Path(__file__).resolve().parents[1]
JAX_DIR = REPO / "meanflow_audio_codec_tpu"
PORT_DIR = REPO / "meanflow_audio_codec_torch"

# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

#: the JAX package's lazy top-level names (its ``__getattr__``)
LAZY = ("AudioCodec", "StreamingCodec", "StreamingEncoder",
        "StreamingDecoder")
#: JAX module:name -> the port name (module.attribute) that takes its place
DEPARTURES = {
    "training/profiling.py:PEAK_TFLOPS":
        "meanflow_audio_codec_torch.training.profiling.PEAK_BF16_FLOPS",
    "tools/benchmarks/benchmark_conv_mfu.py:V5E_PEAK_FLOPS":
        "meanflow_audio_codec_torch.training.profiling.peak_flops",
    "models/blocks.py:quant_injection":
        "meanflow_audio_codec_torch.ops.quant.int8_linear",
    "ops/quant.py:int8_dot_general":
        "meanflow_audio_codec_torch.ops.quant.int8_linear",
    "ops/quant.py:int8_conv_general_dilated":
        "meanflow_audio_codec_torch.ops.quant.int8_conv2d",
    "ops/mdct_pallas.py:mdct_pallas":
        "meanflow_audio_codec_torch.ops.mdct_cuda.mdct_cuda",
    "ops/imdct_pallas.py:imdct_pallas":
        "meanflow_audio_codec_torch.ops.imdct_cuda.imdct_cuda",
    "ops/imdct_pallas.py:DEFAULT_BATCH_TILE":
        "meanflow_audio_codec_torch.ops.imdct_cuda.imdct_cuda",
    "ops/imdct_pallas.py:DEFAULT_FRAME_TILE":
        "meanflow_audio_codec_torch.ops.imdct_cuda.imdct_cuda",
    "native_build.py:NativeLibrary":
        "meanflow_audio_codec_torch.ops._build.library",
    "tools/benchmarks/benchmark_audio_decoders.py:IN_IMAGE_MP3":
        "meanflow_audio_codec_torch.tools.benchmarks.benchmark_audio_decoders"
        ".in_package_mp3",
    "models/blocks.py:Dtype": "torch.dtype",
    "training/objectives.py:ApplyFn": "torch.nn.Module",
}
#: walked apart: the upstream oracle tests read, and the probes, whose
#: top-level names are the scripts' locals (they run at import)
NOT_WALKED = ("references/", "tools/probes/")


def _exports(init: Path) -> list[str]:
    tree = ast.parse(init.read_text())
    return [alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


def _resolve(path: str):
    parts = path.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for name in parts[cut:]:
            obj = getattr(obj, name)
        return obj
    raise ModuleNotFoundError(path)


def _top_level_names(root: Path) -> dict[str, str]:
    """Public top-level def, class and assigned names -> their file."""
    out: dict[str, str] = {}
    for path in sorted(root.rglob("*.py")):
        rel = str(path.relative_to(root))
        if rel.startswith(NOT_WALKED):
            continue
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, ast.Assign):
                names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                                ast.Name):
                names = [node.target.id]
            else:
                names = []
            for name in names:
                if not name.startswith("_"):
                    out.setdefault(name, rel)
    return out


SUBPACKAGES = sorted(p.parent.name for p in JAX_DIR.glob("*/__init__.py")
                     if _exports(p))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_exported_name_resolves_in_the_port(sub):
    """The port's subpackage of the same name exposes each name (the JAX
    ``configs`` package's names are the port's ``configs.py``'s)."""
    names = _exports(JAX_DIR / sub / "__init__.py")
    port = importlib.import_module(f"meanflow_audio_codec_torch.{sub}")
    missing = [n for n in names if not hasattr(port, n)]
    assert names and missing == []


def test_the_lazy_top_level_names_resolve():
    import meanflow_audio_codec_torch as port

    for name in LAZY:
        assert hasattr(jpkg, name)
        assert getattr(port, name).__name__ == name
    with pytest.raises(AttributeError):
        port.NotAName


def test_every_public_jax_name_is_in_the_port_or_a_departure():
    jax_names = _top_level_names(JAX_DIR)
    port_names = _top_level_names(PORT_DIR)
    departed = {key.split(":")[1] for key in DEPARTURES}
    missing = sorted(f"{f}:{n}" for n, f in jax_names.items()
                     if n not in port_names and n not in departed)
    assert missing == []


@pytest.mark.parametrize("key", sorted(DEPARTURES))
def test_each_departure_names_a_jax_name_and_a_port_name(key):
    path, name = key.split(":")
    tree = ast.parse((JAX_DIR / path).read_text())
    assert name in {n.name for n in tree.body if hasattr(n, "name")} | {
        t.id for n in tree.body if isinstance(n, ast.Assign)
        for t in n.targets if isinstance(t, ast.Name)}
    assert _resolve(DEPARTURES[key]) is not None


def test_the_submodules_the_exports_shadow_stay_importable():
    """``ops.mdct`` and ``training.train_step`` are the functions, as in the
    JAX package; the modules stay importable by their paths."""
    from meanflow_audio_codec_torch import ops, training

    assert ops.mdct is tmdct.mdct and callable(ops.mdct)
    assert training.train_step is ttrain.train_step
    assert tmdct.MDCTConfig is ops.MDCTConfig


_IMPORT_PROBE = """
import importlib, sys
from meanflow_audio_codec_torch.ops import _build
calls = []
for name in ("build", "library"):
    setattr(_build, name, lambda *a, _n=name, **k: calls.append(_n))
for sub in ("ops", "models", "training", "data", "evaluators", "parallel",
            "configs", "codec", "streaming"):
    importlib.import_module("meanflow_audio_codec_torch." + sub)
import meanflow_audio_codec_torch as port
[getattr(port, n) for n in ("AudioCodec", "StreamingCodec")]
jax = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "meanflow_audio_codec_tpu"))
print(calls, _build._libraries, jax)
"""


def test_importing_the_subpackages_builds_and_loads_nothing():
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] {} []"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

_SECTIONED = "meanflow_audio_codec_torch.configs._sectioned_dict:"
#: a JAX parameter the framework replaces -> the port parameter in its place
#: (``object:name`` where another port object takes it; None where the port
#: has nothing in its place). A bare key holds wherever the port object
#: lacks the JAX name; ``file:Object.parameter`` keys hold for that object.
FRAMEWORK_SWAPS = {
    "dtype": "compute_dtype",
    "key": "generator",
    "apply_fn": "model",
    "params": "model",
    "template": "state",
    "jitted_fn": "probe",
    "donate": None,  # torch has no buffer donation
    "use_pallas": None,  # the tensor's device picks kernel or plain version
    "interpret": None,  # Pallas's interpreter: a CPU tensor takes the plain
    "parent": None,  # Flax's module plumbing
    "name": None,
    "codec.py:AudioCodec.state": "state_dict",
    "streaming.py:frame_noise.key": "seed",
    "streaming.py:StreamingDecoder.key": "seed",
    "streaming.py:StreamingCodec.key": "seed",
    "ops/losses.py:learned_weight_terms.weight_params": "poly",
    "training/checkpoints.py:count_params.params": "state",
    "training/checkpoints.py:load_params_only.params_template": "model",
    "training/checkpoints.py:load_serving_checkpoint.params_template":
        "architecture",
    # the train state holds the model, the optimiser and the EMA decay; its
    # step is a property over the update count
    "models/train_state.py:TrainState.step": None,
    "models/train_state.py:TrainState.tx": "optimizer",
    "models/train_state.py:TrainState.opt_state": "optimizer",
    "models/train_state.py:TrainState.ema_params": "ema_decay",
    # departure 9: torch.distributed's own initialisation arguments
    "parallel/distributed.py:initialize_distributed.coordinator_address":
        "init_method",
    "parallel/distributed.py:initialize_distributed.num_processes":
        "world_size",
    "parallel/distributed.py:initialize_distributed.process_id": "rank",
    # departure 20: TrainFlowConfig is CodecConfig, whose constructor takes
    # the sections (and the deprecated output_dir/run_name) by keyword
    **{f"configs/config.py:TrainFlowConfig.{name}": _SECTIONED + name
       for name in ("base", "model", "training", "tpu", "output_dir",
                    "run_name", "config_version")},
}
#: port functions whose ``**options`` go to a constructor that names them
FORWARDS = {
    "create_conv_flow": "meanflow_audio_codec_torch.models.conv_flow."
                        "ConditionalConvFlow",
    "create_mlp_mixer_flow": "meanflow_audio_codec_torch.models.mlp_mixer."
                             "ConditionalMLPMixerFlow",
}


def _module(pkg: str, rel: str) -> str:
    return ".".join([pkg, *rel[:-3].split("/")]).removesuffix(".__init__")


def _parameters(obj) -> tuple[list[str], bool]:
    """Dataclass fields and signature parameters (a class's ``__init__``),
    and whether the signature takes ``**kwargs``."""
    names = ([f.name for f in dataclasses.fields(obj)]
             if isinstance(obj, type) and dataclasses.is_dataclass(obj)
             else [])
    var = False
    for p in inspect.signature(obj).parameters.values():
        if p.kind == p.VAR_KEYWORD:
            var = True
        elif p.kind != p.VAR_POSITIONAL and p.name not in names:
            names.append(p.name)
    return names, var


def _port_parameters(name: str, obj) -> set[str]:
    names, var = _parameters(obj)
    if var and name in FORWARDS:
        names += _parameters(_resolve(FORWARDS[name]))[0]
    return set(names)


def _jax_defs(rel: str) -> list[str]:
    tree = ast.parse((JAX_DIR / rel).read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


PARAMETER_MODULES = sorted(
    str(p.relative_to(JAX_DIR)) for p in JAX_DIR.rglob("*.py")
    if not str(p.relative_to(JAX_DIR)).startswith(NOT_WALKED)
    and _jax_defs(str(p.relative_to(JAX_DIR))))


@functools.cache
def _unmatched() -> list[tuple[str, str, str, set[str]]]:
    """Every (JAX file, object, parameter, port object's parameters) where
    the port object the name walk pairs with a public JAX function or class
    lacks the JAX parameter's name."""
    port_names = _top_level_names(PORT_DIR)
    departed = {key.split(":")[1] for key in DEPARTURES}
    out = []
    for rel in PARAMETER_MODULES:
        jmod = importlib.import_module(_module("meanflow_audio_codec_tpu",
                                               rel))
        same = (PORT_DIR / rel).exists() and importlib.import_module(
            _module("meanflow_audio_codec_torch", rel))
        for name in _jax_defs(rel):
            if name not in port_names or name in departed:
                continue
            pobj = getattr(same, name, None) if same else None
            if pobj is None:
                pobj = getattr(importlib.import_module(_module(
                    "meanflow_audio_codec_torch", port_names[name])), name)
            if not callable(pobj):  # a type alias of the port's
                continue
            port = _port_parameters(name, pobj)
            out += [(rel, name, param, port)
                    for param in _parameters(getattr(jmod, name))[0]
                    if param not in port]
    return out


def _swap_key(rel: str, name: str, param: str) -> str | None:
    for key in (f"{rel}:{name}.{param}", param):
        if key in FRAMEWORK_SWAPS:
            return key
    return None


@pytest.mark.parametrize("rel", PARAMETER_MODULES)
def test_every_jax_parameter_is_in_the_port_or_a_swap(rel):
    """Each parameter of each public JAX function and class (dataclass
    fields, ``__init__``) the name walk pairs with a port object is a
    parameter of that object, reached through its ``**options``
    (``FORWARDS``), or a ``FRAMEWORK_SWAPS`` entry."""
    missing = [f"{name}.{param}" for r, name, param, _ in _unmatched()
               if r == rel and _swap_key(r, name, param) is None]
    assert missing == []


@pytest.mark.parametrize("key", sorted(FRAMEWORK_SWAPS))
def test_each_framework_swap_names_the_port_parameter(key):
    """Each entry stands for a JAX parameter the port lacks, and the port
    parameter it names exists where it says."""
    uses = [port for rel, name, param, port in _unmatched()
            if _swap_key(rel, name, param) == key]
    assert uses, f"{key} stands for no JAX parameter"
    target = FRAMEWORK_SWAPS[key]
    if target is None:
        return
    if ":" in target:
        path, param = target.split(":")
        assert param in _parameters(_resolve(path))[0]
    else:
        assert all(target in port for port in uses)


def _audio_configs(**tokenization):
    """(JAX config, port config): audio through the MDCT at W 64."""
    data = {"base": {"batch_size": 2, "n_steps": 4, "base_lr": 1e-3,
                     "weight_decay": 0.0, "seed": 0},
            "model": {"noise_dimension": 128, "condition_dimension": 16,
                      "latent_dimension": 8, "num_blocks": 1},
            "training": {"sample_every": 4, "sample_seed": 0,
                         "sample_steps": 1, "workdir": "unused"},
            "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                        "tokenization_config": {
                            "window_size": 64, "frame_size": 1024,
                            "coeff_scale": 4.0, "gain_norm": 0.05,
                            **tokenization}}}
    return (jconfig.TrainFlowConfig.from_dict(data),
            configs.config_from_dict(data))


@pytest.mark.parametrize("mode", ["frames", "features"])
def test_adapter_from_config_takes_jax_mode_override(mode):
    """``mode`` wins over the config's layout, as in JAX; the tokens are
    JAX's (rtol 1e-4 / atol 1e-5, the MDCT's float32 sums)."""
    jcfg, cfg = _audio_configs()
    assert resolve_flatten_mode(cfg) == "frames"
    jadapter = jax_adapter_from_config(
        jcfg, jtok.MDCTTokenization(window_size=64), mode=mode)
    adapter = adapter_from_config(cfg, ttok.MDCTTokenization(64), mode=mode)
    assert adapter.mode == jadapter.mode == mode
    x = _x((2, 1024, 2), 9)
    np.testing.assert_allclose(
        _np(adapter.tokenize(torch.from_numpy(x))),
        np.asarray(jadapter.tokenize(jnp.asarray(x))), rtol=1e-4, atol=1e-5)
    assert adapter_from_config(cfg, ttok.MDCTTokenization(64)).mode == (
        "frames")


def test_the_jax_keyword_names_call_the_port():
    """``merge_configs(base=...)``, ``generate_config_diff(old_config=...,
    new_config=...)`` on config objects or dicts, and ``window_size=`` for
    the MDCT's FFT and direct paths, as the JAX package names them."""
    jcfg, cfg = _audio_configs()
    override = {"base": {"batch_size": 3}}
    merged = configs.merge_configs(base=cfg, override=override)
    assert merged.to_dict() == jconfig.merge_configs(
        base=jcfg, override=override).to_dict()
    out = Path(tempfile.mkdtemp()) / "diff.json"
    want = jconfig.diff_configs(jcfg, jconfig.merge_configs(jcfg, override))
    assert generate_config_diff(old_config=cfg, new_config=merged,
                                out_path=out) == want
    assert generate_config_diff(old_config=cfg.to_dict(),
                                new_config=merged.to_dict(),
                                out_path=out) == want
    x = _x((2, 1024), 10)
    for name in ("mdct_fft", "mdct_direct"):
        coeffs = getattr(tmdct, name)(torch.from_numpy(x), window_size=64)
        np.testing.assert_allclose(
            _np(coeffs), np.asarray(getattr(jmdct, name)(x, window_size=64)),
            **FFT_TOL)
        # an MDCTConfig still goes in the same place
        torch.testing.assert_close(coeffs, getattr(tmdct, name)(
            torch.from_numpy(x), tmdct.MDCTConfig(64)))
    for name in ("imdct_fft", "imdct_direct"):
        np.testing.assert_allclose(
            _np(getattr(tmdct, name)(coeffs, window_size=64)),
            np.asarray(getattr(jmdct, name)(np.asarray(_np(coeffs)),
                                            window_size=64)), **FFT_TOL)


def test_the_inert_conv_flow_fields_and_the_dtype_override():
    """``image_size`` and ``num_latent_tokens`` are taken in JAX's places
    and read nowhere (the parameters are the same without them);
    ``create_flow_model``'s ``compute_dtype`` is JAX's ``dtype``."""
    kw = dict(noise_dimension=64, condition_dimension=16, num_blocks=1,
              latent_dimension=8, channels=16)
    a = conv_flow.ConditionalConvFlow(**kw)
    b = conv_flow.ConditionalConvFlow(64, 16, 1, 8, 32, True, 4,
                                      channels=16)
    jmodel = jconv.ConditionalConvFlow(64, 16, 1, 8, 32, True, 4,
                                       channels=16)
    assert (b.image_size, b.num_latent_tokens) == (jmodel.image_size,
                                                    jmodel.num_latent_tokens)
    assert a.state_dict().keys() == b.state_dict().keys()
    assert create_conv_flow(64, 8, 1, 16, image_size=8).image_size == 8
    jcfg, cfg = _audio_configs()
    assert str(create_flow_model(cfg).compute_dtype).removeprefix(
        "torch.") == jnp.dtype(jax_create_flow_model(jcfg).dtype).name
    for jdtype, dtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        assert jax_create_flow_model(jcfg, dtype=jdtype).dtype == jdtype
        assert create_flow_model(cfg, compute_dtype=dtype
                                 ).compute_dtype == dtype


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

CONFIG_FILES = sorted((REPO / "configs").rglob("*.json"))
SECTIONS = ("base", "model", "dataset_config", "method_config", "training",
            "tpu")


def _flat_equal(jcfg, tcfg) -> None:
    for name in jconfig._FLAT_LOOKUP:
        want, got = getattr(jcfg, name), getattr(tcfg, name)
        if name == "workdir":  # the port's flat workdir is a str
            got = None if got is None else Path(got)
        if name in ("architecture_options", "tokenization_config"):
            want = {} if want is None else want  # the port's is {} unset
        assert got == want, name


@pytest.mark.parametrize("path", CONFIG_FILES,
                         ids=lambda p: str(p.relative_to(REPO / "configs")))
def test_every_config_reads_as_in_jax(path):
    jcfg = jconfig.load_config_from_json(path)
    tcfg = configs.load_config_from_json(path)
    assert isinstance(tcfg, configs.TrainFlowConfig)
    assert tcfg.to_dict() == jcfg.to_dict()
    _flat_equal(jcfg, tcfg)
    for name in SECTIONS:
        want, got = getattr(jcfg, name), getattr(tcfg, name)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.to_dict() == want.to_dict()
        # section access equals flat access for every field the flat
        # name reaches (``dataset``/``method`` are the names in both)
        for field in dataclasses.fields(got):
            if configs._FLAT_LOOKUP[field.name] != got.key:
                continue
            flat, value = getattr(tcfg, field.name), getattr(got, field.name)
            if field.name == "workdir" and flat is not None:
                flat = Path(flat)
            if field.name in configs._DICT_FIELDS:
                value = value or {}
            assert flat == value, field.name
    assert tcfg.get_schema() == jcfg.get_schema()
    assert tcfg.get_documentation() == jcfg.get_documentation()
    assert configs.TrainFlowConfig.from_dict(jcfg.to_dict()) == tcfg


DIFF_PAIRS = [("frontier_v2.json", "frontier_v2_qat.json"),
              ("frontier_v2.json", "frontier_v2.json"),
              ("frontier_v2.json", "corpus_rehearsal.json"),
              ("ablations/ablation--size=large.json",
               "ablations/ablation--size=small.json")]


@pytest.mark.parametrize("pair", DIFF_PAIRS, ids=lambda p: "-".join(p))
def test_print_config_diff_prints_as_jax(pair, capsys):
    a, b = (REPO / "configs" / name for name in pair)
    jconfig.print_config_diff(jconfig.diff_configs(
        jconfig.load_config_from_json(a), jconfig.load_config_from_json(b)))
    want = capsys.readouterr().out
    configs.print_config_diff(configs.diff_configs(
        configs.load_config_from_json(a), configs.load_config_from_json(b)))
    assert capsys.readouterr().out == want and want


BAD_VALUES = {"base": ("batch_size", 0), "model": ("condition_dimension", 3),
              "dataset": ("tokenization_strategy", "wavelet"),
              "method": ("noise_min", 2.0), "training": ("ema_decay", 1.5),
              "tpu": ("mesh_data", 0)}


@pytest.mark.parametrize("section", BAD_VALUES)
def test_a_bad_value_in_each_section_raises_in_both(section):
    field, value = BAD_VALUES[section]
    data = jconfig.load_config_from_json(
        REPO / "configs" / "frontier_v2.json").to_dict()
    data[section][field] = value
    with pytest.raises(ValueError, match=field):
        jconfig.TrainFlowConfig.from_dict(data)
    with pytest.raises(ValueError, match=field):
        configs.TrainFlowConfig.from_dict(data)
    jsec = jconfig._SECTION_TYPES[section](**data[section])
    tsec = configs._SECTION_TYPES[section](**data[section])
    for sec in (jsec, tsec):
        with pytest.raises(ValueError, match=field):
            sec.validate()


def _sections(pkg, output_dir=None, run_name=None, workdir=None):
    return pkg.TrainFlowConfig(
        base=pkg.BaseConfig(batch_size=4, n_steps=10, base_lr=1e-3,
                            weight_decay=0.0, seed=7),
        model=pkg.ModelConfig(noise_dimension=64, condition_dimension=16,
                              latent_dimension=8, num_blocks=2),
        dataset=pkg.AudioConfig(tokenization_config={"window_size": 64}),
        method=pkg.MethodConfig(use_improved_mean_flow=True),
        training=pkg.TrainingConfig(sample_every=5, sample_seed=0,
                                    sample_steps=2, workdir=workdir),
        output_dir=output_dir, run_name=run_name)


@pytest.mark.parametrize("run_name", [None, "named"])
def test_the_deprecated_output_dir_gives_jax_workdir_and_warning(run_name):
    got = []
    for pkg in (jconfig, configs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cfg = _sections(pkg, output_dir="runs", run_name=run_name)
        got.append((cfg, [(w.category, str(w.message)) for w in caught]))
    (jcfg, jwarn), (tcfg, twarn) = got
    assert jcfg.training.workdir == tcfg.training.workdir == Path(
        "runs") / (run_name or "seed7_improved")
    assert Path(tcfg.workdir) == jcfg.workdir
    assert twarn == jwarn and jwarn[0][0] is DeprecationWarning
    assert tcfg.to_dict() == jcfg.to_dict()
    # through the dict too
    data = dict(jcfg.to_dict(), output_dir="runs")
    del data["training"]["workdir"]
    if run_name:
        data["run_name"] = run_name
    with pytest.warns(DeprecationWarning, match="output_dir"):
        assert configs.config_from_dict(data).training.workdir == \
            jcfg.training.workdir


def test_the_sectioned_constructor_is_the_one_config_type():
    jcfg = _sections(jconfig, workdir="w")
    tcfg = _sections(configs, workdir="w")
    assert type(tcfg) is configs.CodecConfig is configs.TrainFlowConfig
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg == configs.config_from_dict(jcfg.to_dict())
    assert dataclasses.replace(tcfg, batch_size=8).base.batch_size == 8
    assert configs.MNISTConfig().to_dict() == jconfig.MNISTConfig().to_dict()
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcfg.base.batch_size = 2
    # the factories read it as any config
    assert tobj.create_loss_strategy(tcfg) == tobj.create_loss_strategy(
        configs.config_from_dict(jcfg.to_dict()))


# ---------------------------------------------------------------------------
# objectives: compute_loss, train_step, make_eval_step
# ---------------------------------------------------------------------------

FLOW = dict(condition_dimension=16, num_blocks=2, latent_dimension=8,
            channels=32, bottleneck_dim=32, spatial=4, lift_channels=8)
BATCH = 4
LR = 1e-3


def _pair(j: bool):
    return (jtime if j else ttime).MeanFlowTimeSampling(
        full_interval_proportion=0.25)


OBJECTIVES = {
    "fm": (lambda: jobj.FlowMatchingLoss(), lambda: tobj.FlowMatchingLoss()),
    "mf": (lambda: jobj.MeanFlowLoss(time_sampling=_pair(True)),
           lambda: tobj.MeanFlowLoss(time_sampling=_pair(False))),
    "imf": (lambda: jobj.ImprovedMeanFlowLoss(time_sampling=_pair(True)),
            lambda: tobj.ImprovedMeanFlowLoss(time_sampling=_pair(False))),
}


def _np(t):
    return t.detach().float().numpy()


def _grad_close(got: torch.Tensor, want: np.ndarray, name: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=1e-3, atol=1e-5 * scale,
                               err_msg=name)


@functools.cache
def _jax_flow(noise_dimension: int):
    jmodel = jconv.ConditionalConvFlow(noise_dimension=noise_dimension,
                                       **FLOW)
    x = jnp.zeros((BATCH, noise_dimension), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), x, jnp.zeros((BATCH, 2)), method="init_all"))
    rng = np.random.default_rng(noise_dimension)
    params = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        shapes["params"])
    return jmodel, params


def _optimizer_config():
    return _sections(jconfig, workdir="w")


@functools.cache
def _jax_state(noise_dimension: int):
    """JAX's state of the flow, shared (it is immutable), so that a jitted
    function compiled for it serves every test."""
    jmodel, params = _jax_flow(noise_dimension)
    return JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                tx=jax_make_optimizer(_optimizer_config()))


@functools.cache
def _jax_steps(name: str):
    """(JAX objective, jitted ``state, key, x -> (compute_loss(...),
    train_step(...))``): one compile per objective serves both tests."""
    jobjective = OBJECTIVES[name][0]()

    def both(state, key, x):
        return (jobjective.compute_loss(state, key, x),
                jstep.train_step(state, key, x, jobjective))

    return jobjective, jax.jit(both)


def _states(noise_dimension: int):
    """(JAX state, port state) of one flow with the same parameters and
    the same AdamW (clip 1.0 off: the sections' base has none)."""
    _, params = _jax_flow(noise_dimension)
    jcfg = _optimizer_config()
    jstate = _jax_state(noise_dimension)
    model = conv_flow.ConditionalConvFlow(noise_dimension=noise_dimension,
                                          **FLOW)
    weights.load_flax_params(model, params)
    state = TrainState(model, make_optimizer(
        configs.config_from_dict(jcfg.to_dict())), device="cpu")
    return jstate, state


def _draws(jobjective, key, x) -> dict:
    """What ``jobjective.loss`` draws from ``key`` on flat ``x``."""
    k_noise, k_time = jax.random.split(key)
    out = {"noise": jax.random.normal(k_noise, x.shape, dtype=x.dtype)}
    if isinstance(jobjective, jobj.FlowMatchingObjective):
        out["t"] = jobjective.time_sampling.sample_time(k_time, x.shape[0],
                                                        dtype=x.dtype)
    else:
        out["t"], out["r"] = jobjective.time_sampling.sample_time_pair(
            k_time, x.shape[0], dtype=x.dtype)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _x(shape, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


@pytest.mark.parametrize("name", OBJECTIVES)
def test_compute_loss_matches_jax(name):
    jobjective, steps = _jax_steps(name)
    objective = OBJECTIVES[name][1]()
    jstate, state = _states(64)
    x = _x((BATCH, 64), 1)
    key = jax.random.PRNGKey(3)
    (loss_ref, grads_ref), _ = steps(jstate, key, jnp.asarray(x))
    loss, grads = objective.compute_loss(
        state, None, torch.from_numpy(x),
        **_draws(jobjective, key, jnp.asarray(x)))
    np.testing.assert_allclose(_np(loss), np.asarray(loss_ref), rtol=1e-4)
    want = weights.flax_to_torch(grads_ref)
    assert len(grads) == len(state.params) == len(want)
    for param_name, g in zip(state.names, grads):
        _grad_close(g, want[param_name].numpy(), param_name)


@pytest.mark.parametrize("name", OBJECTIVES)
def test_train_step_matches_jax(name):
    """Two steps of JAX's ``train_step`` against the port's: the losses and
    the parameters after each AdamW update."""
    jobjective, steps = _jax_steps(name)
    objective = OBJECTIVES[name][1]()
    jstate, state = _states(64)
    for k in range(2):
        x = _x((BATCH, 64), 10 + k)
        key = jax.random.PRNGKey(20 + k)
        _, (jstate, loss_ref) = steps(jstate, key, jnp.asarray(x))
        state, loss = ttrain.train_step(
            state, None, torch.from_numpy(x), objective,
            **_draws(jobjective, key, jnp.asarray(x)))
        np.testing.assert_allclose(_np(loss), np.asarray(loss_ref),
                                   rtol=1e-4)
        got = dict(state.model.named_parameters())
        for param_name, value in weights.flax_to_torch(jstate.params).items():
            np.testing.assert_allclose(_np(got[param_name]), value.numpy(),
                                       rtol=0, atol=1e-2 * LR,
                                       err_msg=param_name)
    assert state.step == int(jstate.step) == 2


# tokenizer label -> (JAX tokenizer, the port's, raw batch shape, flat width)
TOKENIZERS = {
    "mdct": (lambda: jtok.MDCTTokenization(window_size=16),
             lambda: ttok.MDCTTokenization(window_size=16), (BATCH, 128, 2),
             15 * 16 * 2),
    "reshape": (lambda: jtok.ReshapeTokenization(patch_length=32),
                lambda: ttok.ReshapeTokenization(patch_length=32),
                (BATCH, 96), 96),
}


@pytest.mark.parametrize("label", TOKENIZERS)
def test_make_eval_step_matches_jax(label):
    make_jtok, make_ttok, shape, width = TOKENIZERS[label]
    jobjective = OBJECTIVES["imf"][0]()
    objective = OBJECTIVES["imf"][1]()
    jstate, state = _states(width)
    batch = _x(shape, 30)
    key = jax.random.PRNGKey(31)
    jtokenizer = make_jtok()
    want = jstep.make_eval_step(jobjective, jtokenizer)(
        jstate, key, jnp.asarray(batch))
    x = jtokenizer.tokenize(jnp.asarray(batch)).reshape(BATCH, -1)
    assert x.shape == (BATCH, width)
    before = [p.clone() for p in state.params]
    got = ttrain.make_eval_step(objective, make_ttok())(
        state, None, torch.from_numpy(batch), **_draws(jobjective, key, x))
    assert set(got) == set(want) == {"loss", "mse"}
    for metric in got:
        assert not got[metric].requires_grad
        np.testing.assert_allclose(_np(got[metric]), np.asarray(want[metric]),
                                   rtol=1e-4, err_msg=metric)
    assert all(torch.equal(a, b) for a, b in zip(before, state.params))
    assert state.step == 0


def test_eval_step_draws_from_its_generator():
    objective = OBJECTIVES["imf"][1]()
    _, state = _states(96)
    step = ttrain.make_eval_step(objective, ttok.ReshapeTokenization(
        patch_length=32))
    batch = torch.from_numpy(_x((BATCH, 96), 32))
    a, b, c = (step(state, torch.Generator().manual_seed(s), batch)["loss"]
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_init_learned_weight_params_matches_jax():
    got, want = losses.init_learned_weight_params(), \
        jlosses.init_learned_weight_params()
    assert set(got) == set(want) == {"poly"}
    assert got["poly"].dtype == torch.float32
    np.testing.assert_array_equal(got["poly"].numpy(), np.asarray(want["poly"]))
    model = losses.attach_learned_weighting(torch.nn.Module())
    assert torch.equal(model.loss_weighting.poly.detach(), got["poly"])


# ---------------------------------------------------------------------------
# the MDCT's FFT threshold
# ---------------------------------------------------------------------------

THRESHOLD = 256
FFT_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("window", [256, 128], ids=["fft", "direct"])
@pytest.mark.parametrize("transform", ["mdct", "imdct"])
def test_the_fft_threshold_picks_the_path_as_jax(transform, window):
    hop = window // 2
    if transform == "mdct":
        x = _x((2, 6 * window + 50), 40)
        other = (tmdct.mdct_fft if window >= THRESHOLD
                 else tmdct.mdct_direct)(torch.from_numpy(x), window, hop)
        layer = MDCTLayer(window, hop, use_fft_threshold=THRESHOLD)
    else:
        x = _x((2, 5, window), 41)
        other = (tmdct.imdct_fft if window >= THRESHOLD
                 else tmdct.imdct_direct)(torch.from_numpy(x), window, hop)
        layer = IMDCTLayer(window, hop, use_fft_threshold=THRESHOLD)
    port_fn, jax_fn = getattr(tmdct, transform), getattr(jmdct, transform)
    want = jax_fn(jnp.asarray(x), window_size=window, hop_size=hop,
                  use_fft_threshold=THRESHOLD)
    got = port_fn(torch.from_numpy(x), window_size=window, hop_size=hop,
                  use_fft_threshold=THRESHOLD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFT_TOL)
    torch.testing.assert_close(got, other, rtol=0, atol=0)
    cfg = tmdct.MDCTConfig(window, hop, use_fft_threshold=THRESHOLD)
    torch.testing.assert_close(port_fn(torch.from_numpy(x), config=cfg), got,
                               rtol=0, atol=0)
    torch.testing.assert_close(port_fn(torch.from_numpy(x), cfg), got,
                               rtol=0, atol=0)
    torch.testing.assert_close(layer(torch.from_numpy(x)), got, rtol=0,
                               atol=0)


def test_the_threshold_must_be_positive_in_both():
    for make in (tmdct.MDCTConfig, jmdct.MDCTConfig):
        with pytest.raises(ValueError, match="use_fft_threshold"):
            make(64, use_fft_threshold=0)


# ---------------------------------------------------------------------------
# stage_fusable, device_time
# ---------------------------------------------------------------------------

GEOMETRIES = [(8, 256), (8, 512), (4, 128), (4, 64), (3, 48), (1, 1),
              (0, 256), (8, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.float64],
                         ids=str)
def test_stage_fusable_is_the_wrappers_rule(dtype):
    """True exactly where the wrappers launch for ``[B, S*S, C]`` (and the
    GELU+GRN's ``[B, S*S, 2C]``): float32 or bfloat16, non-empty; every
    geometry JAX's lane rule fuses is fusable here too."""
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
              torch.float16: jnp.float16, torch.float64: jnp.float32}[dtype]
    for spatial, channels in GEOMETRIES:
        fusable = stage.stage_fusable(spatial, channels, dtype)
        assert fusable == (dtype in (torch.float32, torch.bfloat16)
                           and spatial > 0 and channels > 0)
        assert fusable == (spatial > 0 and channels > 0 and all(
            stage_cuda.takes(spatial * spatial, c, dtype)
            for c in (channels, 2 * channels)))
        if (dtype != torch.float64 and spatial and channels
                and jstage.stage_fusable(spatial, channels, jdtype)):
            assert fusable
    assert stage.stage_fusable(8, 256)  # frontier-v2, bf16 by default


def test_device_time_times_calls_and_forces_completion():
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": (a * 2, [a + 1])}

    seconds = profiling.device_time(fn, torch.ones(3), iters=4, warmup=2)
    assert seconds > 0 and len(calls) == 6
    assert profiling.force_completion(fn(torch.full((2,), 3.0))) == 4.0


# ---------------------------------------------------------------------------
# the repaired device defaults
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)


def test_profiling_trainer_asks_for_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.ProfilingTrainer()
    assert profiling.ProfilingTrainer(device="cpu").peak is None


def test_experiment_metadata_asks_for_the_card(no_card):
    cfg = _sections(configs, workdir="w")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collect_experiment_metadata(cfg)
    meta = collect_experiment_metadata(cfg, device="cpu")
    assert meta["backend"] == "cpu" and meta["devices"] == ["cpu"]


def test_distributed_groups_ask_for_the_card(no_card):
    from meanflow_audio_codec_torch.parallel import initialize_distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed(address, world_size=2, rank=0)
    assert not dist.is_initialized()
    assert initialize_distributed() is False  # one process: no group
    try:
        assert initialize_distributed(address, world_size=1, rank=0,
                                      device="cpu") is True
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
