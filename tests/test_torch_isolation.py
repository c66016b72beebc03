"""The PyTorch port stands alone: importing it (and chip_smoke.py) loads no
JAX, Flax, Optax, msgpack, orbax, tensorstore or zstandard module and
nothing of the JAX package, and no file of the port names one in an import
(the codec CLI included). The
kernel wrappers, ``ops/_build.py`` and the stored format's coder hold no
``try``: a CUDA tensor goes to the kernel or raises, and a coder that does
not build raises rather than storing raw codes."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "meanflow_audio_codec_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "orbax",
             "tensorstore", "zstandard", "meanflow_audio_codec_tpu")

_PROBE = """
import importlib, pkgutil, sys
import meanflow_audio_codec_torch as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
import chip_smoke
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in {forbidden!r})))
"""


def test_importing_the_port_loads_no_jax():
    code = _PROBE.format(forbidden=set(FORBIDDEN))
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == ""


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py"], ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_of_the_port_imports_jax(path):
    bad = [name for name in _imported_modules(path)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_the_serving_modules_are_checked():
    """The serving surface (streaming, the CLI subpackage, the stored
    format and its coder) is among the files the tests above walk."""
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"streaming.py", "tools/__init__.py", "tools/codec_cli.py",
            "ops/latent_quant.py", "ops/entropy.py"} <= names


def test_the_timing_tools_are_checked():
    """Every timing tool of the JAX package (its 12 benchmark scripts and 5
    probes) has a counterpart of the same name among the files the tests
    above walk."""
    ref = REPO / "meanflow_audio_codec_tpu" / "tools"
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    tools = {str(p.relative_to(ref.parent)) for sub in ("benchmarks", "probes")
             for p in (ref / sub).glob("*.py")}
    assert len(tools - {"tools/benchmarks/__init__.py"}) == 17
    assert tools <= names


def test_the_parallel_layer_and_run_tools_are_checked():
    """The JAX package's ``parallel/`` modules, its supervisor and its
    wavegen tool have counterparts of the same name among the files the
    tests above walk (so none of them imports JAX)."""
    ref = REPO / "meanflow_audio_codec_tpu"
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    wanted = {str(p.relative_to(ref)) for p in (ref / "parallel").glob("*.py")}
    assert len(wanted) == 3
    assert wanted | {"tools/supervise.py", "tools/download_wavegen.py",
                     "parallel/sharded_state.py"} <= names


def test_the_orbax_modules_are_checked():
    """The orbax checkpoint layer (the zstd binding, OCDBT, zarr and the
    pytree layout) is among the files the tests above walk, and its native
    decoder is one of the sources the builder compiles."""
    from meanflow_audio_codec_torch.ops import _build

    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {f"training/orbax/{m}.py" for m in ("zstd", "ocdbt", "zarr",
                                               "pytree")} <= names
    assert _build.HOST_SOURCES["zstd"] == PORT / "csrc" / "zstd.cpp"


def test_the_proj_trials_are_checked():
    """Each trial of the repository's ``proj/`` has a counterpart of the
    same name under the port's ``proj/`` among the files the tests above
    walk (importing it loads no JAX)."""
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    trials = {p.parent.name for p in (REPO / "proj").glob("*/train.py")}
    assert len(trials) == 3
    assert {f"proj/{t}.py" for t in trials} | {"proj/__init__.py"} <= names


_CLI_PROBE = """
import runpy, sys
sys.argv = ["codec_cli", "info", {path!r}]
try:
    runpy.run_module("meanflow_audio_codec_torch.tools.codec_cli",
                     run_name="__main__")
except SystemExit:
    pass
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in {forbidden!r})))
"""


def test_the_codec_cli_runs_without_jax(tmp_path):
    path = tmp_path / "empty.macb"
    path.write_bytes(b"MACB" + bytes([1, 8, 0, 0]) + bytes(20))
    code = _CLI_PROBE.format(path=str(path), forbidden=set(FORBIDDEN))
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    info, loaded = result.stdout.split("\n")[:2]
    assert info.endswith("MACB v1, 8-bit raw codes (symmetric), batch=0 "
                         "frames=0 latent_dim=0, 28 bytes")
    assert loaded == ""


@pytest.mark.parametrize("name", ["ops/mdct_cuda.py", "ops/imdct_cuda.py",
                                  "ops/stage_cuda.py", "ops/_build.py",
                                  "ops/entropy.py", "ops/latent_quant.py",
                                  "training/orbax/zstd.py"])
def test_kernel_paths_have_no_fallback_try(name):
    tree = ast.parse((PORT / name).read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))
