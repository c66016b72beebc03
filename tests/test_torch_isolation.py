"""The PyTorch port stands alone: importing it (and chip_smoke.py) loads no
JAX, Flax or Optax module and nothing of the JAX package, and no file of the
port names one in an import. The kernel wrappers hold no ``try``: a CUDA
tensor goes to the kernel or raises."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "meanflow_audio_codec_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "meanflow_audio_codec_tpu")

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


@pytest.mark.parametrize("name", ["ops/mdct_cuda.py", "ops/imdct_cuda.py",
                                  "ops/stage_cuda.py", "ops/_build.py"])
def test_kernel_paths_have_no_fallback_try(name):
    tree = ast.parse((PORT / name).read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))
