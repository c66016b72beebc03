"""The benchmark stays apart from the JAX package and from the old TPU
benchmark files, and its reference from the program."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "meanflow_audio_codec_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set[str]:
    """The top-level name of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_loaded_modules_are_compared_by_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "meanflow_audio_codec_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "meanflow_audio_codec_tpu.codec", sys)
    assert harness.forbidden_modules() == ["meanflow_audio_codec_tpu.codec"]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "meanflow_audio_codec_torch" not in names
    assert names <= {"__future__", "functools", "math", "re", "dataclasses", "numpy",
                     "torch", "portbench"}
    assert "meanflow_audio_codec_torch" not in path.read_text()


def test_only_program_py_and_the_tests_import_the_program():
    users = {p.relative_to(BENCH).as_posix() for p in SOURCES
             if "meanflow_audio_codec_torch" in imported(p)}
    assert {u for u in users if not u.startswith("tests/")} == {"program.py", "run.py"}


@pytest.mark.parametrize("path", [p for p in SOURCES if p.name != Path(__file__).name],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_reads_the_old_tpu_benchmark(path):
    text = path.read_text()
    for name in ("bench.py", "BENCH_r", "MULTICHIP_r", "BASELINE."):
        assert name not in text


def test_a_checkout_without_the_program_fails_and_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "corpus_v2.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "corpus_v2.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr
