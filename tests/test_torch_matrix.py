"""PyTorch port: the matrix smoke (``tools/matrix_smoke.py``) on the CPU.

Twelve of the 48 ``configs/method=*.json`` — one per architecture x
tokenization x dataset, the four methods rotated so that each appears three
times — train end to end with the JAX smoke's tiny overrides and end on a
finite loss. All 48 run under ``-m slow`` (about 3 minutes on the CPU).
"""

import itertools
from pathlib import Path

import pytest

from meanflow_audio_codec_tpu.tools import matrix_smoke as jsmoke
from meanflow_audio_codec_torch.tools import matrix_smoke

REPO = Path(__file__).resolve().parents[1]
METHODS = ("autoencoder", "flow_matching", "mean_flow", "improved_mean_flow")
ARCHITECTURES = ("convnet", "mlp", "mlp_mixer")
DATASETS = ("audio", "mnist")
TOKENIZATIONS = ("mdct", "reshape")
ALL = sorted(p.name for p in (REPO / "configs").glob("method=*.json"))


def _name(method, architecture, dataset, tokenization):
    return (f"method={method}--architecture={architecture}--dataset="
            f"{dataset}--tokenization={tokenization}.json")


ROTATED = [_name(METHODS[i % 4], a, d, t) for i, (a, d, t) in enumerate(
    itertools.product(ARCHITECTURES, DATASETS, TOKENIZATIONS))]


def test_the_subset_covers_the_matrix():
    assert len(ALL) == 48 and set(ROTATED) <= set(ALL)
    assert all(sum(METHODS[i % 4] == m for i in range(12)) == 3
               for m in METHODS)
    assert matrix_smoke.TINY_OVERRIDES == jsmoke.TINY_OVERRIDES
    assert matrix_smoke.AUDIO_TOK == jsmoke.AUDIO_TOK


def _smoke(name, tmp_path):
    ok, note, _ = matrix_smoke.smoke_one(REPO / "configs" / name, tmp_path,
                                         device="cpu")
    assert ok, note


@pytest.mark.parametrize("name", ROTATED)
def test_matrix_config_trains(name, tmp_path):
    _smoke(name, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("name", ALL)
def test_every_matrix_config_trains(name, tmp_path):
    _smoke(name, tmp_path)


def test_main_reports_and_returns_its_verdict(tmp_path, capsys):
    report = tmp_path / "report.json"
    code = matrix_smoke.main([
        "--configs", str(REPO / "configs"), "--out", str(tmp_path / "runs"),
        "--filter", "method=flow_matching--architecture=mlp--dataset=mnist",
        "--report", str(report), "--device", "cpu"])
    assert code == 0 and report.exists()
    assert "2/2 configs train end-to-end" in capsys.readouterr().out
