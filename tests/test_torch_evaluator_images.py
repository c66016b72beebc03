"""PyTorch port: ``ComprehensiveEvaluator`` against the JAX package's on the
MNIST run of tests/test_torch_evaluator.py (a checkpoint JAX's own ``train_flow``
writes: synthetic MNIST, reshape tokenizer, an MLP flow, latent 4), with
JAX's start noise passed in: the image metrics (MSE, PSNR, SSIM, FID, KID)
within rtol 1e-4, the keys and parameter counts equal.
"""

import pytest
from test_torch_evaluator import (
    PASSES,
    check_keys,
    check_metrics,
    check_parameter_counts,
    evaluate_both,
    train_run,
)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return train_run("mnist", tmp_path_factory.mktemp("mnist"))


@pytest.fixture(scope="module")
def evaluations(run):
    return evaluate_both("mnist", run)


@pytest.mark.parametrize("label", list(PASSES))
def test_result_keys_match_jax(evaluations, label):
    check_keys("mnist", *evaluations[label])


@pytest.mark.parametrize("label", list(PASSES))
def test_metrics_match_jax(evaluations, label):
    check_metrics(*evaluations[label])


@pytest.mark.parametrize("label", ["bits8", "ecsq0.5"])
def test_stored_formats_on_images_carry_no_kbps(evaluations, label):
    ref, got = evaluations[label]
    assert "bitstream_kbps_measured" not in got
    assert "bitstream_kbps_measured" not in ref


def test_parameter_counts_match_jax(run):
    check_parameter_counts(run)
