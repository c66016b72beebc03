"""PyTorch port: ``data/mnist.py`` against the JAX package — the glyphs,
the synthetic digit sets and ``load_mnist``'s batches bit for bit (numpy's
``default_rng`` on both sides), the local ``mnist.npz`` source and the
normalisation. No tolerance: the batches are compared exactly.
"""

import numpy as np
import pytest

from meanflow_audio_codec_tpu.data import mnist as jmnist
from meanflow_audio_codec_torch.data import mnist


@pytest.fixture(autouse=True)
def _no_local_copy(monkeypatch, tmp_path):
    # no tfds here; point the local source at an empty directory
    monkeypatch.setenv("MNIST_DIR", str(tmp_path / "empty"))


@pytest.mark.parametrize("digit", range(10))
def test_glyphs_match_jax(digit):
    np.testing.assert_array_equal(mnist._render_digit(digit),
                                  jmnist._render_digit(digit))


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_digits_match_jax(seed):
    ours = mnist.synthetic_mnist(64, 16, seed=seed)
    ref = jmnist.synthetic_mnist(64, 16, seed=seed)
    for a, b in zip(ours, ref):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,batch", [(0, 4), (42, 128)])
def test_load_mnist_batches_match_jax(seed, batch):
    train, test = mnist.load_mnist(batch, seed=seed)
    jtrain, jtest = jmnist.load_mnist(batch, seed=seed)
    for _ in range(3):
        a, b = next(train), next(jtrain)
        assert a.shape == (batch, 784) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    a, b = next(test), next(jtest)
    np.testing.assert_array_equal(a, b)
    assert mnist.load_mnist_arrays()[2] == "synthetic"


def test_local_npz_is_read(monkeypatch, tmp_path):
    rng = np.random.default_rng(1)
    x_train = rng.integers(0, 256, (10, 28, 28), dtype=np.uint8)
    x_test = rng.integers(0, 256, (6, 28, 28), dtype=np.uint8)
    np.savez(tmp_path / "mnist.npz", x_train=x_train, x_test=x_test)
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    train, test, source = mnist.load_mnist_arrays()
    assert source == "local" == jmnist.load_mnist_arrays()[2]
    np.testing.assert_array_equal(train, x_train)
    np.testing.assert_array_equal(test, x_test)
    it, jit = mnist.load_mnist(3, seed=2)[0], jmnist.load_mnist(3, seed=2)[0]
    np.testing.assert_array_equal(next(it), next(jit))


def test_normalize_maps_uint8_to_unit_interval():
    images = np.array([[[0, 255], [127, 128]]], dtype=np.uint8)
    got = mnist._normalize(images)
    np.testing.assert_array_equal(got, jmnist._normalize(images))
    assert got.shape == (1, 4) and got.min() == -1.0 and got.max() == 1.0
