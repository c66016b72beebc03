"""MNIST data; counterpart of ``meanflow_audio_codec_tpu/data/mnist.py``
(numpy only: the port keeps its own copy).

``load_mnist(batch_size, seed)`` returns ``(train_iter, test_iter)`` of
float32 ``[B, 784]`` batches in [-1, 1]: train an infinite random-index
sampler, test one sequential pass. The images come from the first source
that answers:

  1. ``tensorflow_datasets``, when it imports;
  2. ``mnist.npz`` (``x_train``, ``x_test``) under ``$MNIST_DIR``, by
     default ``~/datasets/mnist``;
  3. deterministic synthetic digits (7-segment glyphs, shifted, with
     noise), so training runs without either.

The same seed gives the JAX package's batches bit for bit (numpy's
``default_rng`` on both sides).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator

import numpy as np

IMAGE_DIM = 784


def _normalize(images: np.ndarray) -> np.ndarray:
    """uint8 ``[N, 28, 28]`` -> float32 ``[N, 784]`` in [-1, 1]."""
    flat = images.reshape(len(images), -1).astype(np.float32)
    return flat / 127.5 - 1.0


def _try_tfds() -> tuple[np.ndarray, np.ndarray] | None:
    try:
        import tensorflow_datasets as tfds
        train = tfds.load("mnist", split="train", batch_size=-1)
        test = tfds.load("mnist", split="test", batch_size=-1)
        train_images = np.asarray(tfds.as_numpy(train)["image"])[..., 0]
        test_images = np.asarray(tfds.as_numpy(test)["image"])[..., 0]
        return train_images, test_images
    except Exception:
        return None


def _try_local() -> tuple[np.ndarray, np.ndarray] | None:
    root = Path(os.environ.get("MNIST_DIR",
                               Path.home() / "datasets" / "mnist"))
    npz = root / "mnist.npz"
    if npz.exists():
        data = np.load(npz)
        return data["x_train"], data["x_test"]
    return None


# ---- synthetic digits -------------------------------------------------------

# 7-segment layout per digit: (top, top-left, top-right, middle, bottom-left,
# bottom-right, bottom)
_SEGMENTS = {
    0: (1, 1, 1, 0, 1, 1, 1), 1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1), 3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0), 5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1), 7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1), 9: (1, 1, 1, 1, 0, 1, 1),
}


def _render_digit(digit: int) -> np.ndarray:
    """The 28x28 glyph of one digit."""
    img = np.zeros((28, 28), dtype=np.float32)
    top, top_left, top_right, middle, bottom_left, bottom_right, bottom = (
        _SEGMENTS[digit % 10])
    x0, x1, y0, ym, y1 = 8, 20, 4, 14, 24
    thick = 2
    if top:
        img[y0:y0 + thick, x0:x1] = 1.0
    if top_left:
        img[y0:ym, x0:x0 + thick] = 1.0
    if top_right:
        img[y0:ym, x1 - thick:x1] = 1.0
    if middle:
        img[ym:ym + thick, x0:x1] = 1.0
    if bottom_left:
        img[ym:y1, x0:x0 + thick] = 1.0
    if bottom_right:
        img[ym:y1, x1 - thick:x1] = 1.0
    if bottom:
        img[y1:y1 + thick, x0:x1] = 1.0
    return img


def synthetic_mnist(num_train: int = 8192, num_test: int = 1024,
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like uint8 image sets ``[N, 28, 28]``: random
    digits, each shifted by up to 3 pixels and noised."""
    rng = np.random.default_rng(seed)
    glyphs = np.stack([_render_digit(d) for d in range(10)])

    def make(n):
        images = glyphs[rng.integers(0, 10, size=n)]
        shifted = np.empty_like(images)
        for i, img in enumerate(images):
            dy, dx = rng.integers(-3, 4, size=2)
            shifted[i] = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
        noisy = shifted + rng.normal(0, 0.08, shifted.shape)
        return (np.clip(noisy, 0, 1) * 255).astype(np.uint8)

    train = make(num_train)
    return train, make(num_test)


def load_mnist_arrays() -> tuple[np.ndarray, np.ndarray, str]:
    """(train images, test images, source name), uint8 ``[N, 28, 28]``."""
    loaded = _try_tfds()
    if loaded is not None:
        return (*loaded, "tfds")
    loaded = _try_local()
    if loaded is not None:
        return (*loaded, "local")
    return (*synthetic_mnist(), "synthetic")


def load_mnist(batch_size: int, seed: int = 0
               ) -> tuple[Iterator[np.ndarray], Iterator[np.ndarray]]:
    """(infinite train iterator, one-pass test iterator) of float32
    ``[B, 784]`` batches in [-1, 1]."""
    train_images, test_images, _ = load_mnist_arrays()
    train = _normalize(train_images)
    test = _normalize(test_images)
    rng = np.random.default_rng(seed)

    def train_iter():
        while True:
            yield train[rng.integers(0, len(train), size=batch_size)]

    def test_iter():
        for start in range(0, len(test) - batch_size + 1, batch_size):
            yield test[start:start + batch_size]

    return train_iter(), test_iter()
