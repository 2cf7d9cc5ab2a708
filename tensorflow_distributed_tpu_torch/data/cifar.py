"""CIFAR-10 and the synthetic image sets of the ResNet configurations:
the port of ``data/cifar.py``, on the same ``Dataset`` / batcher
contract as MNIST.

CIFAR-10's binary distribution ("cifar-10-batches-bin"): each record is
1 label byte + 3072 image bytes (1024 R, 1024 G, 1024 B, row-major
32x32); ``data_batch_{1..5}.bin`` (train) and ``test_batch.bin``. The
synthetic sets draw from ``np.random.default_rng(seed)`` in the JAX
package's order, so both packages get the same arrays for a seed.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from tensorflow_distributed_tpu_torch.data.mnist import Dataset, _to_splits

_RECORD = 1 + 3 * 32 * 32
_TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
_TEST_FILE = "test_batch.bin"


def parse_cifar_batch(raw: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """One .bin file -> (images u8 [N, 32, 32, 3], labels i32 [N])."""
    if len(raw) % _RECORD != 0:
        raise ValueError(f"cifar: file size {len(raw)} not a multiple of "
                         f"record size {_RECORD}")
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(-1, _RECORD)
    labels = rec[:, 0].astype(np.int32)
    # CHW planes -> HWC.
    images = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).copy()
    return images, labels


def load_cifar10(data_dir: str, validation_size: int = 5000
                 ) -> Tuple[Dataset, Dataset, Dataset]:
    """The binary CIFAR-10 distribution from ``data_dir`` (directly or
    under a cifar-10-batches-bin/ subdirectory)."""
    wanted = _TRAIN_FILES + [_TEST_FILE]
    for base in (data_dir, os.path.join(data_dir, "cifar-10-batches-bin")):
        present = [f for f in wanted if os.path.exists(os.path.join(base, f))]
        if present:
            break
    if not present:
        raise FileNotFoundError(
            f"CIFAR-10 .bin files not found under {data_dir}. This "
            "environment has no network egress; place the binary "
            "distribution there or use dataset='cifar10_synthetic'.")
    if len(present) != len(wanted):
        # A partial copy must not fall through to the synthetic fallback
        # (load_dataset catches FileNotFoundError).
        missing = sorted(set(wanted) - set(present))
        raise ValueError(
            f"CIFAR-10 under {base} is incomplete: missing {missing}")
    ims, labs = [], []
    for fname in _TRAIN_FILES:
        with open(os.path.join(base, fname), "rb") as f:
            i, l = parse_cifar_batch(f.read())
        ims.append(i)
        labs.append(l)
    train_images = np.concatenate(ims).astype(np.float32) / 255.0
    train_labels = np.concatenate(labs)
    with open(os.path.join(base, _TEST_FILE), "rb") as f:
        ti, tl = parse_cifar_batch(f.read())
    return _to_splits(train_images, train_labels,
                      ti.astype(np.float32) / 255.0, tl,
                      validation_size, "cifar10")


def synthetic_images(n_train: int, n_test: int, validation_size: int,
                     shape: Tuple[int, int, int], num_classes: int,
                     seed: int, name: str
                     ) -> Tuple[Dataset, Dataset, Dataset]:
    """A deterministic, learnable synthetic classification set: each
    class is a fixed smooth colour template (coarse, upsampled 4x), a
    sample its template plus noise of sigma 0.35, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    n = n_train + n_test
    templates = rng.uniform(0.0, 1.0, size=(num_classes, -(-h // 4),
                                            -(-w // 4), c)).astype(np.float32)
    templates = np.kron(templates, np.ones(
        (1, 4, 4, 1), np.float32))[:, :h, :w, :]
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = templates[labels]
    # The f32 noise is drawn directly: no float64 temporary of the
    # ImageNet-shaped set.
    images += 0.35 * rng.standard_normal(images.shape, dtype=np.float32)
    images = np.clip(images, 0.0, 1.0)
    return _to_splits(images[:n_train], labels[:n_train],
                      images[n_train:], labels[n_train:],
                      validation_size, name)


def synthetic_cifar10(n_train: int = 8000, n_test: int = 1000,
                      validation_size: int = 1000, seed: int = 0
                      ) -> Tuple[Dataset, Dataset, Dataset]:
    return synthetic_images(n_train, n_test, validation_size,
                            (32, 32, 3), 10, seed, "cifar10_synthetic")


def synthetic_imagenet(n_train: int = 2048, n_test: int = 512,
                       validation_size: int = 512, seed: int = 0,
                       image_size: int = 224, num_classes: int = 1000
                       ) -> Tuple[Dataset, Dataset, Dataset]:
    """ImageNet-shaped synthetic data for ResNet-50 (shapes and
    throughput, not accuracy)."""
    return synthetic_images(n_train, n_test, validation_size,
                            (image_size, image_size, 3), num_classes, seed,
                            "imagenet_synthetic")
