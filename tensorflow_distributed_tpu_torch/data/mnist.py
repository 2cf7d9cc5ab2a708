"""MNIST data (numpy): the port of ``data/mnist.py``'s idx parser,
splits, synthetic digits and process-sharded batcher.

The arrays equal the JAX package's byte for byte (same parse, same
seeded generator draws, same splits), so both packages train on the
same rows. Global batch B over P processes: process p takes rows
[p*B/P, (p+1)*B/P) of each global batch (``data/batcher.py``), so a
D-way data-parallel run consumes exactly the sample stream of a 1-way
run. The idx files are read by the native C++ reader where it builds
(``native/runtime.py``), else with numpy; ``load_dataset`` dispatches
over every vision dataset (the CIFAR-10 and synthetic image sets are
``data/cifar.py``'s).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Tuple

import numpy as np

from tensorflow_distributed_tpu_torch.data.batcher import Batcher

# idx magic numbers: 0x801 = unsigned-byte 1-D (labels),
# 0x803 = unsigned-byte 3-D (images).
_IDX_LABELS_MAGIC = 2049
_IDX_IMAGES_MAGIC = 2051

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def parse_idx(raw: bytes) -> np.ndarray:
    """Parse idx-format bytes (labels [N] or images [N, rows, cols],
    uint8)."""
    if len(raw) < 8:
        raise ValueError("idx: truncated header")
    magic = struct.unpack(">i", raw[:4])[0]
    if magic == _IDX_LABELS_MAGIC:
        (n,) = struct.unpack(">i", raw[4:8])
        data = np.frombuffer(raw, dtype=np.uint8, count=n, offset=8)
        return data.copy()
    if magic == _IDX_IMAGES_MAGIC:
        n, rows, cols = struct.unpack(">iii", raw[4:16])
        data = np.frombuffer(raw, dtype=np.uint8, count=n * rows * cols,
                             offset=16)
        return data.reshape(n, rows, cols).copy()
    raise ValueError(f"idx: unknown magic {magic}")


def _read_idx_file(path: str) -> np.ndarray:
    # The native reader parses idx(.gz) off the GIL; numpy otherwise.
    from tensorflow_distributed_tpu_torch.native import runtime as native

    if native.available():
        try:
            return native.idx_read(path)
        except (IOError, KeyError):
            pass
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return parse_idx(f.read())


@dataclasses.dataclass
class Dataset:
    """One split: images float32 [N, H, W, C] in [0, 1] (MNIST's
    [N, 28, 28, 1]); labels int32 [N]."""

    images: np.ndarray
    labels: np.ndarray
    name: str = "mnist"

    def __post_init__(self):
        if self.images.shape[0] != self.labels.shape[0]:
            raise ValueError(f"{self.images.shape[0]} images but "
                             f"{self.labels.shape[0]} labels")

    def __len__(self) -> int:
        return self.images.shape[0]


def _to_splits(train_images, train_labels, test_images, test_labels,
               validation_size: int, name: str
               ) -> Tuple[Dataset, Dataset, Dataset]:
    """Split like the reference loader: the first ``validation_size``
    training rows become the validation split."""
    if validation_size >= len(train_images):
        raise ValueError(
            f"validation_size {validation_size} leaves no training "
            f"rows ({name} train split has {len(train_images)}); "
            "lower --validation-size")
    val = Dataset(train_images[:validation_size],
                  train_labels[:validation_size], name)
    train = Dataset(train_images[validation_size:],
                    train_labels[validation_size:], name)
    test = Dataset(test_images, test_labels, name)
    return train, val, test


def _prep_images(u8: np.ndarray) -> np.ndarray:
    return (u8.astype(np.float32) / 255.0)[..., None]


def load_mnist(data_dir: str, validation_size: int = 5000
               ) -> Tuple[Dataset, Dataset, Dataset]:
    """Load real MNIST idx files from ``data_dir`` (plain or .gz)."""
    arrays = {}
    for key, fname in _FILES.items():
        for cand in (os.path.join(data_dir, fname),
                     os.path.join(data_dir, fname + ".gz")):
            if os.path.exists(cand):
                arrays[key] = _read_idx_file(cand)
                break
        else:
            raise FileNotFoundError(
                f"MNIST file {fname}[.gz] not found in {data_dir}. "
                "This environment has no network egress; place idx files "
                "there or use dataset='synthetic'.")
    return _to_splits(
        _prep_images(arrays["train_images"]),
        arrays["train_labels"].astype(np.int32),
        _prep_images(arrays["test_images"]),
        arrays["test_labels"].astype(np.int32),
        validation_size, "mnist")


# --- synthetic digits (zero-egress fallback) -----------------------------
# 7x5 bitmap glyphs for 0-9, rendered with random placement, intensity
# and pixel noise into 28x28; learnable to >99% by the reference CNN.
_GLYPHS = [
    "01110 10001 10011 10101 11001 10001 01110",  # 0
    "00100 01100 00100 00100 00100 00100 01110",  # 1
    "01110 10001 00001 00010 00100 01000 11111",  # 2
    "11111 00010 00100 00010 00001 10001 01110",  # 3
    "00010 00110 01010 10010 11111 00010 00010",  # 4
    "11111 10000 11110 00001 00001 10001 01110",  # 5
    "00110 01000 10000 11110 10001 10001 01110",  # 6
    "11111 00001 00010 00100 01000 01000 01000",  # 7
    "01110 10001 10001 01110 10001 10001 01110",  # 8
    "01110 10001 10001 01111 00001 00010 01100",  # 9
]


def _glyph_array(d: int) -> np.ndarray:
    rows = _GLYPHS[d].split()
    return np.array([[int(c) for c in r] for r in rows], dtype=np.float32)


def synthetic_mnist(n_train: int = 12000, n_test: int = 2000,
                    validation_size: int = 1000, seed: int = 0
                    ) -> Tuple[Dataset, Dataset, Dataset]:
    """Deterministic MNIST-shaped synthetic digit dataset."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = np.zeros((n, 28, 28), dtype=np.float32)
    glyphs = [np.kron(_glyph_array(d), np.ones((3, 3), np.float32))
              for d in range(10)]  # 21x15
    for i in range(n):
        g = glyphs[labels[i]]
        inten = rng.uniform(0.75, 1.0)
        oy = rng.integers(0, 28 - g.shape[0] + 1)
        ox = rng.integers(0, 28 - g.shape[1] + 1)
        images[i, oy:oy + g.shape[0], ox:ox + g.shape[1]] = g * inten
    images += rng.normal(0.0, 0.05, size=images.shape).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)[..., None]
    return _to_splits(images[:n_train], labels[:n_train],
                      images[n_train:], labels[n_train:],
                      validation_size, "synthetic")


def load_dataset(dataset: str, data_dir: str, seed: int = 0,
                 validation_size: int = 5000
                 ) -> Tuple[Dataset, Dataset, Dataset]:
    """(train, validation, test) of ``dataset``, any vision family: the
    real sets ("mnist", "cifar10") from ``data_dir`` fall back to their
    synthetic twins with a warning when the files are absent (host data,
    not a device path)."""
    from tensorflow_distributed_tpu_torch.data import cifar

    if dataset == "synthetic":
        return synthetic_mnist(seed=seed)
    if dataset == "mnist":
        try:
            return load_mnist(data_dir, validation_size)
        except FileNotFoundError as e:
            print(f"[data] {e} — falling back to synthetic digits.")
            # Honor explicit small splits; cap at the synthetic twin's
            # own default (its train set is far smaller than MNIST's).
            return synthetic_mnist(seed=seed,
                                   validation_size=min(validation_size,
                                                       1000))
    if dataset == "cifar10":
        try:
            return cifar.load_cifar10(data_dir, validation_size)
        except FileNotFoundError as e:
            print(f"[data] {e} — falling back to synthetic cifar10.")
            return cifar.synthetic_cifar10(
                seed=seed, validation_size=min(validation_size, 1000))
    if dataset == "cifar10_synthetic":
        return cifar.synthetic_cifar10(seed=seed)
    if dataset == "imagenet_synthetic":
        return cifar.synthetic_imagenet(seed=seed)
    raise ValueError(f"unknown dataset {dataset!r}")


class ShardedBatcher(Batcher):
    """(images, labels) batches over a Dataset — the generic
    ``data/batcher.py`` Batcher with a vision gather. The trailing
    partial batch of each epoch is dropped."""

    def __init__(self, ds: Dataset, global_batch: int, seed: int = 0,
                 num_processes: int = 1, process_index: int = 0,
                 accum_steps: int = 1):
        self.ds = ds
        super().__init__(
            n_items=len(ds), global_batch=global_batch,
            gather=lambda idx: (ds.images[idx], ds.labels[idx]),
            seed=seed, num_processes=num_processes,
            process_index=process_index,
            accum_steps=accum_steps)
