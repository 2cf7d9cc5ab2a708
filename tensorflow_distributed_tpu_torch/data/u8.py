"""uint8 image storage and natively gathered batches: the port of
``data/u8.py``.

Images stay uint8 on the host (a quarter of the f32 bytes) and each
batch is materialized by the native threaded gather
(``native/runtime.py``: ``tfd_gather_u8_f32``, u8 -> f32 off the GIL),
numpy where the library is unavailable. The batch order comes from the
shared ``data/batcher.py`` permutation, so the sample stream is the
float ``ShardedBatcher``'s; only the gather differs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tensorflow_distributed_tpu_torch.data.batcher import Batcher
from tensorflow_distributed_tpu_torch.data.mnist import Dataset


@dataclasses.dataclass
class U8Dataset:
    """images uint8 [N, ...]; labels int32 [N]; float = u8 * scale."""

    images: np.ndarray
    labels: np.ndarray
    scale: float = 1.0 / 255.0
    name: str = "u8"

    def __post_init__(self):
        if self.images.dtype != np.uint8:
            raise TypeError(f"U8Dataset holds uint8 images, got "
                            f"{self.images.dtype}")
        if self.images.shape[0] != self.labels.shape[0]:
            raise ValueError(f"{self.images.shape[0]} images but "
                             f"{self.labels.shape[0]} labels")

    def __len__(self) -> int:
        return self.images.shape[0]

    @classmethod
    def from_float(cls, ds: Dataset) -> "U8Dataset":
        """Quantize a float [0, 1] Dataset to u8 storage: lossless for
        data that was u8 on disk (MNIST, CIFAR-10), <= 0.5/255 rounding
        for synthetic floats."""
        u8 = np.clip(np.rint(ds.images * 255.0), 0, 255).astype(np.uint8)
        return cls(u8, np.ascontiguousarray(ds.labels, np.int32),
                   name=ds.name)

    def gather(self, idx: np.ndarray):
        from tensorflow_distributed_tpu_torch.native import runtime as native

        images = native.gather_u8_f32(self.images, idx, self.scale)
        return images, self.labels[idx]

    def gather_raw(self, idx: np.ndarray):
        """The uint8 batch, unconverted (for a device-side normalize)."""
        return self.images[idx], self.labels[idx]


class U8ShardedBatcher(Batcher):
    """The stream of ``data/mnist.py``'s ShardedBatcher, gathered
    natively."""

    def __init__(self, ds: U8Dataset, global_batch: int, seed: int = 0,
                 num_processes: int = 1, process_index: int = 0,
                 accum_steps: int = 1):
        self.ds = ds
        super().__init__(n_items=len(ds), global_batch=global_batch,
                         gather=ds.gather,
                         seed=seed, num_processes=num_processes,
                         process_index=process_index,
            accum_steps=accum_steps)
