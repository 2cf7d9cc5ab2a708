"""Single CLI entrypoint of the PyTorch port —
``python -m tensorflow_distributed_tpu_torch.cli``.

Examples:
    # GPT-2-small training on one GPU (the flash kernels build on first
    # use into build/torch_ext/):
    python -m tensorflow_distributed_tpu_torch.cli --mode train \
        --model gpt_lm --model-size small --seq-len 1024 --batch-size 8 \
        --train-steps 30 --eval-every 0 --eval-batch-size 8

    # the same run with the head and loss fused into the fused-CE
    # kernels (the [8192, 50257] logits are never written; --ce-impl scan
    # runs the chunk loop instead, --tie-embeddings true ties the head):
    python -m tensorflow_distributed_tpu_torch.cli --mode train \
        --model gpt_lm --model-size small --seq-len 1024 --batch-size 8 \
        --ce-chunk 8192 --ce-impl kernel

    # the same path on the CPU (plain versions of the kernels), tiny:
    python -m tensorflow_distributed_tpu_torch.cli --model gpt_lm \
        --model-size tiny --seq-len 64 --batch-size 8 --train-steps 5 \
        --eval-batch-size 8 --compute-dtype float32 --device cpu

    # sequence parallelism: ring attention over 4 processes, one GPU
    # each (NCCL; rank r on cuda:r), through the partial-attention
    # kernels; with --device cpu the same over gloo:
    torchrun --standalone --nproc-per-node 4 \
        -m tensorflow_distributed_tpu_torch.cli --mesh.seq 4 --model gpt_lm \
        --model-size small --seq-len 1024 --batch-size 8 --train-steps 30

Flags share the JAX CLI's spellings and defaults; flags the port does
not parse yet are rejected (ROADMAP.md queue A lists what is still to
come). The default model is the JAX package's ``mnist_cnn``, not ported
yet, so every call names ``--model gpt_lm``.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from tensorflow_distributed_tpu_torch.config import parse_args
from tensorflow_distributed_tpu_torch.parallel import mesh
from tensorflow_distributed_tpu_torch.train.loop import train


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg = parse_args(argv)
    try:
        train(cfg)
    finally:
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
