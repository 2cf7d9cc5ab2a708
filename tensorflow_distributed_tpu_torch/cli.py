"""Single CLI entrypoint of the PyTorch port —
``python -m tensorflow_distributed_tpu_torch.cli``.

Examples:
    # the reference's job: the MNIST CNN on one GPU, from the idx files
    # under --data-dir (the synthetic digits, with a warning, when they
    # are missing; --dataset synthetic asks for them):
    python -m tensorflow_distributed_tpu_torch.cli --data-dir tests/fixtures/mnist \
        --validation-size 64 --batch-size 64 --train-steps 50 \
        --learning-rate 2e-3 --eval-every 25

    # sync data parallelism: D processes, one GPU each (NCCL; rank r on
    # cuda:r), each drawing its D-th of every global batch; with
    # --device cpu the same over gloo:
    torchrun --standalone --nproc-per-node 4 \
        -m tensorflow_distributed_tpu_torch.cli --mesh.data 4 \
        --dataset synthetic --train-steps 300

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

    # sequence parallelism: ring attention over 4 processes through the
    # partial-attention kernels; --mesh.data 2 --mesh.seq 2 makes two
    # data rows of two-process rings:
    torchrun --standalone --nproc-per-node 4 \
        -m tensorflow_distributed_tpu_torch.cli --mesh.seq 4 --model gpt_lm \
        --model-size small --seq-len 1024 --batch-size 8 --train-steps 30

    # continuous-batching inference (serve/): GPT-2-small at its
    # published widths, fresh-init weights from --seed, 32 requests of
    # 64-512 prompt tokens through 8 slots, 64 new tokens each; prints
    # the [serve] summary line and a JSON serve_summary record:
    python -m tensorflow_distributed_tpu_torch.cli --mode serve \
        --model gpt_lm --model-size small --synthetic-vocab 50257 \
        --seq-len 1024 --serve.num-slots 8 --serve.num-requests 32 \
        --serve.prompt-len-min 64 --serve.prompt-len-max 512 \
        --serve.max-new-tokens 64

    # checkpoints: a save every 200 steps (and at the end) into
    # --checkpoint-dir, the newest 3 kept, in the JAX package's format;
    # --resume true continues from the latest one:
    python -m tensorflow_distributed_tpu_torch.cli --mode train \
        --model gpt_lm --model-size small --seq-len 1024 --batch-size 8 \
        --train-steps 600 --checkpoint-dir /tmp/gpt2 --resume true

    # one validation pass of the latest checkpoint (its EMA if any):
    python -m tensorflow_distributed_tpu_torch.cli --mode eval \
        --model gpt_lm --model-size small --seq-len 1024 \
        --eval-batch-size 8 --checkpoint-dir /tmp/gpt2

    # continue a prompt of token ids from it, greedy, sampled
    # (--gen-temperature, --gen-top-k, --gen-top-p) or by beam search:
    python -m tensorflow_distributed_tpu_torch.cli --mode generate \
        --model gpt_lm --model-size small --seq-len 1024 \
        --compute-dtype float32 --checkpoint-dir /tmp/gpt2 \
        --prompt 464,3290,318 --max-new-tokens 32 --num-beams 4

    # serve its trained weights instead of fresh-init ones (the trained
    # --seq-len):
    python -m tensorflow_distributed_tpu_torch.cli --mode serve \
        --model gpt_lm --model-size small --seq-len 1024 \
        --checkpoint-dir /tmp/gpt2 --serve.num-slots 8

    # the same path on the CPU, tiny, streaming each token:
    python -m tensorflow_distributed_tpu_torch.cli --mode serve \
        --model gpt_lm --model-size tiny --compute-dtype float32 \
        --device cpu --serve.num-slots 2 --serve.num-requests 4 \
        --serve.max-new-tokens 8 --serve.stream true

Flags share the JAX CLI's spellings and defaults; flags the port does
not parse yet are rejected (ROADMAP.md queue A lists what is still to
come). After training, the chief prints the eval records as the
reference's ``performance`` table, as the JAX CLI does; ``--mode eval``
and ``--mode generate`` print an ``eval`` and a ``generate`` record;
``--mode serve`` prints the JAX CLI's ``[serve]`` summary line.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from tensorflow_distributed_tpu_torch.config import TrainConfig, parse_args
from tensorflow_distributed_tpu_torch.parallel import mesh
from tensorflow_distributed_tpu_torch.serve.run import serve_run
from tensorflow_distributed_tpu_torch.train.loop import (
    TrainResult, evaluate_only, generate_only, train)
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger


def train_and_report(cfg: TrainConfig,
                     logger: Optional[MetricLogger] = None) -> TrainResult:
    """Train ``cfg``; the chief then prints the reference's
    ``performance`` table of the eval records, when there are any. The
    caller ends the process group (``mesh.shutdown``)."""
    result = train(cfg, logger=logger)
    if mesh.is_chief():
        table = result.logger.performance_table(cfg.learning_rate)
        if table.count("\n"):
            print(table, flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg = parse_args(argv)
    if cfg.mode == "serve":
        serve_run(cfg)
        return 0
    if cfg.mode == "generate":
        generate_only(cfg)
        return 0
    try:
        if cfg.mode == "eval":
            evaluate_only(cfg)
        else:
            train_and_report(cfg)
    finally:
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
