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

    # tensor parallelism (Megatron): each of --mesh.model M processes
    # holds H/M heads and d_ff/M columns of every block (and, with
    # --shard-vocab, V/M rows of the embedding); --mesh.data 2
    # --mesh.model 2 makes two data rows of two-process TP groups:
    torchrun --standalone --nproc-per-node 4 \
        -m tensorflow_distributed_tpu_torch.cli --mesh.model 4 \
        --model gpt_lm --model-size small --seq-len 1024 --batch-size 8 \
        --ce-chunk 8192 --shard-vocab true

    # mixture of experts: moe_lm (or --moe-experts E on gpt_lm/bert_mlm),
    # top-2 routing at capacity 1.25; --mesh.expert 4 cuts the 8 experts
    # over 4 processes (without it, --mesh.model M cuts them beside TP):
    torchrun --standalone --nproc-per-node 4 \
        -m tensorflow_distributed_tpu_torch.cli --mesh.expert 4 \
        --model moe_lm --model-size small --moe-experts 8 --seq-len 1024 \
        --batch-size 8 --moe-dispatch scatter

    # ZeRO-1 and FSDP over the data axis (each rank holds 1/D of the
    # Adam slots, or with fsdp of the params and slots too), and the
    # bucketed reduce-scatter / all-gather sync (--grad-sync overlap,
    # which takes zero1's layout; --grad-sync serial is one all-reduce):
    torchrun --standalone --nproc-per-node 4 \
        -m tensorflow_distributed_tpu_torch.cli --mesh.data 4 \
        --model gpt_lm --model-size small --seq-len 1024 --batch-size 8 \
        --param-partition zero1 --grad-sync overlap

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

    # one replica over 4 GPUs (--serve.mesh-model: this process and 3
    # workers it starts, each holding H/4 heads and their slice of the
    # cache; --shard-vocab pads the vocabulary to a multiple of 4), and
    # --mode generate over --mesh.model M under torchrun:
    python -m tensorflow_distributed_tpu_torch.cli --mode serve \
        --model gpt_lm --model-size small --synthetic-vocab 50257 \
        --shard-vocab true --seq-len 1024 --serve.mesh-model 4
    torchrun --standalone --nproc-per-node 4 \
        -m tensorflow_distributed_tpu_torch.cli --mode generate \
        --mesh.model 4 --model gpt_lm --model-size small --seq-len 1024 \
        --checkpoint-dir /tmp/gpt2 --prompt 464,3290,318

    # restarted after a crash or a kill (train: --resume true from the
    # second leg; serve: the same command, its journal the resume):
    python -m tensorflow_distributed_tpu_torch.resilience.supervisor \
        --max-restarts 3 -- --mode serve --model gpt_lm \
        --serve.journal /tmp/serve.journal

    # the same path on the CPU, tiny, streaming each token:
    python -m tensorflow_distributed_tpu_torch.cli --mode serve \
        --model gpt_lm --model-size tiny --compute-dtype float32 \
        --device cpu --serve.num-slots 2 --serve.num-requests 4 \
        --serve.max-new-tokens 8 --serve.stream true

    # serving under fire: two poisoned slots (quarantined and re-prefilled
    # from their own tokens), a live weight swap from --checkpoint-dir, a
    # journal (run the same command again after a kill to resume) and
    # the decode watchdog; exit 2 when a request is quarantined past
    # --serve.slot-retries, 3 when a decode step outlasts the watchdog:
    python -m tensorflow_distributed_tpu_torch.cli --mode serve \
        --model gpt_lm --model-size small --seq-len 1024 \
        --checkpoint-dir /tmp/gpt2 --serve.journal /tmp/serve.journal \
        --resilience.sync-timeout-s 5 \
        --resilience.fault-plan slot_nan@5:2,slot_nan@9:0,reload@12

    # the BASELINE families: BERT-base masked LM (non-causal flash
    # kernels), ResNet-50 on ImageNet-shaped synthetic images, ResNet-20
    # on CIFAR-10 (the binary batches under --data-dir, else the
    # synthetic twin) with sync BN over D processes:
    python -m tensorflow_distributed_tpu_torch.cli --model bert_mlm \
        --seq-len 512 --synthetic-vocab 30522 --batch-size 16
    python -m tensorflow_distributed_tpu_torch.cli --model resnet50 \
        --dataset imagenet_synthetic --batch-size 64
    torchrun --standalone --nproc-per-node 4 \
        -m tensorflow_distributed_tpu_torch.cli --mesh.data 4 \
        --model resnet20 --dataset cifar10 --data-dir /data/cifar10

    # a byte-level GPT on a local text file (--text-tokenizer bpe trains
    # a BPE on it with the tokenizers package), then a text prompt;
    # --data-backend u8_native gathers vision batches from uint8 storage
    # with the native runtime (built with g++ into build/torch_native/):
    python -m tensorflow_distributed_tpu_torch.cli --model gpt_lm \
        --dataset text --data-dir corpus.txt --seq-len 1024 \
        --batch-size 8 --checkpoint-dir /tmp/text
    python -m tensorflow_distributed_tpu_torch.cli --mode generate \
        --model gpt_lm --dataset text --data-dir corpus.txt --seq-len 1024 \
        --checkpoint-dir /tmp/text --prompt "Once upon a time"

    # training under faults: a NaN batch at step 5 skipped (its update
    # discarded), a checkpoint write that fails twice and is retried,
    # watchdogs on the batch fetch and each step; a SIGTERM saves and
    # exits 0 (--resume goes on from the save):
    python -m tensorflow_distributed_tpu_torch.cli --mode train \
        --model mnist_cnn --dataset synthetic --batch-size 64 \
        --train-steps 300 --checkpoint-dir /tmp/cnn --checkpoint-every 2 \
        --resilience.nonfinite skip_batch --resilience.data-timeout-s 30 \
        --resilience.sync-timeout-s 30 \
        --resilience.fault-plan nan_grad@5,ckpt_io_fail@4:2

Flags share the JAX CLI's spellings and defaults; flags the port does
not parse yet are rejected (ROADMAP.md queue A lists what is still to
come). After training, the chief prints the eval records as the
reference's ``performance`` table, as the JAX CLI does; ``--mode eval``
and ``--mode generate`` print an ``eval`` and a ``generate`` record;
``--mode serve`` prints the JAX CLI's ``[serve]`` summary line. The exit
codes are the JAX CLI's: 2 when training diverges (a non-finite loss
under ``--resilience.nonfinite halt``, a spent skip or rewind budget,
``--halt-on-nonfinite``) or a request is slot-quarantined past its retry
budget (a restart would diverge the same way), 3 when a watchdog fires
(the next-batch fetch, a step's device sync, a decode step: a restart
and ``--resume`` or a journal resume are the remedy), else 0, a
preempted run (SIGTERM: the save at the stopping step) included.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from tensorflow_distributed_tpu_torch.config import TrainConfig, parse_args
from tensorflow_distributed_tpu_torch.parallel import mesh
from tensorflow_distributed_tpu_torch.resilience.watchdog import StallError
from tensorflow_distributed_tpu_torch.serve.run import serve_run
from tensorflow_distributed_tpu_torch.serve.scheduler import (
    SlotRetryExhausted)
from tensorflow_distributed_tpu_torch.train.loop import (
    TrainResult, evaluate_only, generate_only, train)
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

# The JAX CLI's exit codes: 2 = diverged (a FloatingPointError in
# training, a request slot-quarantined past its budget in serving), 3 =
# stalled (a watchdog).
EXIT_DIVERGED = 2
EXIT_STALLED = 3


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
        try:
            serve_run(cfg)
        except SlotRetryExhausted as e:
            print(f"[resilience] serve diverged: {e}", file=sys.stderr,
                  flush=True)
            return EXIT_DIVERGED
        except StallError as e:
            print(f"[resilience] serve stalled: {e}", file=sys.stderr,
                  flush=True)
            return EXIT_STALLED
        return 0
    try:
        if cfg.mode == "generate":
            generate_only(cfg)
        elif cfg.mode == "eval":
            evaluate_only(cfg)
        else:
            train_and_report(cfg)
    except FloatingPointError as e:
        print(f"[resilience] diverged: {e}", file=sys.stderr, flush=True)
        return EXIT_DIVERGED
    except StallError as e:
        print(f"[resilience] stalled: {e}", file=sys.stderr, flush=True)
        return EXIT_STALLED
    finally:
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
