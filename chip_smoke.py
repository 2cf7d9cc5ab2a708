#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device  — the card (nvidia-smi name and power limit), torch, CUDA,
             and whether nvcc and ninja are on the machine;
2. build   — compiles the flash-attention and fused-CE kernels from
             ``tensorflow_distributed_tpu_torch/ops/csrc`` (sm_90a), one
             nvcc per source, started together; lists the registers and
             spills of the Hopper kernels (B1's forward, B2's dQ, B3's
             dK/dV, B4's forward, B5's dx, B6's dW/db, and the partial
             instantiations of B1's, B2's and B3's kernels, B7, B8 and
             B9), fails if one spills, if ptxas ignored a setmaxnreg or
             serialized a kernel's wgmmas (warnings C7510-C7515), and
             counts their wgmma, TMA, mbarrier and mma.sync instructions
             in the machine code (cuobjdump); fails if a library holds
             an mma.sync (no WMMA is left);
3. kernels — each kernel (forward, dQ, dK/dV) against its plain PyTorch
             version computed in f32 from the same bf16 inputs, at
             B=8 H=12 L=1024 D=64 (causal, non-causal, causal + window
             256) and one D=128 case; median times over 20 launches
             (CUDA events) beside the bound, the plain version and
             ``scaled_dot_product_attention`` (forward, fwd+bwd, and
             its flash backward alone) as yardsticks, and the profiler's
             device time of B1, B2, B3 and SDPA's forward and flash
             backward;
4. ce_kernels — each fused-CE kernel (forward, dx, dW/db) against its
             plain PyTorch version computed in f32 from the same bf16
             inputs, at GPT-2-small's head (T 8192, D 768, V 50257; with
             bias at eps 0 and 0.1, and without bias), at D 1024 and on a
             ragged case; median times over 20 launches beside the bound,
             the plain version and the dense head + cross-entropy
             (forward, fwd+bwd) as yardsticks, and the kernels' device
             time (torch.profiler);
5. model   — a small GPT (head dim 64) on the card in bf16 through the
             kernels against the same weights on the CPU in f32: the
             dense head, then the fused head+loss through the CE kernels,
             untied and tied;
6. train   — GPT-2-small training through the port's CLI path
             (seq 1024, batch 8, 30 steps, final eval): finite, falling
             loss and every flash kernel launched by the run;
7. train_fused — the same run with ``--ce-chunk 8192 --ce-impl kernel``
             (final eval through the scan formulation): finite, falling
             loss, the first step's loss within 1e-2 of the dense run's,
             each CE kernel launched once per step;
8. step_profile — where a step goes, for train's and train_fused's
             flags and the Llama-style phases' (train_llama,
             train_window; phases 23-24): its host-
             clocked time with and without the per-step loss fetch, the
             host's time to enqueue a step, and, from torch.profiler, the
             device's busy time and idle share by kernel kind (flash,
             fused CE, GEMM, other) and the host ops with the most self
             CPU time;
9. ring_kernels — each partial-attention kernel of the ring (forward,
             dQ, dK/dV) against its plain PyTorch version computed in
             f32 from the same bf16 inputs, at GPT-2-small's half-block
             under a 4-way ring (B 8, H 12, 128 rows, D 64) and at the
             long-context shape (B 4, H 8, 512 rows: L 8192 over 8),
             causal and full, and one D=128 case; median times over 20
             launches beside the bound and the plain version (no library
             call computes the unnormalized partials or their
             gradients: library_ms is null), the kernels' device time
             alone (torch.profiler) at the 128- and 512-row cases, and
             SDPA's flash backward at the half-block, full and causal,
             as a work-equivalent yardstick for B8 + B9 (the same
             products on the same shapes, for the normalized function);
10. ring    — ``ring_attention`` over ``StackedRing(S)`` (the S ring
             positions stacked in one process on one card), forward and
             backward, at S=4 (B 8, H 12, L 1024, D 64) and S=8 (B 4,
             H 8, L 8192): each partial kernel launched 2S+1 times per
             call, outputs and grads against the flash kernels and the
             plain full attention in f32 (at S=8 on the last 512 query
             rows, forward), the forward and fwd+bwd times, and the
             device time of a fwd+bwd (all kernels, the partial ones);
11. train_ring — on a machine with two or more cards only: GPT-2-small
             trained by torchrun over S = 4 (or 2) processes with
             ``--mesh.seq S`` (NCCL), the first five losses within 1e-2
             of a one-card run of the same flags, every rank launching
             the partial kernels. On one card it prints a ``skipped``
             line;
12. model_cnn — the reference's MNIST CNN on the card in bf16 against
             the same weights on the CPU in f32, at batch 256: the logits
             and every grad (cuDNN and cuBLAS; no kernel of this
             repository is on the CNN's path);
13. train_cnn — the reference's job through the port's CLI path: the
             JAX package's default-tier accuracy bar on the committed
             MNIST fixture (the fixture must load as real MNIST; final
             val accuracy >= 0.95), then a timing run at the JAX
             defaults (synthetic digits, batch 256, dropout 0.25, 300
             steps: median step ms, images/s, peak memory) and its step
             profile (device busy and idle share, host enqueue time);
14. train_data — sync data parallelism: torchrun over N = min(cards, 4)
             processes, one card each (NCCL; on one card a torchrun of
             one process with an NCCL group of one): the CNN with
             ``--mesh.data N``, GPT-2-small (fused CE) with ``--mesh.data
             N`` at 8 rows a rank and, on four cards, with ``--mesh.data
             2 --mesh.seq 2``; the first five losses within 1e-2 of one
             card on the same global batch, every rank launching the
             flash (or, under seq, the partial) and fused-CE kernels,
             the performance table printed by rank 0 only.

15. decode — the decode-cache path at GPT-2-small's full width (12
             layers, d 768, 12 heads, vocab 50257, max_len 1024, seeded
             fresh-init weights, bf16): four prompts of 17, 100, 300 and
             511 tokens prefilled in one batch (each row padded to 511,
             as a bucket pads), then 16 greedy decode steps with every row
             at its own depth; at each step the last-position logits
             against the training forward over the same tokens without a
             cache (through B1), max |diff| / max |ref| <= 2e-2;
16. serve_identity — the slot engine under the FIFO scheduler in f32 at
             the same width: 12 requests of 8-480 prompt tokens through 4
             slots (reused), 32 new tokens each, every stream against the
             request's own one-shot greedy ``generate()``; a mismatch is
             excused only where the reference's top-2 logit gap is under
             1e-4 (f32 sums in another order at batch 4 and batch 1), and
             that request is compared no further; the prefill shapes used
             stay within the bucket ladder;
17. serve   — ``--mode serve`` through the port's CLI at GPT-2-small's
             width in bf16 (32 requests of 64-512 prompt tokens, 8 slots,
             64 new tokens each): exit 0, every token delivered, its
             summary (tokens/s, time to first token, per-token latency,
             occupancy, buckets, decode steps) and peak memory; then 10
             decode steps of a full engine traced by torch.profiler
             (launches a step, host enqueue, device busy, idle share),
             logits finite and tokens in the vocabulary;
18. checkpoint — GPT-2-small with the fused CE kernels (``--ce-chunk
             8192 --ce-impl kernel``, dropout 0.25): 6 steps straight,
             then 3 steps saving a checkpoint at step 3 and ``--resume``
             to step 6 in a new process (torchrun of one, the CLI's
             path): steps 4-6 within 1e-5 relative of the straight run
             (the largest difference printed), the resumed leg
             launching B1-B6; then an in-process save and restore of the
             straight run's state, every tensor, the step and the count
             equal, with the step directory's bytes and the save and
             restore seconds;
19. eval    — ``--mode eval`` through the CLI on that checkpoint (dense
             head, bf16, eval batch 8): its val_loss within 1e-5
             relative of an in-process ``evaluate()`` of the restored
             state, B1 launched 12 times an eval batch, the eval
             seconds and tokens/s;
20. generate — ``--mode generate`` through the CLI on that checkpoint in
             f32: greedy tokens equal to ``generate()`` on the restored
             model, ``--num-beams 4`` exiting 0 with tokens in the
             vocabulary and a finite beam score, and ``beam_search``
             with one beam equal to greedy (a mismatch excused only
             where the top-2 logit gap is under 1e-4);
21. serve_checkpoint — ``--mode serve --checkpoint-dir`` on that
             checkpoint in f32 (8 requests, 4 slots, 16 new tokens):
             the summary says ``"params": "checkpoint"``, and every
             stream equals ``generate()`` on the restored weights (the
             same excuse);
22. model_llama — the Llama-style GPT at GPT-2-small's widths (RoPE,
             4 K/V heads, SwiGLU at d_ff 3072, RMSNorm, tied: ~142M
             params), batch 2 x L 1024, from one seeded param tree: the
             bf16 forward and backward on the card through B1-B3 against
             the f32 plain path on the CPU, logits and every grad within
             5e-2 of max |ref|;
23. train_llama — train_fused's run (30 steps, ``--ce-chunk 8192
             --ce-impl kernel``) with the Llama-style flags: B2 and B3
             exactly 12 launches a step, B1 at least 12, each CE kernel
             one, no ring kernel; tokens/s, step ms and peak memory
             beside train_fused's;
24. train_window — ``--seq-len 4096 --attn-window 512 --pos-emb rope``
             at GPT-2-small's width, batch 2 (8192 tokens a step),
             ``--remat full --optimizer adafactor``, 20 steps: B2 and
             B3 12 launches a step, B1 at least 24 (the forward and the
             recompute), a falling loss; then 3 steps under ``--remat
             dots`` (B1 still 24 a step: the kernel is recomputed, as
             JAX recomputes its pallas_call under dots_saveable) and 3
             without remat (B1 12 a step), whose peak memory over the
             train steps must be higher than the remat run's, and the
             gap;
25. decode_llama — ``decode`` on the Llama-style model in bf16: the
             logits within 2e-2 of the training forward (B1), and the
             narrow cache ([B, max_len, 4, 64]) exactly 4/12 of the
             bytes of an MHA cache of the same shape;
26. serve_llama — ``serve_identity`` on the Llama-style model in f32:
             every stream equal to ``generate()`` (the same excuse).

It then prints the nvidia-smi line, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the port's package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 tensor-core rate, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# Tolerances of kernel vs plain version (plain computed in f32 from the
# same bf16 inputs; the kernel rounds P and dS to bf16 before products).
TOL_O = 2e-2        # max abs error of the bf16 output
TOL_LSE = 1e-3      # max abs error of the f32 logsumexp
TOL_GRAD = 2e-2     # max abs error / max |reference| of dQ, dK, dV
# Fused-CE kernels vs their plain versions (plain computed in f32 from
# the same bf16 inputs; the kernels round dlogits to bf16 before the dx
# and dW products, as the scan formulation does).
TOL_CE = 1e-3       # max abs error of ce and lse (f32)
TOP2_GAP = 1e-2     # `correct` must agree where the top-2 logit gap exceeds it
TOL_CE_GRAD = 2e-2  # max abs error / max |reference| of dx and dW
TOL_DB = 1e-3       # max abs error / max |reference| of db
TOL_FIRST_LOSS = 1e-2  # fused vs dense first-step loss (same seed/batches)
CE_MAIN = dict(T=8192, D=768, V=50257, bias=True, eps=0.0)
CE_CASES = [CE_MAIN, dict(CE_MAIN, eps=0.1), dict(CE_MAIN, bias=False),
            dict(T=2048, D=1024, V=50257, bias=True, eps=0.0),
            dict(T=1000, D=768, V=179, bias=True, eps=0.1)]
# Model check: bf16 kernels on the card vs f32 plain path on the CPU.
TOL_MODEL = 5e-2    # max abs error / max |reference|, logits and grads
MAIN = dict(B=8, H=12, L=1024, D=64)
CASES = [dict(MAIN, causal=True, window=0),
         dict(MAIN, causal=False, window=0),
         dict(MAIN, causal=True, window=256),
         dict(B=2, H=8, L=1024, D=128, causal=True, window=0)]
TRAIN_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size", "small",
              "--seq-len", "1024", "--batch-size", "8", "--train-steps", "30",
              "--eval-every", "0", "--eval-batch-size", "8",
              "--compute-dtype", "bfloat16", "--log-every", "1"]
TRAIN_FUSED_ARGV = TRAIN_ARGV + ["--ce-chunk", "8192", "--ce-impl", "kernel"]
CE_KERNELS = ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")
RING_KERNELS = ("flash_fwd_partial", "flash_dq_partial", "flash_dkv_partial")
PROFILE_STEPS = 10  # step_profile: timed and traced steps of each run
# Partial (ring-step) kernels vs their plain versions; the ring vs the
# flash kernels and the plain full attention (plain in f32 from the same
# bf16 inputs; the kernels round P and dO to bf16 for their products).
TOL_PARTIAL_O = 2e-2  # max abs error / max |reference| of the f32 o
TOL_STATS = 1e-3      # max abs error of the partial forward's m and l
TOL_RING = 2e-2       # ring out, dQ, dK, dV: max abs error / max |reference|
TOL_RING_LOSS = 1e-2  # train_ring vs one card, first five losses
TRAIN_RING_TIMEOUT_S = 600  # torchrun's S ranks, builds included
RING_KERNEL_CASES = [  # the first is the main case (timed, in the kernels line)
    dict(B=8, H=12, nh=128, D=64, causal=False),
    dict(B=8, H=12, nh=128, D=64, causal=True),
    dict(B=4, H=8, nh=512, D=64, causal=False),
    dict(B=4, H=8, nh=512, D=64, causal=True),
    dict(B=2, H=8, nh=256, D=128, causal=True)]
RING_CASES = [dict(S=4, B=8, H=12, L=1024, D=64),  # launches in the kernels line
              dict(S=8, B=4, H=8, L=8192, D=64)]
# The ring is held to the whole plain f32 version where its [B, H, L, L]
# scores fit in PLAIN_SCORE_BYTES, else (L 8192: 8.6 GB) on the last
# RING_PLAIN_ROWS query rows, forward.
PLAIN_SCORE_BYTES = 2 ** 31
RING_PLAIN_ROWS = 512
TRAIN_RING_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                   "small", "--seq-len", "1024", "--batch-size", "8",
                   "--train-steps", "5", "--eval-every", "0",
                   "--eval-batch-size", "8", "--dropout-rate", "0",
                   "--compute-dtype", "bfloat16", "--log-every", "1"]
# The reference's job: the JAX package's default-tier accuracy bar on the
# committed MNIST fixture (tests/test_loop_cli.py's flags, at the default
# bf16 compute), then a timing run at the JAX defaults (synthetic digits,
# batch 256, dropout 0.25).
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "mnist")
CNN_ACCURACY_BAR = 0.95
TRAIN_CNN_ARGV = ["--mode", "train", "--model", "mnist_cnn", "--dataset",
                  "mnist", "--data-dir", FIXTURE_DIR, "--validation-size",
                  "64", "--batch-size", "64", "--train-steps", "50",
                  "--learning-rate", "2e-3", "--eval-every", "0",
                  "--eval-batch-size", "64", "--log-every", "1"]
TRAIN_CNN_TIMING_ARGV = ["--mode", "train", "--model", "mnist_cnn",
                         "--dataset", "synthetic", "--batch-size", "256",
                         "--train-steps", "300", "--eval-every", "0",
                         "--log-every", "1"]
# train_data: torchrun over N = min(cards, 4) processes, 5 steps, eval at
# step 5 (the chief's performance table), dropout 0 for the loss check.
TRAIN_DATA_CNN_ARGV = ["--mode", "train", "--model", "mnist_cnn",
                       "--dataset", "synthetic", "--batch-size", "256",
                       "--train-steps", "5", "--eval-every", "5",
                       "--dropout-rate", "0", "--log-every", "1"]
TRAIN_DATA_TIMEOUT_S = 420  # one torchrun, builds and NCCL start included
TABLE_HEADER = "Steps,        Time,      Accuracy,  Learning rate"
# Serving at GPT-2-small's full width (fresh-init weights from a seed).
DEVICE = "cuda"
TOL_DECODE = 2e-2   # decode vs training forward: max |diff| / max |ref|, bf16
DECODE_PROMPTS = (17, 100, 300, 511)  # one batch, each row at its own depth
DECODE_STEPS = 16
IDENTITY_SLOTS, IDENTITY_REQUESTS, IDENTITY_NEW = 4, 12, 32
IDENTITY_PROMPTS = (8, 480)  # lengths spread evenly over this range
IDENTITY_GAP = 1e-4  # a stream may differ only where the top-2 gap is below
SERVE_REQUESTS, SERVE_NEW = 32, 64
SERVE_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "small",
              "--synthetic-vocab", "50257", "--seq-len", "1024",
              "--serve.num-slots", "8", "--serve.num-requests",
              str(SERVE_REQUESTS), "--serve.prompt-len-min", "64",
              "--serve.prompt-len-max", "512", "--serve.max-new-tokens",
              str(SERVE_NEW)]
# Checkpoints and the modes that read them, at GPT-2-small's full width.
CKPT_MODEL_ARGV = ["--model", "gpt_lm", "--model-size", "small",
                   "--seq-len", "1024"]
CHECKPOINT_ARGV = ["--mode", "train", *CKPT_MODEL_ARGV, "--batch-size", "8",
                   "--eval-every", "0", "--eval-batch-size", "8",
                   "--compute-dtype", "bfloat16", "--log-every", "1",
                   "--ce-chunk", "8192", "--ce-impl", "kernel",
                   "--dropout-rate", "0.25"]
CHECKPOINT_STEPS, CHECKPOINT_EVERY = 6, 3
CHECKPOINT_TIMEOUT_S = 420  # the resumed leg's torchrun, start-up included
TOL_RESUME = 1e-5   # resumed vs straight losses, relative
EVAL_ARGV = ["--mode", "eval", *CKPT_MODEL_ARGV, "--eval-batch-size", "8",
             "--compute-dtype", "bfloat16"]
TOL_EVAL = 1e-5     # CLI eval vs in-process evaluate(), relative
GENERATE_PROMPT_LEN, GENERATE_NEW, GENERATE_BEAMS = 64, 32, 4
GENERATE_ARGV = ["--mode", "generate", *CKPT_MODEL_ARGV, "--compute-dtype",
                 "float32", "--max-new-tokens", str(GENERATE_NEW)]
SERVE_CKPT_ARGV = ["--mode", "serve", *CKPT_MODEL_ARGV, "--synthetic-vocab",
                   "50257", "--compute-dtype", "float32",
                   "--serve.num-slots", "4", "--serve.num-requests", "8",
                   "--serve.prompt-len-min", "16", "--serve.prompt-len-max",
                   "256", "--serve.max-new-tokens", "16", "--serve.stream",
                   "true"]
# The Llama-style GPT at GPT-2-small's published widths (12 layers x 768 x
# 12 heads of 64, vocab 50257, d_ff 3072) with RoPE, grouped-query
# attention over 4 K/V heads (the JAX package's genbench --n-kv-heads 4),
# a SwiGLU MLP, RMSNorm and tied embeddings: ~142M params.
LLAMA_OPTS = dict(pos_emb="rope", n_kv_heads=4, mlp_variant="swiglu",
                  norm="rmsnorm", tie_embeddings=True)
LLAMA_FLAGS = ["--pos-emb", "rope", "--n-kv-heads", "4", "--mlp-variant",
               "swiglu", "--norm", "rmsnorm", "--tie-embeddings", "true"]
MODEL_LLAMA_B, MODEL_LLAMA_L = 2, 1024
TRAIN_LLAMA_ARGV = TRAIN_ARGV + LLAMA_FLAGS + ["--ce-chunk", "8192",
                                               "--ce-impl", "kernel"]
# Mistral-style long context (the README's --seq-len 4096 --attn-window
# 512 --pos-emb rope) at GPT-2-small's width, 8192 tokens a step as in
# train, recomputing every block, with Adafactor; then short legs under
# --remat dots and without remat.
TRAIN_WINDOW_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                     "small", "--seq-len", "4096", "--batch-size", "2",
                     "--train-steps", "20", "--eval-every", "0",
                     "--eval-batch-size", "2", "--compute-dtype", "bfloat16",
                     "--log-every", "1", "--attn-window", "512",
                     "--pos-emb", "rope", "--remat", "full", "--optimizer",
                     "adafactor"]
WINDOW_CONTROL_STEPS = 3
CSRC = "tensorflow_distributed_tpu_torch/ops/csrc"
SOURCES = {"flash_attention": f"{CSRC}/flash_attention.cu",
           "fused_ce": f"{CSRC}/fused_ce.cu"}
# The kernels built from ops/csrc/hopper.cuh (wgmma, TMA, mbarriers,
# setmaxnreg), each with the library (SOURCES key) that holds it: B1's
# forward, B2's dQ, B3's dK/dV, B4's forward, B5's dx and B6's dW/db,
# and "<partial>", the instantiations of B1's, B2's and B3's kernels
# with the template flag PARTIAL = true: B7's forward, B8's dQ and B9's
# dK/dV.
HOPPER_KERNELS = {"flash_fwd_hopper": "flash_attention",
                  "flash_fwd_hopper<partial>": "flash_attention",
                  "flash_dq_hopper": "flash_attention",
                  "flash_dkv_hopper": "flash_attention",
                  "flash_dq_hopper<partial>": "flash_attention",
                  "flash_dkv_hopper<partial>": "flash_attention",
                  "fused_ce_fwd_hopper": "fused_ce",
                  "fused_ce_dx_hopper": "fused_ce",
                  "fused_ce_dw_hopper": "fused_ce"}
PARTIAL_FLAG = "Lb1E"  # the template argument `bool PARTIAL = true`, mangled
# Machine-code instructions counted per kernel (cuobjdump -sass).
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "HMMA")
# ptxas's warnings that it serialized a kernel's wgmmas (C7510-C7515).
WGMMA_SERIALIZED = re.compile(r"\bC751[0-5]\b")
TPU_FLASH = "tensorflow_distributed_tpu/ops/flash_attention.py"
TPU_CE = "tensorflow_distributed_tpu/ops/fused_ce_kernel.py"
REPLACES = {"flash_fwd": f"{TPU_FLASH}:183", "flash_dq": f"{TPU_FLASH}:255",
            "flash_dkv": f"{TPU_FLASH}:284", "fused_ce_fwd": f"{TPU_CE}:84",
            "fused_ce_dx": f"{TPU_CE}:147", "fused_ce_dw": f"{TPU_CE}:172",
            "flash_fwd_partial": f"{TPU_FLASH}:395",
            "flash_dq_partial": f"{TPU_FLASH}:451",
            "flash_dkv_partial": f"{TPU_FLASH}:479"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_ms(torch, fn, iters: int = 10):
    """Device time per call of ``fn`` by kernel name, {name: ms}, from
    torch.profiler's CUDA activity over ``iters`` calls after one warm-up
    call: the kernels' own time, without the host gaps between launches
    that CUDA events around a call also count. Empty when the profiler
    reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = us / iters / 1e3
    return out


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(fa, torch, B, H, L, D, causal, window):
    """(bound_ms, bound_by) of each kernel: each input read once, each
    output written once, against the tensor-core work of the (query,
    key) pairs inside the band."""
    BH, Lk = B * H, L
    rows = torch.arange(L)[:, None]
    cols = torch.arange(Lk)[None, :]
    pairs = (int(fa.window_keep(rows, cols, window).sum()) if causal
             else L * Lk)
    qbytes, kbytes, lse_bytes = BH * L * D * 2, BH * Lk * D * 2, BH * L * 4
    return {
        # S = QK^T, O = PV
        "flash_fwd": bound(2 * qbytes + 2 * kbytes + lse_bytes,
                           4 * BH * pairs * D),
        # S, dP = dO V^T, dQ = dS K
        "flash_dq": bound(4 * qbytes + 2 * kbytes + lse_bytes,
                          6 * BH * pairs * D),
        # S, dP, dV = P^T dO, dK = dS^T Q
        "flash_dkv": bound(3 * qbytes + 4 * kbytes + lse_bytes,
                           8 * BH * pairs * D),
    }


def sdpa_flash_bwd(torch, q4, k4, v4, do4, causal=True):
    """The one library call that computes dQ, dK and dV together from
    (q, k, v, out, lse, dO), as a call without arguments: the backward
    of PyTorch's flash SDPA, on [B, H, L, D] inputs, with its own
    forward's outputs."""
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    bwd = aten._scaled_dot_product_flash_attention_backward
    return lambda: bwd(do4, q4, k4, v4, out, lse, cum_q, cum_k, max_q, max_k,
                       0.0, causal, seed, offset)


def phase_device(torch) -> str:
    gpu = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": gpu,
          "cuda_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "ninja": shutil.which("ninja") is not None,
          "nvcc": shutil.which("nvcc")})
    return gpu


def ptxas_by_kernel(log: str):
    """{mangled kernel name: its ptxas register and spill lines} from
    nvcc's ``-Xptxas -v`` output."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            out[cur] = []
        elif cur is not None and ("registers" in ln or "spill" in ln):
            out[cur].append(ln.strip())
    return out


def hopper_instance(fn: str):
    """The HOPPER_KERNELS key of a mangled kernel name: the "<partial>"
    key where the name carries the template flag PARTIAL = true. None
    for a kernel that is not on the Hopper header."""
    for key in HOPPER_KERNELS:
        base, _, form = key.partition("<")
        if base in fn and (PARTIAL_FLAG in fn) == bool(form):
            return key
    return None


def spills(lines) -> bool:
    """Whether ptxas's lines for one kernel report a spill store or load
    of more than 0 bytes."""
    return any(re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)
               for ln in lines)


def phase_build(fa, fce) -> None:
    """Both libraries, one nvcc each, started together. The Hopper
    kernels' registers and spills are listed by instantiation, and the
    run fails if one spills, if ptxas ignored a setmaxnreg (the warp roles
    must split in one if/else for it to hold) or if it serialized the
    wgmmas of a kernel."""
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=2) as pool:
        logs = dict(zip(("flash_attention", "fused_ce"),
                        pool.map(lambda mod: mod.build(), (fa, fce))))
    hopper = {}
    for name, log in logs.items():
        for fn, lines in ptxas_by_kernel(log).items():
            short = hopper_instance(fn)
            if short is not None:
                hopper[f"{short}{'<128>' if 'ILi128E' in fn else ''}"] = lines
    cached = [name for name, log in logs.items() if not log]
    from tensorflow_distributed_tpu_torch.ops import cuda_ext

    by_lib = {name: sass_counts(cuda_ext.load(name)._name)
              for name in SOURCES}
    sass = {k: None if by_lib[name] is None
            else by_lib[name].get(k, dict.fromkeys(SASS_OPS, 0))
            for k, name in HOPPER_KERNELS.items()}
    library_hmma = {name: None if c is None
                    else sum(n["HMMA"] for n in c.values())
                    for name, c in by_lib.items()}
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "cached": cached, "hopper_ptxas": hopper, "hopper_sass": sass,
          "library_hmma": library_hmma,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in logs.items()}})
    for name, log in logs.items():
        check("setmaxnreg" not in log or "ignored" not in log,
              f"ptxas ignored setmaxnreg in {name}: {log}")
        check(not WGMMA_SERIALIZED.search(log),
              f"ptxas serialized wgmmas in {name}: {log}")
    for k, lines in hopper.items():
        check(not spills(lines), f"{k} spills: {lines}")
    check(cached or set(HOPPER_KERNELS) <= {k.replace("<128>", "")
                                             for k in hopper},
          f"the build did not compile every Hopper kernel: {sorted(hopper)}")
    for k, counts in sass.items():
        check(counts is None or (counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
                                 and counts["SYNCS"] > 0
                                 and counts["HMMA"] == 0),
              f"{k} is not a wgmma/TMA/mbarrier kernel: {counts}")
    check(all(n in (None, 0) for n in library_hmma.values()),
          f"a library still holds mma.sync (WMMA) code: {library_hmma}")


def sass_counts(lib: str):
    """Counts of the Hopper instructions in the machine code of the
    library ``lib`` (cuobjdump -sass), {HOPPER_KERNELS key: counts, both
    head dims together}, the library's other functions under None:
    HGMMA (wgmma), UTMALDG (TMA tensor load), SYNCS (mbarrier
    arrive/wait) and HMMA (the mma.sync that WMMA compiles to, which no
    kernel may use). None without cuobjdump."""
    from tensorflow_distributed_tpu_torch.ops import cuda_ext

    tool = os.path.join(os.path.dirname(cuda_ext.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120).stdout
    by_kernel = {}
    for part in out.split("Function : ")[1:]:
        counts = by_kernel.setdefault(
            hopper_instance(part.split("\n", 1)[0]),
            dict.fromkeys(SASS_OPS, 0))
        for ln in part.splitlines():
            words = ln.split("*/", 1)[-1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if not words:
                continue
            op = words[0]
            for key in counts:
                if op.startswith(key + ".") or op == key:
                    counts[key] += 1
    return by_kernel


def phase_kernels(fa, torch, F):
    """Correctness of every case; times at the main (training) case."""
    results = {}
    for i, case in enumerate(CASES):
        B, H, L, D = case["B"], case["H"], case["L"], case["D"]
        causal, window = case["causal"], case["window"]
        gen = torch.Generator(device="cuda").manual_seed(i)
        q, k, v, do = (torch.randn((B * H, L, D), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal, window)
        dq = fa.flash_dq(q, k, v, out, lse, do, causal, window)
        dk, dv = fa.flash_dkv(q, k, v, out, lse, do, causal, window)
        torch.cuda.synchronize()
        f = [t.float() for t in (q, k, v, out, do)]
        ref_o, ref_lse = fa.flash_attention_reference(f[0], f[1], f[2],
                                                      causal, window)
        ref_dq = fa.flash_dq_reference(f[0], f[1], f[2], f[3], lse, f[4],
                                       causal, window)
        ref_dk, ref_dv = fa.flash_dkv_reference(f[0], f[1], f[2], f[3], lse,
                                                f[4], causal, window)

        def abs_err(a, b):
            return float((a.float() - b).abs().max())

        def rel_err(a, b):
            return abs_err(a, b) / float(b.abs().max())

        row = {"phase": "kernels", **case,
               "o_abs_err": abs_err(out, ref_o),
               "lse_abs_err": abs_err(lse, ref_lse),
               "dq_rel_err": rel_err(dq, ref_dq),
               "dk_rel_err": rel_err(dk, ref_dk),
               "dv_rel_err": rel_err(dv, ref_dv),
               "dq_abs_err": abs_err(dq, ref_dq),
               "dkv_abs_err": max(abs_err(dk, ref_dk), abs_err(dv, ref_dv))}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (out, lse, dq, dk, dv))
        emit(row)
        check(finite, f"non-finite kernel output in case {case}")
        check(row["o_abs_err"] <= TOL_O, f"flash_fwd out error {row}")
        check(row["lse_abs_err"] <= TOL_LSE, f"flash_fwd lse error {row}")
        for g in ("dq", "dk", "dv"):
            check(row[f"{g}_rel_err"] <= TOL_GRAD, f"{g} error {row}")
        if i == 0:
            results["errors"] = row
            results["bounds"] = kernel_bounds(fa, torch, B, H, L, D, causal,
                                              window)
            results["ms"] = {
                "flash_fwd": time_ms(torch, lambda: fa.flash_fwd(
                    q, k, v, causal, window)),
                "flash_dq": time_ms(torch, lambda: fa.flash_dq(
                    q, k, v, out, lse, do, causal, window)),
                "flash_dkv": time_ms(torch, lambda: fa.flash_dkv(
                    q, k, v, out, lse, do, causal, window)),
            }
            results["plain_ms"] = {
                "flash_fwd": time_ms(
                    torch, lambda: fa.flash_attention_reference(
                        q, k, v, causal, window)),
                "flash_dq": time_ms(torch, lambda: fa.flash_dq_reference(
                    q, k, v, out, lse, do, causal, window)),
                "flash_dkv": time_ms(torch, lambda: fa.flash_dkv_reference(
                    q, k, v, out, lse, do, causal, window)),
            }
            q4, k4, v4, do4 = (t.view(B, H, L, D) for t in (q, k, v, do))
            sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True))
            qr, kr, vr = (t.detach().clone().requires_grad_()
                          for t in (q4, k4, v4))

            def sdpa_fwd_bwd():
                o4 = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
                torch.autograd.grad(o4, (qr, kr, vr), do4)

            # No library call computes dQ alone or dK/dV alone (null in
            # the kernels line); the flash backward computes all three.
            results["library_ms"] = {"flash_fwd": sdpa_fwd, "flash_dq": None,
                                     "flash_dkv": None}
            # Device time alone (torch.profiler): a short kernel's event
            # time also holds the host side of its call.
            sdpa_bwd = sdpa_flash_bwd(torch, q4, k4, v4, do4)
            fwd_device = {
                "flash_fwd": sum(device_ms(torch, lambda: fa.flash_fwd(
                    q, k, v, causal, window), 20).values()) or None,
                "sdpa_fwd": sum(device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True), 20).values()) or None}
            bwd_device = {
                "flash_dq": sum(device_ms(torch, lambda: fa.flash_dq(
                    q, k, v, out, lse, do, causal, window), 20).values())
                or None,
                "flash_dkv": sum(device_ms(torch, lambda: fa.flash_dkv(
                    q, k, v, out, lse, do, causal, window), 20).values())
                or None,
                "sdpa_flash_bwd": sum(device_ms(torch, sdpa_bwd,
                                                20).values()) or None}
            emit({"phase": "timing", **case, "ms": results["ms"],
                  "plain_ms": results["plain_ms"],
                  "fwd_device_ms": fwd_device,
                  "bwd_device_ms": bwd_device,
                  "sdpa_fwd_ms": sdpa_fwd,
                  "sdpa_fwd_bwd_ms": time_ms(torch, sdpa_fwd_bwd),
                  "sdpa_flash_bwd_ms": time_ms(torch, sdpa_bwd),
                  "flash_dq_plus_dkv_ms": (results["ms"]["flash_dq"]
                                           + results["ms"]["flash_dkv"]),
                  "flash_fwd_bwd_ms": sum(results["ms"].values()),
                  "bound_ms": {k: b[0] for k, b in results["bounds"].items()}})
        del q, k, v, do, out, lse, dq, dk, dv, f, ref_o, ref_lse, ref_dq
        del ref_dk, ref_dv
        torch.cuda.empty_cache()
    return results


def ce_bounds(T, D, V, bias):
    """(bound_ms, bound_by) of each fused-CE kernel: each input read
    once and each output written once, against the tensor-core work the
    function needs (the logits product, plus the dx or dW product)."""
    x, w, rows = T * D * 2, V * D * 2, T * 4
    b = V * 4 if bias else 0
    inputs = x + w + b + rows  # + targets
    return {
        "fused_ce_fwd": bound(inputs + 3 * rows, 2 * T * D * V),
        "fused_ce_dx": bound(inputs + 2 * rows + x, 4 * T * D * V),
        "fused_ce_dw": bound(inputs + 2 * rows + V * D * 4 + b,
                             4 * T * D * V),
    }


def phase_ce_kernels(fce, torch, F):
    """Correctness of every case; times at the main (training) case."""
    results = {}
    for i, case in enumerate(CE_CASES):
        T, D, V, eps = case["T"], case["D"], case["V"], case["eps"]
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.randn((T, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (0.05 * torch.randn((V, D), generator=gen, device="cuda")).to(
            torch.bfloat16)
        b = (0.1 * torch.randn(V, generator=gen, device="cuda")
             if case["bias"] else None)
        t = torch.randint(0, V, (T,), generator=gen, device="cuda",
                          dtype=torch.int32)
        coef = torch.rand(T, generator=gen, device="cuda")
        ce, correct, lse = fce.fused_ce_fwd(x, w, b, t, V, eps)
        dx = fce.fused_ce_dx(x, w, b, t, lse, coef, V, eps)
        dw, db = fce.fused_ce_dw(x, w, b, t, lse, coef, V, eps)
        torch.cuda.synchronize()
        ref_ce, ref_correct, ref_lse = fce.fused_ce_fwd_reference(
            x, w, b, t, V, eps)
        ref_dx = fce.fused_ce_dx_reference(x, w, b, t, lse, coef, V, eps)
        ref_dw, ref_db = fce.fused_ce_dw_reference(x, w, b, t, lse, coef,
                                                   V, eps)
        logits = x.float() @ w.float().T + (0.0 if b is None else b)
        top2 = logits.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > TOP2_GAP
        del logits, top2

        def abs_err(a, ref):
            return float((a.float() - ref.float()).abs().max())

        def rel_err(a, ref):
            return abs_err(a, ref) / float(ref.float().abs().max())

        row = {"phase": "ce_kernels", **case,
               "ce_abs_err": abs_err(ce, ref_ce),
               "lse_abs_err": abs_err(lse, ref_lse),
               "correct_mismatches": int((correct != ref_correct)[
                   decided].sum()),
               "correct_undecided": int((~decided).sum()),
               "dx_rel_err": rel_err(dx, ref_dx),
               "dw_rel_err": rel_err(dw, ref_dw),
               "db_rel_err": None if b is None else rel_err(db, ref_db),
               "dx_abs_err": abs_err(dx, ref_dx),
               "dw_abs_err": max([abs_err(dw, ref_dw)] + (
                   [] if b is None else [abs_err(db, ref_db)]))}
        finite = all(bool(torch.isfinite(v).all())
                     for v in (ce, lse, dx, dw) + (() if b is None else (db,)))
        emit(row)
        check(finite, f"non-finite fused-CE kernel output in case {case}")
        check(row["ce_abs_err"] <= TOL_CE and row["lse_abs_err"] <= TOL_CE,
              f"fused_ce_fwd ce/lse error {row}")
        check(row["correct_mismatches"] == 0, f"fused_ce_fwd argmax {row}")
        check(row["dx_rel_err"] <= TOL_CE_GRAD, f"fused_ce_dx error {row}")
        check(row["dw_rel_err"] <= TOL_CE_GRAD, f"fused_ce_dw error {row}")
        check((db is None) == (b is None), f"db without bias {row}")
        check(b is None or row["db_rel_err"] <= TOL_DB,
              f"fused_ce_dw db error {row}")
        if i == 0:
            results["errors"] = row
            results["bounds"] = ce_bounds(T, D, V, case["bias"])
            results["ms"] = {
                "fused_ce_fwd": time_ms(torch, lambda: fce.fused_ce_fwd(
                    x, w, b, t, V, eps)),
                "fused_ce_dx": time_ms(torch, lambda: fce.fused_ce_dx(
                    x, w, b, t, lse, coef, V, eps)),
                "fused_ce_dw": time_ms(torch, lambda: fce.fused_ce_dw(
                    x, w, b, t, lse, coef, V, eps)),
            }
            results["plain_ms"] = {
                "fused_ce_fwd": time_ms(torch, lambda: (
                    fce.fused_ce_fwd_reference(x, w, b, t, V, eps))),
                "fused_ce_dx": time_ms(torch, lambda: (
                    fce.fused_ce_dx_reference(x, w, b, t, lse, coef, V,
                                              eps))),
                "fused_ce_dw": time_ms(torch, lambda: (
                    fce.fused_ce_dw_reference(x, w, b, t, lse, coef, V,
                                              eps))),
            }
            # No single library call computes any of the three functions
            # (null in the kernels line); the dense head + cross-entropy
            # is the yardstick for the three together.
            results["library_ms"] = dict.fromkeys(results["ms"])
            tl, bb = t.long(), b.to(torch.bfloat16)
            dense_fwd = time_ms(torch, lambda: F.cross_entropy(
                F.linear(x, w, bb).float(), tl, reduction="none"))
            xr, wr, br = (v.detach().clone().requires_grad_()
                          for v in (x, w, bb))

            def dense_fwd_bwd():
                loss = F.cross_entropy(F.linear(xr, wr, br).float(), tl,
                                       reduction="none")
                torch.autograd.grad(loss, (xr, wr, br), coef)

            calls = {"fused_ce_fwd": lambda: fce.fused_ce_fwd(
                         x, w, b, t, V, eps),
                     "fused_ce_dx": lambda: fce.fused_ce_dx(
                         x, w, b, t, lse, coef, V, eps),
                     "fused_ce_dw": lambda: fce.fused_ce_dw(
                         x, w, b, t, lse, coef, V, eps)}
            emit({"phase": "ce_timing", **case, "ms": results["ms"],
                  "plain_ms": results["plain_ms"],
                  "device_ms": {name: sum(device_ms(torch, fn).values())
                                or None for name, fn in calls.items()},
                  "dense_fwd_ms": dense_fwd,
                  "dense_fwd_bwd_ms": time_ms(torch, dense_fwd_bwd),
                  "fused_fwd_bwd_ms": sum(results["ms"].values()),
                  "bound_ms": {k: v[0] for k, v in results["bounds"].items()}})
            del xr, wr, br
        del x, w, b, t, coef, ce, correct, lse, dx, dw, db
        del ref_ce, ref_correct, ref_lse, ref_dx, ref_dw, ref_db
        torch.cuda.empty_cache()
    return results


def phase_model(fa, torch, np) -> None:
    """A small GPT through the kernels (bf16, card) against the same
    weights through the plain path (f32, CPU): logits and every grad."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm
    from tensorflow_distributed_tpu_torch.ops.losses import (
        masked_softmax_cross_entropy)

    shape = dict(d_model=128, n_heads=2, d_ff=256, max_len=128)
    ref_model = gpt_lm("tiny", compute_dtype=torch.float32, **shape)
    ref_model.init_weights(torch.Generator().manual_seed(0))
    model = gpt_lm("tiny", compute_dtype=torch.bfloat16, **shape).cuda()
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 64, size=(4, 128)))
    targets = torch.from_numpy(rng.integers(0, 64, size=(4, 128)))
    mask = torch.ones((4, 128))
    before = [kern.launches for kern in fa.KERNELS]

    def run(m, dev):
        logits = m(tokens.to(dev))
        loss = masked_softmax_cross_entropy(logits, targets.to(dev),
                                            mask.to(dev))
        loss.backward()
        return logits.detach().cpu(), {n: p.grad.cpu()
                                       for n, p in m.named_parameters()}

    ref_logits, ref_grads = run(ref_model, "cpu")
    logits, grads = run(model, "cuda")
    torch.cuda.synchronize()
    launched = [kern.launches - b for kern, b in zip(fa.KERNELS, before)]
    logit_err = float((logits - ref_logits).abs().max()
                      / ref_logits.abs().max())
    grad_err = max(float((grads[n] - g).abs().max() / g.abs().max())
                   for n, g in ref_grads.items() if float(g.abs().max()) > 0)
    emit({"phase": "model", "logits_rel_err": logit_err,
          "grads_rel_err": grad_err, "kernel_launches": launched,
          "tolerance": TOL_MODEL})
    check(all(n == 2 for n in launched),
          f"model check did not run every kernel once per layer: {launched}")
    check(logit_err <= TOL_MODEL and grad_err <= TOL_MODEL,
          f"model on the card disagrees with the plain path: "
          f"logits {logit_err}, grads {grad_err}")


def phase_model_fused(fce, torch, np) -> None:
    """The same small GPT through ``features_only`` and the CE kernels
    (bf16, card) against the plain versions (f32, CPU), untied and tied:
    the loss and every grad; each CE kernel launches once per call."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    shape = dict(d_model=128, n_heads=2, d_ff=256, max_len=128)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, 64, size=(4, 128)))
    targets = torch.from_numpy(rng.integers(0, 64, size=(4, 128)))
    mask = torch.from_numpy((rng.random((4, 128)) < 0.8).astype(np.float32))
    for tie in (False, True):
        ref_model = gpt_lm("tiny", compute_dtype=torch.float32,
                           tie_embeddings=tie, **shape)
        ref_model.init_weights(torch.Generator().manual_seed(0))
        model = gpt_lm("tiny", compute_dtype=torch.bfloat16,
                       tie_embeddings=tie, **shape).cuda()
        model.load_state_dict(ref_model.state_dict())

        def run(m, dev):
            feats, w, bias = m(tokens.to(dev), features_only=True)
            ce, _, n = fce.fused_ce_sums_kernel(
                feats, w, bias, targets.to(dev), mask.to(dev), w.shape[0])
            loss = ce / n
            loss.backward()
            return float(loss.detach()), {k: p.grad.cpu()
                                 for k, p in m.named_parameters()}

        ref_loss, ref_grads = run(ref_model, "cpu")
        fce.reset_launch_counts()
        loss, grads = run(model, "cuda")
        torch.cuda.synchronize()
        launched = {kern.name: kern.launches for kern in fce.KERNELS}
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        grad_err = max(float((grads[k] - g).abs().max() / g.abs().max())
                       for k, g in ref_grads.items()
                       if float(g.abs().max()) > 0)
        emit({"phase": "model_fused", "tie_embeddings": tie,
              "loss_rel_err": loss_err, "grads_rel_err": grad_err,
              "kernel_launches": launched, "tolerance": TOL_MODEL})
        check(all(n == 1 for n in launched.values()),
              f"fused model check did not launch each CE kernel once: "
              f"{launched}")
        check(loss_err <= TOL_MODEL and grad_err <= TOL_MODEL,
              f"fused model on the card disagrees with the plain path: "
              f"loss {loss_err}, grads {grad_err}")


def run_train(kernels, torch, phase, argv, beside=None):
    """One training run through the port's CLI path, every launch count
    set to 0 just before it and read just after. Checks what every run
    must show (finite, falling loss; a final eval) and returns its
    record: ``launches`` (the whole run, final eval included),
    ``train_launches`` and ``train_peak_mem_bytes`` (read at the last
    step's record, before the final eval) and the loss trajectory.
    ``beside`` ({name: record}) puts another run's numbers beside
    these."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    class StepReads(MetricLogger):
        """Reads the launch counts and the peak memory at each step's
        record: after the step is enqueued, before the final eval."""

        def log(self, step, **metrics):
            super().log(step, **metrics)
            if "loss" in metrics:
                self.at_step = ({kern.name: kern.launches for kern in kernels},
                                torch.cuda.max_memory_allocated())

    cfg = parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    logger = StepReads(stream=sys.stderr)
    t0 = time.time()
    result = train(cfg, logger=logger)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    records = [r for r in result.logger.records if "loss" in r.metrics]
    losses = [r.metrics["loss"] for r in records]
    times = [r.wall_time for r in records]
    step_s = [b - a for a, b in zip(times, times[1:])]
    step_ms = statistics.median(step_s[4:] or step_s) * 1e3  # steps 6..
    train_launches, train_peak = logger.at_step
    rec = {"phase": phase, "argv": argv, "steps": len(losses),
           "first_loss": losses[0],
           "last5_mean_loss": statistics.mean(losses[-5:]),
           "step_ms_median": step_ms,
           **({"tokens_per_s": cfg.batch_size * cfg.seq_len / step_ms * 1e3}
              if cfg.seq_len else
              {"images_per_s": cfg.batch_size / step_ms * 1e3}),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "train_peak_mem_bytes": train_peak,
           "eval": result.final_metrics, "launches": launches,
           "train_launches": train_launches, "wall_s": round(wall, 3)}
    for name, other in (beside or {}).items():
        rec[name] = {k: other[k] for k in (
            "first_loss", "step_ms_median", "tokens_per_s", "peak_mem_bytes")}
    emit(rec)
    check(len(losses) == cfg.train_steps,
          f"{phase}: expected {cfg.train_steps} loss records")
    check(all(math.isfinite(x) for x in losses),
          f"{phase}: non-finite loss {losses}")
    check(statistics.mean(losses[-5:]) < losses[0],
          f"{phase}: loss did not fall: {losses}")
    check(math.isfinite(result.final_metrics.get("loss", math.nan)),
          f"{phase}: final eval did not run")
    return rec


def phase_train(kernels, torch):
    rec = run_train(kernels, torch, "train", TRAIN_ARGV)
    n, launches = 12 * 30, rec["launches"]
    check(launches["flash_dq"] == n and launches["flash_dkv"] == n
          and launches["flash_fwd"] >= n,
          f"the run did not go through every flash kernel: {launches}")
    check(all(launches[k] == 0 for k in CE_KERNELS + RING_KERNELS),
          f"the dense run launched a fused-CE or ring kernel: {launches}")
    return rec


def phase_train_fused(kernels, torch, dense):
    """The tentpole command: the dense run with the head and loss fused
    into the CE kernels (eval by the scan formulation, no kernel)."""
    rec = run_train(kernels, torch, "train_fused", TRAIN_FUSED_ARGV,
                    {"dense": dense})
    launches = rec["launches"]
    check(all(launches[k] == 30 for k in CE_KERNELS),
          f"the fused run did not launch each CE kernel once per step: "
          f"{launches}")
    check(all(launches[k] == dense["launches"][k]
              for k in ("flash_fwd", "flash_dq", "flash_dkv")),
          f"flash launches differ from the dense run: {launches}")
    check(abs(rec["first_loss"] - dense["first_loss"]) <= TOL_FIRST_LOSS,
          f"first-step loss {rec['first_loss']} vs dense "
          f"{dense['first_loss']}")
    return rec


def profile_steps(torch, one) -> dict:
    """Where a train step's time goes: ``one(fetch)`` runs one step
    (ending in a host fetch of its loss when ``fetch``, as with
    --log-every 1). Over PROFILE_STEPS steps after 3 warm-up steps: the
    host-clocked step with and without the per-step fetch; the host's
    time to enqueue one step from an idle device; the device time of the
    steps from torch.profiler (CUDA activity), by kernel kind; and the
    host ops with the most self CPU time (CPU activity; the profiler's
    own cost inflates them)."""
    from torch.profiler import ProfilerActivity, profile

    def steps_ms(fetch):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(PROFILE_STEPS):
            one(fetch)
        torch.cuda.synchronize()
        return (time.time() - t0) / PROFILE_STEPS * 1e3

    for _ in range(3):
        one(True)
    step_ms = steps_ms(True)
    step_ms_no_fetch = steps_ms(False)
    torch.cuda.synchronize()
    t0 = time.time()
    one(False)
    enqueue_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(PROFILE_STEPS):
            one(True)
        torch.cuda.synchronize()
    host_top = [[e.key[:60], e.self_cpu_time_total / PROFILE_STEPS / 1e3,
                 e.count / PROFILE_STEPS]
                for e in sorted(prof.key_averages(),
                                key=lambda e: -e.self_cpu_time_total)[:8]]
    dev = device_ms(torch, lambda: one(True), PROFILE_STEPS)
    busy = sum(dev.values())
    kinds = {"flash": 0.0, "fused_ce": 0.0, "conv": 0.0, "gemm": 0.0,
             "other": 0.0}
    for name, ms in dev.items():
        low = name.lower()
        kind = ("flash" if "flash_" in low else
                "fused_ce" if "fused_ce" in low else
                "conv" if any(k in low for k in ("conv", "fprop", "dgrad",
                                                 "wgrad")) else
                "gemm" if any(k in low for k in ("gemm", "xmma", "nvjet",
                                                 "cutlass", "cublas"))
                else "other")
        kinds[kind] += ms
    return {"step_ms": step_ms, "step_ms_no_fetch": step_ms_no_fetch,
            "host_enqueue_ms": enqueue_ms, "host_top_self_ms_calls": host_top,
            "device_busy_ms": busy or None,
            "device_idle_share": (1 - busy / step_ms) if busy else None,
            "device_ms_by_kind": kinds,
            "device_top": [[name[:80], ms] for name, ms in sorted(
                dev.items(), key=lambda kv: -kv[1])[:8]]}


def profiled(torch, argv) -> dict:
    """``profile_steps`` of the train step of ``argv`` on cuda:0, over
    four batches of its stream in turn (measurement only: no launch
    count of a train phase is read after it)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.data.prefetch import to_device
    from tensorflow_distributed_tpu_torch.train import loop
    from tensorflow_distributed_tpu_torch.train.step import make_train_step
    from tensorflow_distributed_tpu_torch.train.tasks import make_task

    device = torch.device("cuda")
    cfg = parse_args(argv)
    task = make_task(cfg)
    _, state = loop._build_model_and_state(cfg, device)
    step = make_train_step(task.loss, device, cfg.seed)
    stream = task.train_stream(0)
    batches = [to_device(next(stream), device) for _ in range(4)]
    it = iter(range(10 ** 9))

    def one(fetch):
        nonlocal state
        state, metrics = step(state, batches[next(it) % len(batches)])
        if fetch:
            float(metrics["loss"])

    out = profile_steps(torch, one)
    del state, batches
    torch.cuda.empty_cache()
    return out


def phase_step_profile(torch) -> None:
    """Where a train step's time goes, for the dense, the fused, the
    Llama-style and the windowed run's flags (``profile_steps``)."""
    for run, argv in (("train", TRAIN_ARGV), ("train_fused", TRAIN_FUSED_ARGV),
                      ("train_llama", TRAIN_LLAMA_ARGV),
                      ("train_window", TRAIN_WINDOW_ARGV)):
        emit({"phase": "step_profile", "run": run, "steps": PROFILE_STEPS,
              **profiled(torch, argv)})


def partial_bounds(B, H, nh, D, causal):
    """(bound_ms, bound_by) of each partial kernel on [B*H, nh, D]
    blocks: q, k, v bf16 read once, the f32 o / dO and the f32 rows
    (m, l, dl) read or written once, the bf16 grads written once,
    against the tensor-core work of the (query, key) pairs in the
    block (the in-block triangle when causal)."""
    BH = B * H
    pairs = nh * (nh + 1) // 2 if causal else nh * nh
    x16, x32, rows = BH * nh * D * 2, BH * nh * D * 4, BH * nh * 4
    return {
        # S = QK^T, O = PV; writes o (f32), m, l
        "flash_fwd_partial": bound(3 * x16 + x32 + 2 * rows,
                                   4 * BH * pairs * D),
        # S, dP = dO V^T, dQ = dS K; reads m, dl, dO (f32)
        "flash_dq_partial": bound(3 * x16 + 2 * rows + x32 + x16,
                                  6 * BH * pairs * D),
        # S, dP, dV = P^T dO, dK = dS^T Q
        "flash_dkv_partial": bound(3 * x16 + 2 * rows + x32 + 2 * x16,
                                   8 * BH * pairs * D),
    }


def phase_ring_kernels(fa, torch, gpu):
    """Correctness of every case; event and plain times at the main case,
    device times at every D 64 case, and SDPA's flash backward at the
    half-block."""
    results = {}
    for i, case in enumerate(RING_KERNEL_CASES):
        B, H, nh, D, causal = (case[k] for k in ("B", "H", "nh", "D",
                                                 "causal"))
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q, k, v = (torch.randn((B * H, nh, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        do = torch.randn((B * H, nh, D), generator=gen, device="cuda")
        dl = torch.randn((B * H, nh), generator=gen, device="cuda")
        o, m, l = fa.flash_fwd_partial(q, k, v, causal)
        dq = fa.flash_dq_partial(q, k, v, m, do, dl, causal)
        dk, dv = fa.flash_dkv_partial(q, k, v, m, do, dl, causal)
        torch.cuda.synchronize()
        f = [t.float() for t in (q, k, v)]
        ref_o, ref_m, ref_l = fa.flash_fwd_partial_reference(*f, causal)
        ref_dq = fa.flash_dq_partial_reference(*f, m, do, dl, causal)
        ref_dk, ref_dv = fa.flash_dkv_partial_reference(*f, m, do, dl,
                                                        causal)

        def abs_err(a, b):
            return float((a.float() - b).abs().max())

        def rel_err(a, b):
            return abs_err(a, b) / float(b.abs().max())

        row = {"phase": "ring_kernels", **case,
               "o_rel_err": rel_err(o, ref_o),
               "m_abs_err": abs_err(m, ref_m),
               "l_abs_err": abs_err(l, ref_l),
               "dq_rel_err": rel_err(dq, ref_dq),
               "dk_rel_err": rel_err(dk, ref_dk),
               "dv_rel_err": rel_err(dv, ref_dv),
               "o_abs_err": abs_err(o, ref_o),
               "dq_abs_err": abs_err(dq, ref_dq),
               "dkv_abs_err": max(abs_err(dk, ref_dk), abs_err(dv, ref_dv))}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, m, l, dq, dk, dv))
        emit(row)
        check(finite, f"non-finite partial kernel output in case {case}")
        check(row["o_rel_err"] <= TOL_PARTIAL_O,
              f"flash_fwd_partial o error {row}")
        check(row["m_abs_err"] <= TOL_STATS and row["l_abs_err"] <= TOL_STATS,
              f"flash_fwd_partial m/l error {row}")
        for g in ("dq", "dk", "dv"):
            check(row[f"{g}_rel_err"] <= TOL_RING, f"partial {g} error {row}")
        # At these sizes a launch is short next to its host-side call
        # (checks, allocations, ctypes): the kernels' device time alone,
        # from the profiler, at the 128- and 512-row cases (D 64).
        calls = {"flash_fwd_partial": lambda: fa.flash_fwd_partial(
                     q, k, v, causal),
                 "flash_dq_partial": lambda: fa.flash_dq_partial(
                     q, k, v, m, do, dl, causal),
                 "flash_dkv_partial": lambda: fa.flash_dkv_partial(
                     q, k, v, m, do, dl, causal)}
        timing = {"phase": "ring_kernels_timing", **case, "gpu": gpu}
        bounds = partial_bounds(B, H, nh, D, causal)
        if i == 0:
            results["errors"] = row
            results["bounds"] = bounds
            results["ms"] = {name: time_ms(torch, fn)
                             for name, fn in calls.items()}
            results["plain_ms"] = {
                "flash_fwd_partial": time_ms(torch, lambda: (
                    fa.flash_fwd_partial_reference(q, k, v, causal))),
                "flash_dq_partial": time_ms(torch, lambda: (
                    fa.flash_dq_partial_reference(q, k, v, m, do, dl,
                                                  causal))),
                "flash_dkv_partial": time_ms(torch, lambda: (
                    fa.flash_dkv_partial_reference(q, k, v, m, do, dl,
                                                   causal))),
            }
            # No PyTorch call returns the unnormalized (o, m, l) of a
            # block or its partial gradients (SDPA normalizes).
            results["library_ms"] = dict.fromkeys(results["ms"])
            timing.update(ms=results["ms"], plain_ms=results["plain_ms"])
        if D == 64:
            timing["device_ms"] = {
                name: sum(device_ms(torch, fn, 20).values()) or None
                for name, fn in calls.items()}
            timing["bound_ms"] = {k: b[0] for k, b in bounds.items()}
        if nh == 128:
            # A work-equivalent yardstick for B8 + B9 together, not their
            # function: SDPA's flash backward on the same half-block does
            # the same products for the normalized softmax.
            q4, k4, v4, do4 = (t.view(B, H, nh, D) for t in (
                q, k, v, do.to(torch.bfloat16)))
            timing["sdpa_flash_bwd_device_ms"] = sum(device_ms(
                torch, sdpa_flash_bwd(torch, q4, k4, v4, do4, causal),
                20).values()) or None
            del q4, k4, v4, do4
        if "device_ms" in timing:
            emit(timing)
        del q, k, v, do, dl, o, m, l, dq, dk, dv, f
        del ref_o, ref_m, ref_l, ref_dq, ref_dk, ref_dv
        torch.cuda.empty_cache()
    return results


def phase_ring(fa, ra, torch, gpu):
    """The stacked zigzag ring on the card: launches per call (counted
    from 0 around the first case's fwd+bwd, the kernels line's
    launches), agreement with the flash kernels and the plain version,
    and times."""
    launches = None
    for case in RING_CASES:
        S, B, H, L, D = (case[k] for k in ("S", "B", "H", "L", "D"))
        gen = torch.Generator(device="cuda").manual_seed(300 + S)
        q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        ring = ra.StackedRing(S)
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        out = ra.ring_attention(*x, ring, causal=True)
        torch.autograd.backward(out, do)
        torch.cuda.synchronize()
        counts = {kern.name: kern.launches
                  for kern in fa.KERNELS + fa.PARTIAL_KERNELS}
        if launches is None:
            launches = counts
        got = [out.detach()] + [t.grad for t in x]
        del x, out

        y = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_out = fa.flash_attention(*y, causal=True)
        torch.autograd.backward(flash_out, do)
        flash = [flash_out.detach()] + [t.grad for t in y]
        del y, flash_out

        def rel_err(a, b):
            return float((a.float() - b.float()).abs().max()
                         / b.float().abs().max())

        names = ("out", "dq", "dk", "dv")
        row = {"phase": "ring", **case, "gpu": gpu, "launches": counts,
               "vs_flash_rel_err": {n: rel_err(a, b)
                                    for n, a, b in zip(names, got, flash)}}
        del flash
        if L * L * B * H * 4 <= PLAIN_SCORE_BYTES:
            z = [t.float().requires_grad_() for t in (q, k, v)]
            ref = ra.full_attention(*z, ra.causal_bias(L, L, "cuda"))
            torch.autograd.backward(ref, do.float())
            plain = [ref.detach()] + [t.grad for t in z]
            row["vs_plain_rel_err"] = {n: rel_err(a, b)
                                       for n, a, b in zip(names, got, plain)}
            del z, ref, plain
        else:  # the last query rows, forward
            r0 = L - RING_PLAIN_ROWS
            rows = torch.arange(r0, L, device="cuda")[:, None]
            cols = torch.arange(L, device="cuda")[None, :]
            bias = torch.where(cols <= rows, 0.0, -1e30)[None]
            ref = ra.full_attention(q[:, r0:].float(), k.float(), v.float(),
                                    bias)
            row["vs_plain_rel_err"] = {
                f"out_last_{RING_PLAIN_ROWS}_rows": rel_err(got[0][:, r0:],
                                                            ref)}
            del ref, bias
        xr = [t.clone().requires_grad_() for t in (q, k, v)]
        yr = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.no_grad():
            row["fwd_ms"] = time_ms(torch, lambda: ra.ring_attention(
                q, k, v, ring, causal=True), iters=10)
            row["flash_fwd_ms"] = time_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=True), iters=10)
        row["fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.backward(
            ra.ring_attention(*xr, ring, causal=True), do), iters=10)
        row["flash_fwd_bwd_ms"] = time_ms(
            torch, lambda: torch.autograd.backward(
                fa.flash_attention(*yr, causal=True), do), iters=10)
        # Device time of one ring fwd+bwd: every kernel, the partial
        # kernels' share (the rest is the zigzag's selects, merges and
        # permutes), and the largest kernels by name.
        dev = device_ms(torch, lambda: torch.autograd.backward(
            ra.ring_attention(*xr, ring, causal=True), do), iters=5)
        row["fwd_bwd_device_ms"] = sum(dev.values()) or None
        row["fwd_bwd_partial_kernels_device_ms"] = sum(
            ms for name, ms in dev.items() if "flash_" in name) or None
        row["fwd_bwd_device_top"] = [
            [name[:80], ms] for name, ms in sorted(
                dev.items(), key=lambda kv: -kv[1])[:6]]
        emit(row)
        del q, k, v, do, xr, yr, got
        torch.cuda.empty_cache()
        want = 2 * S + 1
        check(all(counts[kern.name] == want for kern in fa.PARTIAL_KERNELS)
              and all(counts[kern.name] == 0 for kern in fa.KERNELS),
              f"ring S={S}: expected {want} launches of each partial "
              f"kernel and none of B1-B3: {counts}")
        for key in ("vs_flash_rel_err", "vs_plain_rel_err"):
            check(all(e <= TOL_RING for e in row[key].values()),
                  f"ring S={S} {key}: {row[key]}")
    return launches


def rank_entry(outdir: str, argv) -> int:
    """One torchrun rank of train_ring or train_data: trains ``argv``
    through the CLI's path (the chief prints the performance table) with
    its standard output in ``rank{r}.out``, and writes its losses and
    launch counts (all nine kernels, set to 0 just before the run) to
    ``rank{r}.json`` in ``outdir``."""
    import contextlib

    from tensorflow_distributed_tpu_torch import cli
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce
    from tensorflow_distributed_tpu_torch.parallel import mesh
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    rank = int(os.environ["RANK"])
    cfg = parse_args(argv)
    kernels = fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS
    for kern in kernels:
        kern.launches = 0
    out = os.path.join(outdir, f"rank{rank}.out")
    try:
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            result = cli.train_and_report(
                cfg, logger=MetricLogger(stream=sys.stderr))
    finally:
        mesh.shutdown()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": [r.metrics["loss"] for r in result.logger.records
                              if "loss" in r.metrics],
                   "steps_per_sec": result.steps_per_sec,
                   "images_per_sec": result.images_per_sec,
                   "launches": {kern.name: kern.launches
                                for kern in kernels}}, f)
    return 0


def torchrun_command(nproc: int, outdir: str, argv):
    """The torchrun line that starts ``nproc`` ranks of ``rank_entry``
    (one card each, NCCL) on ``argv``."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", os.path.abspath(__file__),
            "--rank", outdir, *argv]


def run_torchrun(phase: str, nproc: int, argv, timeout: float):
    """Run ``torchrun_command``; kill it and every rank left over when it
    outlives ``timeout``. Returns (wall seconds, each rank's json record,
    each rank's standard output)."""
    with tempfile.TemporaryDirectory() as outdir:
        t0 = time.time()
        proc = subprocess.Popen(
            torchrun_command(nproc, outdir, argv),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            # torchrun ends its ranks (each in a session of its own) on
            # SIGTERM; a rank that outlives that is killed by its pid.
            proc.terminate()
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
            for line in subprocess.run(
                    ["pgrep", "-f", f"--rank {outdir}"],
                    capture_output=True, text=True).stdout.split():
                os.kill(int(line), signal.SIGKILL)
            fail(f"{phase}: torchrun still running after {timeout} s")
        wall = time.time() - t0
        sys.stderr.write(err[-4000:])
        check(proc.returncode == 0,
              f"{phase}: torchrun exited {proc.returncode}")
        ranks, outs = [], []
        for r in range(nproc):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            with open(os.path.join(outdir, f"rank{r}.out")) as f:
                outs.append(f.read())
    return wall, ranks, outs


def one_card_losses(argv):
    """The first losses and steps/s of ``argv`` trained in this process
    on one card (no process group)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    result = train(parse_args(argv), logger=MetricLogger(stream=sys.stderr))
    return ([r.metrics["loss"] for r in result.logger.records
             if "loss" in r.metrics], result.steps_per_sec)


def phase_train_ring(torch) -> None:
    """--mesh.seq S over torchrun's S processes (NCCL), S = 4 with four
    cards or more, else 2; skipped, by the device count alone, on one
    card."""
    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "train_ring",
              "skipped": f"needs >= 2 CUDA devices, have {count}"})
        return
    S = 4 if count >= 4 else 2
    wall, ranks, _ = run_torchrun("train_ring", S,
                                  TRAIN_RING_ARGV + ["--mesh.seq", str(S)],
                                  TRAIN_RING_TIMEOUT_S)
    one, one_sps = one_card_losses(TRAIN_RING_ARGV)
    partial = ("flash_fwd_partial", "flash_dq_partial", "flash_dkv_partial")
    launches = [{k: r["launches"][k] for k in partial} for r in ranks]
    emit({"phase": "train_ring", "S": S, "wall_s": round(wall, 3),
          "losses": ranks[0]["losses"], "one_card_losses": one,
          "steps_per_sec": ranks[0]["steps_per_sec"],
          "one_card_steps_per_sec": one_sps, "launches": launches})
    for r, n in zip(ranks, launches):
        check(len(r["losses"]) == 5 and all(
            abs(a - b) <= TOL_RING_LOSS for a, b in zip(r["losses"], one)),
            f"train_ring losses {r['losses']} vs one card {one}")
        check(all(v > 0 for v in n.values()),
              f"train_ring: a rank did not launch every partial kernel: {n}")


def phase_model_cnn(torch, np) -> None:
    """The reference's CNN on the card in bf16 against the same weights
    on the CPU in f32, at batch 256: the logits and every grad (cuDNN
    convs and cuBLAS products: no kernel of this repository)."""
    from tensorflow_distributed_tpu_torch.models.cnn import MnistCNN
    from tensorflow_distributed_tpu_torch.ops.losses import (
        softmax_cross_entropy)

    ref_model = MnistCNN(compute_dtype=torch.float32, dropout_rate=0.0)
    ref_model.init_weights(torch.Generator().manual_seed(0))
    model = MnistCNN(compute_dtype=torch.bfloat16, dropout_rate=0.0).cuda()
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((256, 28, 28, 1), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, size=256))

    def run(m, dev):
        logits = m(images.to(dev))
        softmax_cross_entropy(logits, labels.to(dev)).backward()
        return logits.detach().cpu(), {n: p.grad.cpu()
                                       for n, p in m.named_parameters()}

    ref_logits, ref_grads = run(ref_model, "cpu")
    logits, grads = run(model, "cuda")
    torch.cuda.synchronize()
    logit_err = float((logits - ref_logits).abs().max()
                      / ref_logits.abs().max())
    grad_err = {n: float((grads[n] - g).abs().max() / g.abs().max())
                for n, g in ref_grads.items()}
    emit({"phase": "model_cnn", "batch": 256, "logits_rel_err": logit_err,
          "grads_rel_err": grad_err, "tolerance": TOL_MODEL})
    check(logits.dtype == torch.float32 and logits.shape == (256, 10),
          f"model_cnn: logits {logits.dtype} {tuple(logits.shape)}")
    check(logit_err <= TOL_MODEL and max(grad_err.values()) <= TOL_MODEL,
          f"the CNN on the card disagrees with the plain path: logits "
          f"{logit_err}, grads {grad_err}")


def check_fixture(data_dir: str) -> None:
    """The accuracy bar must train on the committed idx files, not on
    the synthetic digits the loader falls back to when they are
    missing."""
    from tensorflow_distributed_tpu_torch.data.mnist import load_dataset

    train_ds, _, _ = load_dataset("mnist", data_dir, validation_size=64)
    check(train_ds.name == "mnist",
          f"the MNIST fixture did not load from {data_dir}: "
          f"{train_ds.name}")


def phase_train_cnn(kernels, torch) -> None:
    """The reference's job through the port's CLI path on one card: (a)
    the JAX package's default-tier accuracy bar on the committed MNIST
    fixture, (b) a timing run at the JAX defaults (synthetic digits,
    batch 256, dropout 0.25) with its step profile."""
    check_fixture(FIXTURE_DIR)
    bar = run_train(kernels, torch, "train_cnn", TRAIN_CNN_ARGV)
    accuracy = bar["eval"]["accuracy"]
    emit({"phase": "train_cnn", "run": "accuracy_bar",
          "val_accuracy": accuracy, "bar": CNN_ACCURACY_BAR})
    check(accuracy >= CNN_ACCURACY_BAR,
          f"train_cnn: val accuracy {accuracy} < {CNN_ACCURACY_BAR}")
    timing = run_train(kernels, torch, "train_cnn", TRAIN_CNN_TIMING_ARGV)
    check(all(n == 0 for n in timing["launches"].values()),
          f"the CNN launched a kernel of the GPT: {timing['launches']}")
    emit({"phase": "train_cnn", "run": "profile", "steps": PROFILE_STEPS,
          **profiled(torch, TRAIN_CNN_TIMING_ARGV)})


def gpt_data_argv(rows: int):
    """GPT-2-small at seq 1024 with the fused CE, ``rows`` global rows."""
    return ["--mode", "train", "--model", "gpt_lm", "--model-size", "small",
            "--seq-len", "1024", "--batch-size", str(rows), "--train-steps",
            "5", "--eval-every", "5", "--eval-batch-size", str(rows),
            "--dropout-rate", "0", "--compute-dtype", "bfloat16",
            "--ce-chunk", "8192", "--ce-impl", "kernel", "--log-every", "1"]


def data_runs(count: int):
    """train_data's runs for ``count`` cards: (name, processes, argv,
    the one-card argv on the same global batch, the kernels each rank
    must launch). N = min(count, 4) processes, 8 GPT rows a data rank;
    a (data 2, seq 2) GPT run on four cards."""
    n = min(count, 4)
    flash = ["flash_fwd", "flash_dq", "flash_dkv"]
    ce = ["fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"]
    partial = ["flash_fwd_partial", "flash_dq_partial", "flash_dkv_partial"]
    runs = [("mnist_cnn", n, TRAIN_DATA_CNN_ARGV + ["--mesh.data", str(n)],
             TRAIN_DATA_CNN_ARGV, []),
            ("gpt_lm", n, gpt_data_argv(8 * n) + ["--mesh.data", str(n)],
             gpt_data_argv(8 * n), flash + ce)]
    if n == 4:
        runs.append(("gpt_lm_seq", 4, gpt_data_argv(16)
                     + ["--mesh.data", "2", "--mesh.seq", "2"],
                     gpt_data_argv(16), ce + partial))
    return runs


def phase_train_data(torch) -> None:
    """Sync data parallelism: each run of ``data_runs`` under torchrun
    (N processes, one card each, NCCL; on one card a real torchrun of
    one process with an NCCL group of one), its first five losses held
    to one card's on the same global batch, every rank's kernel
    launches read, and the performance table printed by rank 0 only."""
    for name, nproc, argv, one_argv, must_launch in data_runs(
            torch.cuda.device_count()):
        wall, ranks, outs = run_torchrun(f"train_data {name}", nproc, argv,
                                         TRAIN_DATA_TIMEOUT_S)
        one, one_sps = one_card_losses(one_argv)
        diff = max(abs(a - b) for r in ranks
                   for a, b in zip(r["losses"], one))
        tables = [TABLE_HEADER in out for out in outs]
        emit({"phase": "train_data", "run": name, "processes": nproc,
              "argv": argv, "wall_s": round(wall, 3),
              "losses": ranks[0]["losses"], "one_card_losses": one,
              "max_loss_diff": diff, "tolerance": TOL_RING_LOSS,
              "steps_per_sec": ranks[0]["steps_per_sec"],
              "images_per_sec": ranks[0]["images_per_sec"],
              "one_card_steps_per_sec": one_sps,
              "launches_per_rank": [r["launches"] for r in ranks],
              "table_from_ranks": [r for r, t in enumerate(tables) if t]})
        for r in ranks:
            check(len(r["losses"]) == 5,
                  f"train_data {name}: {len(r['losses'])} loss records")
        check(diff <= TOL_RING_LOSS,
              f"train_data {name}: losses {[r['losses'] for r in ranks]} "
              f"vs one card {one}")
        check(all(r["launches"][k] > 0 for r in ranks for k in must_launch),
              f"train_data {name}: a rank did not launch {must_launch}: "
              f"{[r['launches'] for r in ranks]}")
        check(tables == [True] + [False] * (nproc - 1),
              f"train_data {name}: the table printed from ranks {tables}")


def gpt2_small(torch, dtype, **overrides):
    """GPT-2-small at its published widths on the card, fresh-init from
    seed 0, without dropout; ``overrides`` are TransformerConfig fields
    (the Llama-style options)."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    with torch.device(DEVICE):
        model = gpt_lm("small", compute_dtype=dtype, dropout_rate=0.0,
                       **overrides)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(0))
    return model


def decode_phase(fa, torch, np, phase, overrides) -> None:
    """Prefill four prompts at their own depths in one batch, then decode
    DECODE_STEPS greedy tokens; at every step hold the last-position
    logits to the training forward (B1) over the same tokens. With
    ``n_kv_heads`` in ``overrides`` the cache must hold exactly
    n_kv_heads / n_heads of an MHA cache's bytes."""
    import dataclasses

    from tensorflow_distributed_tpu_torch.models.generate import (
        decode_token, prefill_cache)
    from tensorflow_distributed_tpu_torch.models.transformer import KVCache

    model = gpt2_small(torch, torch.bfloat16, **overrides)
    rng = np.random.default_rng(0)
    B, P = len(DECODE_PROMPTS), max(DECODE_PROMPTS)
    width = -(-(P + DECODE_STEPS) // fa.BLOCK) * fa.BLOCK  # B1's tile
    seq = torch.zeros((B, width), dtype=torch.long, device=DEVICE)
    for b, n in enumerate(DECODE_PROMPTS):
        seq[b, :n] = torch.from_numpy(
            rng.integers(0, model.cfg.vocab_size, n))
    rows = torch.arange(B, device=DEVICE)
    pos = torch.tensor(DECODE_PROMPTS, device=DEVICE)
    b1 = fa.KERNELS[0]
    before = b1.launches
    with torch.no_grad():
        logits, cache = prefill_cache(model, seq[:, :P])
        last = logits[rows, pos - 1]
        errs = []
        for step in range(DECODE_STEPS + 1):
            ref = model(seq)[rows, pos - 1]
            check(bool(torch.isfinite(last).all()),
                  f"{phase}: non-finite logits at step {step}")
            errs.append(float((last - ref).abs().max() / ref.abs().max()))
            if step == DECODE_STEPS:
                break
            tok = last.argmax(dim=-1)
            seq[rows, pos] = tok
            last, cache = decode_token(model, cache, tok, pos)
            pos = pos + 1
    launched = b1.launches - before
    mha_bytes = KVCache.zeros(dataclasses.replace(model.cfg, n_kv_heads=None),
                              B, device="meta").nbytes()
    want_bytes = (mha_bytes * overrides["n_kv_heads"] // model.cfg.n_heads
                  if "n_kv_heads" in overrides else mha_bytes)
    emit({"phase": phase, "prompts": list(DECODE_PROMPTS),
          "steps": DECODE_STEPS, "oracle_width": width,
          "rel_err_by_step": errs, "max_rel_err": max(errs),
          "tolerance": TOL_DECODE, "oracle_flash_fwd_launches": launched,
          "cache_shape": list(cache.k[0].shape),
          "cache_bytes": cache.nbytes(), "mha_cache_bytes": mha_bytes})
    check(cache.nbytes() == want_bytes,
          f"{phase}: the cache holds {cache.nbytes()} bytes, not "
          f"{want_bytes} (n_kv_heads / n_heads of the MHA cache's "
          f"{mha_bytes}): a GQA cache of full width")
    check(max(errs) <= TOL_DECODE,
          f"{phase}: logits disagree with the training forward: {errs}")
    check(launched == model.cfg.n_layers * (DECODE_STEPS + 1),
          f"{phase}: the oracle forward did not run B1: {launched} launches")


def phase_decode(fa, torch, np) -> None:
    decode_phase(fa, torch, np, "decode", {})


def first_mismatch(got, ref):
    """The first step at which two token streams differ, or None."""
    for j, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            return j
    return None if len(got) == len(ref) else min(len(got), len(ref))


def top2_gap(torch, model, prompt, ref, j: int) -> float:
    """The gap between the two largest logits where ``ref`` (a greedy
    stream after ``prompt``) takes its ``j``-th token."""
    from tensorflow_distributed_tpu_torch.models.generate import (
        prefill_cache)

    seq = torch.tensor(list(prompt) + list(ref[:j]), device=DEVICE)[None]
    top2 = torch.topk(prefill_cache(model, seq)[0][0, -1], 2).values
    return float(top2[0] - top2[1])


def serve_identity(torch, np, phase, overrides) -> None:
    """The engine under the FIFO scheduler in f32, request by request
    against one-shot greedy ``generate()``: identical streams, except
    where the reference's top-2 logit gap is under IDENTITY_GAP."""
    from tensorflow_distributed_tpu_torch.models.generate import generate
    from tensorflow_distributed_tpu_torch.serve.buckets import (
        default_buckets)
    from tensorflow_distributed_tpu_torch.serve.engine import (
        SlotDecodeEngine)
    from tensorflow_distributed_tpu_torch.serve.scheduler import (
        Request, Scheduler)

    model = gpt2_small(torch, torch.float32, **overrides)
    rng = np.random.default_rng(1)
    lens = np.linspace(*IDENTITY_PROMPTS, IDENTITY_REQUESTS).astype(int)
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]
    engine = SlotDecodeEngine(model, IDENTITY_SLOTS, buckets=default_buckets(
        max(lens), cap=model.cfg.max_len))
    engine.warmup()
    t0 = time.time()
    done = {c.rid: c for c in Scheduler(engine, decode_priority=4).run(
        [Request(rid=i, prompt=p, max_new_tokens=IDENTITY_NEW)
         for i, p in enumerate(prompts)])}
    wall = time.time() - t0

    excused = []
    for i, p in enumerate(prompts):
        ref = generate(model, torch.from_numpy(p).to(DEVICE)[None],
                       IDENTITY_NEW)[0].tolist()
        j = first_mismatch(done[i].tokens, ref)
        if j is None:
            continue
        gap = top2_gap(torch, model, p, ref, j)
        excused.append({"rid": i, "prompt_len": len(p), "step": j,
                        "top2_gap": gap})
        check(gap < IDENTITY_GAP,
              f"{phase}: request {i} (prompt {len(p)}) differs from "
              f"generate() at step {j}, where the top-2 logit gap is {gap}")
    emit({"phase": phase, "requests": IDENTITY_REQUESTS,
          "slots": IDENTITY_SLOTS, "new_tokens": IDENTITY_NEW,
          "prompt_lens": lens.tolist(), "identical": IDENTITY_REQUESTS
          - len(excused), "excused": excused,
          "buckets_used": engine.prefill_compiles,
          "ladder": list(engine.buckets), "prefills": engine.prefills,
          "decode_steps": engine.decode_steps,
          "cache_bytes_per_slot": engine.cache_bytes_per_slot(),
          "wall_s": round(wall, 3)})
    check(engine.prefills == IDENTITY_REQUESTS,
          f"{phase}: {engine.prefills} prefills")
    check(engine.prefill_compiles <= len(engine.buckets),
          f"{phase}: {engine.prefill_compiles} prefill shapes for a "
          f"ladder of {len(engine.buckets)}")


def phase_serve_identity(torch, np) -> None:
    serve_identity(torch, np, "serve_identity", {})


def run_cli(argv):
    """``cli.main(argv)`` in this process, its standard output captured
    (and echoed to standard error). Returns (exit code, the output)."""
    import contextlib
    import io

    from tensorflow_distributed_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    sys.stderr.write(out)
    return rc, out


def event_record(out: str, event: str):
    """The first JSON record of ``event`` in a CLI's output, or None."""
    return next((json.loads(l) for l in out.splitlines()
                 if l.startswith(f'{{"event": "{event}"')), None)


def serve_cli(argv):
    """``cli.main(argv)`` in this process. Returns (exit code, the
    ``[serve]`` summary line, the ``serve_summary`` record, the
    output)."""
    rc, out = run_cli(argv)
    lines = out.splitlines()
    line = next((l for l in lines if l.startswith("[serve] ")
                 and not l.startswith("[serve] rid=")), None)
    record = event_record(out, "serve_summary")
    check(rc == 0 and line is not None and record is not None,
          f"serve: the CLI exited {rc} without its summary")
    return rc, line, record, out


def serve_profile(torch, argv) -> dict:
    """Where a decode step of ``argv``'s engine goes, every slot live:
    PROFILE_STEPS steps after 3 warm-up steps, each ending in the
    engine's token fetch; the host's time to enqueue a step onto an idle
    device; and from torch.profiler the kernels launched and the device
    busy time a step."""
    from torch.profiler import ProfilerActivity, profile

    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.models.generate import (
        decode_token)
    from tensorflow_distributed_tpu_torch.serve.run import serve_setup

    _, engine, requests = serve_setup(parse_args(argv))
    engine.warmup()
    for slot, r in enumerate(requests[:engine.num_slots]):
        engine.prefill(r.prompt, slot)
    vocab = engine.model.cfg.vocab_size
    for _ in range(3):
        nxt = engine.step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(PROFILE_STEPS):
        nxt = engine.step()
    step_ms = (time.time() - t0) / PROFILE_STEPS * 1e3
    check(bool(((nxt >= 0) & (nxt < vocab)).all()),
          f"serve: tokens outside the vocabulary: {nxt}")
    torch.cuda.synchronize()
    t0 = time.time()
    # One step's work, enqueued without its fetch (it rewrites the
    # columns the next step writes again).
    last, _ = decode_token(engine.model, engine.cache,
                           engine._h2d(engine.tok), engine._h2d(engine.pos))
    enqueue_ms = (time.time() - t0) * 1e3
    check(bool(torch.isfinite(last).all()), "serve: non-finite logits")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            engine.step()
        torch.cuda.synchronize()
    busy, launches, top = 0.0, 0, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            busy += us / PROFILE_STEPS / 1e3
            launches += e.count
            top.append([e.key[:80], us / PROFILE_STEPS / 1e3,
                        e.count / PROFILE_STEPS])
    top.sort(key=lambda row: -row[1])
    return {"step_ms": step_ms, "host_enqueue_ms": enqueue_ms,
            "launches_per_step": launches / PROFILE_STEPS,
            "device_busy_ms": busy or None,
            "device_idle_share": (1 - busy / step_ms) if busy else None,
            "device_top": top[:8],
            "cache_bytes": engine.cache_bytes_per_slot() * engine.num_slots}


def phase_serve(torch) -> None:
    """``--mode serve`` through the CLI at full width in bf16, then a
    traced decode step of the same engine."""
    torch.cuda.reset_peak_memory_stats()
    rc, line, summary, _ = serve_cli(SERVE_ARGV)
    peak = torch.cuda.max_memory_allocated()
    keys = ("tokens_per_sec", "ttft_ms_p50", "ttft_ms_p95", "tok_ms_mean",
            "mean_slot_occupancy", "buckets", "prefill_compiles",
            "decode_steps", "total_new_tokens", "wall_s")
    emit({"phase": "serve", "argv": SERVE_ARGV, "exit": rc,
          "summary_line": line, **{k: summary[k] for k in keys},
          "peak_mem_bytes": peak, "profile": serve_profile(torch, SERVE_ARGV)})
    check(summary["total_new_tokens"] == SERVE_REQUESTS * SERVE_NEW,
          f"serve: {summary['total_new_tokens']} tokens delivered, not "
          f"{SERVE_REQUESTS} x {SERVE_NEW}")


def sync(torch) -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def train_losses(result):
    return [r.metrics["loss"] for r in result.logger.records
            if "loss" in r.metrics]


def restored(torch, argv):
    """The model and train state that ``argv`` (with a
    ``--checkpoint-dir``) builds, restored from the latest checkpoint."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state)

    cfg = parse_args(argv)
    model, state = _build_model_and_state(cfg, torch.device(cfg.device))
    return cfg, model, ckpt.restore(cfg.checkpoint_dir, state)


def states_equal(torch, a, b) -> bool:
    """Every tensor of two train states equal, and their step and count."""
    groups = [(a.params, b.params)] + [
        (a.opt_state[k], b.opt_state[k]) for k in a.opt_state if k != "count"]
    if a.ema is not None or b.ema is not None:
        groups.append((a.ema or {}, b.ema or {}))
    return (a.step == b.step
            and a.opt_state["count"] == b.opt_state["count"]
            and all(x.keys() == y.keys()
                    and all(torch.equal(x[n], y[n]) for n in x)
                    for x, y in groups))


def phase_checkpoint(kernels, torch, ckpt_dir: str) -> None:
    """6 straight steps of the fused run against 3 steps with a save at
    step 3 and ``--resume`` to 6 in a new process; then a save and a
    restore in this process of the straight run's state."""
    import hashlib

    from tensorflow_distributed_tpu_torch import interop
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state, train)
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    def run(argv):
        return train(parse_args(argv), logger=MetricLogger(stream=sys.stderr))

    steps = ["--train-steps", str(CHECKPOINT_STEPS)]
    save = ["--checkpoint-dir", ckpt_dir, "--checkpoint-every",
            str(CHECKPOINT_EVERY)]
    straight = run(CHECKPOINT_ARGV + steps)
    first = run(CHECKPOINT_ARGV + ["--train-steps", str(CHECKPOINT_EVERY)]
                + save)
    resume_argv = CHECKPOINT_ARGV + steps + save + ["--resume", "true"]
    wall, ranks, _ = run_torchrun("checkpoint", 1, resume_argv,
                                     CHECKPOINT_TIMEOUT_S)
    want = train_losses(straight)
    got = train_losses(first) + ranks[0]["losses"]
    diffs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    resumed = ranks[0]["launches"]
    legs = CHECKPOINT_STEPS - CHECKPOINT_EVERY
    with tempfile.TemporaryDirectory(prefix="tfd_roundtrip_") as rt:
        sync(torch)
        t0 = time.time()
        path = ckpt.save(rt, straight.state)
        save_s = time.time() - t0
        # Where a save goes: the device-to-host state dict, and the
        # sha256 rate on this host (the file is hashed once a save, and
        # once a restore).
        t0 = time.time()
        interop.state_to_flax(straight.state)
        to_host_s = time.time() - t0
        buf = bytes(2 ** 28)
        t0 = time.time()
        hashlib.sha256(buf).digest()
        sha256_gb_s = len(buf) / (time.time() - t0) / 1e9
        del buf
        files = {n: os.path.getsize(os.path.join(path, n))
                 for n in sorted(os.listdir(path))}
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        cfg = parse_args(CHECKPOINT_ARGV + steps)
        device = next(straight.state.model.parameters()).device
        fresh = _build_model_and_state(cfg, device)[1]
        sync(torch)
        t0 = time.time()
        ckpt.restore(rt, fresh)
        sync(torch)
        restore_s = time.time() - t0
        equal = states_equal(torch, straight.state, fresh)
    emit({"phase": "checkpoint", "argv": resume_argv,
          "straight_losses": want, "split_losses": got,
          "max_rel_diff": max(diffs), "bit_identical": got == want,
          "tolerance": TOL_RESUME, "resumed_launches": resumed,
          "resume_wall_s": round(wall, 3),
          "steps_saved": ckpt.available_steps(ckpt_dir),
          "step_dir_bytes": sum(files.values()), "files": files,
          "param_bytes": manifest["param_bytes"], "save_s": save_s,
          "to_host_s": to_host_s, "sha256_gb_s": sha256_gb_s,
          "restore_s": restore_s, "roundtrip_equal": equal})
    check(len(got) == len(want) == CHECKPOINT_STEPS,
          f"checkpoint: {len(got)} split losses, {len(want)} straight")
    check(max(diffs) <= TOL_RESUME,
          f"checkpoint: the resumed run left the straight one: {diffs}")
    check(len(ranks[0]["losses"]) == legs,
          f"checkpoint: the second leg did not resume at step "
          f"{CHECKPOINT_EVERY}: {ranks[0]['losses']}")
    check(all(resumed[k] == legs for k in ("fused_ce_fwd", "fused_ce_dx",
                                           "fused_ce_dw"))
          and resumed["flash_dq"] == resumed["flash_dkv"] == 12 * legs
          and resumed["flash_fwd"] >= 12 * legs,
          f"checkpoint: the resumed leg did not run B1-B6: {resumed}")
    check(equal, "checkpoint: a tensor, the step or the count changed in a "
                 "save and restore")


def phase_eval(kernels, torch, ckpt_dir: str) -> None:
    """``--mode eval`` through the CLI against an in-process evaluate()
    of the restored state; B1 launched 12 times an eval batch."""
    from tensorflow_distributed_tpu_torch.train.loop import evaluate
    from tensorflow_distributed_tpu_torch.train.step import make_eval_step
    from tensorflow_distributed_tpu_torch.train.tasks import make_task

    argv = EVAL_ARGV + ["--checkpoint-dir", ckpt_dir]
    for kern in kernels:
        kern.launches = 0
    rc, out = run_cli(argv)
    launches = {kern.name: kern.launches for kern in kernels}
    rec = event_record(out, "eval")
    check(rc == 0 and rec is not None,
          f"eval: the CLI exited {rc} without its eval record")
    cfg, _, state = restored(torch, argv)
    task = make_task(cfg)
    batches = task.eval_size // cfg.eval_batch_size
    ref = evaluate(state, make_eval_step(task.eval_loss or task.loss), task,
                   cfg.eval_batch_size, torch.device(cfg.device))
    rel = abs(rec["val_loss"] - ref["loss"]) / abs(ref["loss"])
    tokens = batches * cfg.eval_batch_size * cfg.seq_len
    emit({"phase": "eval", "argv": argv, "record": rec,
          "in_process_loss": ref["loss"], "rel_diff": rel,
          "tolerance": TOL_EVAL, "eval_batches": batches,
          "launches": launches,
          "tokens_per_s": (tokens / rec["eval_seconds"]
                           if rec["eval_seconds"] else None)})
    check(rel <= TOL_EVAL,
          f"eval: the CLI's val_loss {rec['val_loss']} vs {ref['loss']}")
    check(launches["flash_fwd"] == 12 * batches,
          f"eval: the eval did not run B1 12 times a batch: {launches}")


def stream_check(torch, model, prompt, got, ref, what: str):
    """A token stream against ``ref``, the greedy reference: equal, or
    differing first where the top-2 logit gap is under IDENTITY_GAP.
    Returns the excuse (or None)."""
    j = first_mismatch(got, ref)
    if j is None:
        return None
    gap = top2_gap(torch, model, prompt, ref, j)
    check(gap < IDENTITY_GAP, f"{what} differs from generate() at step {j}, "
                              f"where the top-2 logit gap is {gap}")
    return {"step": j, "top2_gap": gap}


def phase_generate(torch, np, ckpt_dir: str) -> None:
    """``--mode generate`` through the CLI in f32: greedy against
    generate() on the restored model, 4 beams, and one beam against
    greedy."""
    from tensorflow_distributed_tpu_torch.models.generate import (
        beam_search, generate)

    rng = np.random.default_rng(2)
    vocab_argv = GENERATE_ARGV + ["--checkpoint-dir", ckpt_dir]
    _, model, state = restored(torch, vocab_argv + ["--prompt", "0"])
    if state.ema is not None:
        model.load_state_dict(state.ema)
    vocab, n = model.cfg.vocab_size, GENERATE_NEW
    prompt = rng.integers(0, vocab, GENERATE_PROMPT_LEN).tolist()
    argv = vocab_argv + ["--prompt", ",".join(map(str, prompt))]
    t0 = time.time()
    rc, out = run_cli(argv)
    greedy_s = time.time() - t0
    greedy = event_record(out, "generate")
    check(rc == 0 and greedy is not None,
          f"generate: the CLI exited {rc} without its record")
    t0 = time.time()
    rc, out = run_cli(argv + ["--num-beams", str(GENERATE_BEAMS)])
    beams_s = time.time() - t0
    beams = event_record(out, "generate")
    check(rc == 0 and beams is not None,
          f"generate: the CLI with {GENERATE_BEAMS} beams exited {rc}")
    x = torch.tensor([prompt], device=DEVICE)
    ref = generate(model, x, n)[0].tolist()
    one = beam_search(model, x, n, num_beams=1)[0][0, 0].tolist()
    excused = {"greedy": stream_check(torch, model, prompt,
                                      greedy["new_tokens"], ref, "generate"),
               "one_beam": stream_check(torch, model, prompt, one, ref,
                                        "beam_search(num_beams=1)")}
    toks = beams["new_tokens"]
    emit({"phase": "generate", "argv": argv[:-2] + ["--prompt", "..."],
          "prompt_len": len(prompt), "new_tokens": n,
          "greedy_identical": greedy["new_tokens"] == ref,
          "one_beam_identical": one == ref, "excused": excused,
          "beams": GENERATE_BEAMS, "beam_score": beams.get("beam_score"),
          "greedy_s": greedy_s, "beams_s": beams_s, "step": greedy["step"]})
    check(len(toks) == n and all(0 <= t < vocab for t in toks),
          f"generate: beam tokens outside the vocabulary or short: {toks}")
    check(math.isfinite(beams.get("beam_score", math.nan)),
          f"generate: beam score {beams.get('beam_score')}")


def phase_serve_checkpoint(torch, ckpt_dir: str) -> None:
    """``--mode serve --checkpoint-dir`` in f32: every stream against
    generate() on the restored weights."""
    from tensorflow_distributed_tpu_torch.models.generate import generate
    from tensorflow_distributed_tpu_torch.serve.run import _workload

    argv = SERVE_CKPT_ARGV + ["--checkpoint-dir", ckpt_dir]
    rc, line, summary, out = serve_cli(argv)
    streams = {}
    for l in out.splitlines():
        if l.startswith("[serve] rid="):
            rid, tok = l.split()[1:3]
            streams.setdefault(int(rid[4:]), []).append(int(tok[4:]))
    cfg, model, state = restored(torch, argv)
    if state.ema is not None:
        model.load_state_dict(state.ema)
    excused = []
    for r in _workload(cfg, cfg.synthetic_vocab or 64):
        x = torch.tensor([r.prompt.tolist()], device=DEVICE)
        ref = generate(model, x, r.max_new_tokens)[0].tolist()
        why = stream_check(torch, model, r.prompt.tolist(),
                           streams.get(r.rid, []), ref,
                           f"serve_checkpoint: request {r.rid}")
        if why:
            excused.append({"rid": r.rid, **why})
    emit({"phase": "serve_checkpoint", "argv": argv, "exit": rc,
          "summary_line": line, "params": summary["params"],
          "requests": summary["requests"],
          "total_new_tokens": summary["total_new_tokens"],
          "identical": summary["requests"] - len(excused),
          "excused": excused})
    check(summary["params"] == "checkpoint",
          f"serve_checkpoint: served {summary['params']} params")


def phase_model_llama(fa, torch, np) -> None:
    """The Llama-style GPT at GPT-2-small's widths (LLAMA_OPTS), batch
    MODEL_LLAMA_B x L MODEL_LLAMA_L, from one seeded param tree: the
    bf16 forward and backward on the card (B1-B3, 12 launches each)
    against the f32 plain path on the CPU, logits and every grad."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm
    from tensorflow_distributed_tpu_torch.ops.losses import (
        masked_softmax_cross_entropy)

    ref_model = gpt_lm("small", compute_dtype=torch.float32,
                       dropout_rate=0.0, **LLAMA_OPTS)
    ref_model.init_weights(torch.Generator().manual_seed(0))
    with torch.device(DEVICE):
        model = gpt_lm("small", compute_dtype=torch.bfloat16,
                       dropout_rate=0.0, **LLAMA_OPTS)
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(2)
    shape = (MODEL_LLAMA_B, MODEL_LLAMA_L)
    vocab = ref_model.cfg.vocab_size
    tokens = torch.from_numpy(rng.integers(0, vocab, size=shape))
    targets = torch.from_numpy(rng.integers(0, vocab, size=shape))
    mask = torch.ones(shape)

    def run(m, dev):
        logits = m(tokens.to(dev))
        loss = masked_softmax_cross_entropy(logits, targets.to(dev),
                                            mask.to(dev))
        loss.backward()
        return logits.detach().cpu(), {n: p.grad.cpu()
                                       for n, p in m.named_parameters()}

    t0 = time.time()
    ref_logits, ref_grads = run(ref_model, "cpu")
    cpu_s = time.time() - t0
    before = [kern.launches for kern in fa.KERNELS]
    logits, grads = run(model, DEVICE)
    sync(torch)
    launched = [kern.launches - b for kern, b in zip(fa.KERNELS, before)]
    logit_err = float((logits.float() - ref_logits).abs().max()
                      / ref_logits.abs().max())
    grad_errs = {n: float((grads[n] - g).abs().max() / g.abs().max())
                 for n, g in ref_grads.items() if float(g.abs().max()) > 0}
    worst = max(grad_errs, key=grad_errs.get)
    emit({"phase": "model_llama", "opts": LLAMA_OPTS, "batch": shape[0],
          "seq_len": shape[1], "params": sum(
              p.numel() for p in model.parameters()),
          "logits_rel_err": logit_err, "grads_rel_err": grad_errs[worst],
          "worst_grad": worst, "kernel_launches": launched,
          "tolerance": TOL_MODEL, "cpu_reference_s": round(cpu_s, 3)})
    n = model.cfg.n_layers
    check(launched == [n, n, n],
          f"model_llama: B1-B3 did not run once a layer: {launched}")
    check(logit_err <= TOL_MODEL and grad_errs[worst] <= TOL_MODEL,
          f"model_llama on the card disagrees with the plain path: logits "
          f"{logit_err}, grads {grad_errs[worst]} ({worst})")


def phase_train_llama(kernels, torch, fused):
    """train_fused's run with the Llama-style options: B2 and B3 12 times
    a step, B1 at least 12, each CE kernel once a step, no ring kernel;
    its tokens/s, step ms and peak memory beside train_fused's."""
    rec = run_train(kernels, torch, "train_llama", TRAIN_LLAMA_ARGV,
                    {"train_fused": fused})
    steps, t = rec["steps"], rec["train_launches"]
    n = 12 * steps
    check(t["flash_dq"] == n and t["flash_dkv"] == n
          and t["flash_fwd"] >= n,
          f"train_llama: the RoPE/GQA steps did not run B1-B3 once a layer "
          f"a step: {t}")
    check(all(t[k] == steps for k in CE_KERNELS),
          f"train_llama: a CE kernel did not launch once a step: {t}")
    check(all(rec["launches"][k] == 0 for k in RING_KERNELS),
          f"train_llama: a ring kernel launched: {rec['launches']}")
    return rec


def with_flags(argv, **flags):
    """``argv`` with each ``--flag value`` of ``flags`` (underscores as
    dashes) replaced."""
    out = list(argv)
    for name, value in flags.items():
        out[out.index("--" + name.replace("_", "-")) + 1] = str(value)
    return out


def phase_train_window(kernels, torch):
    """The windowed long-context run under --remat full with Adafactor:
    B2 and B3 12 times a step, B1 at least 24 (forward and recompute),
    a falling loss; then WINDOW_CONTROL_STEPS steps under --remat dots
    (B1 24 a step, B2 12) and as many without remat, which launch B1 12
    times a step and must peak higher than the remat run."""
    rec = run_train(kernels, torch, "train_window", TRAIN_WINDOW_ARGV)
    steps, t = rec["steps"], rec["train_launches"]
    check(t["flash_dq"] == 12 * steps and t["flash_dkv"] == 12 * steps,
          f"train_window: B2/B3 did not run once a layer a step: {t}")
    check(t["flash_fwd"] >= 24 * steps,
          f"train_window: B1 launched {t['flash_fwd']} times in {steps} "
          f"steps, not twice a layer a step (the forward and the "
          f"recompute): the blocks were not recomputed")
    # --remat dots saves the matmuls and recomputes the rest: B1 is a
    # ctypes launch, which the selective-checkpoint policy never sees,
    # so it runs again in the recompute (JAX recomputes its pallas_call).
    dots = run_train(kernels, torch, "train_window_dots", with_flags(
        TRAIN_WINDOW_ARGV, remat="dots", train_steps=WINDOW_CONTROL_STEPS))
    td = dots["train_launches"]
    check(td["flash_fwd"] == 24 * WINDOW_CONTROL_STEPS
          and td["flash_dq"] == 12 * WINDOW_CONTROL_STEPS,
          f"train_window_dots: B1 {td['flash_fwd']} and B2 {td['flash_dq']} "
          f"launches in {WINDOW_CONTROL_STEPS} steps, not 24 and 12 a step")
    control = run_train(kernels, torch, "train_window_control", with_flags(
        TRAIN_WINDOW_ARGV, remat="none", train_steps=WINDOW_CONTROL_STEPS))
    tc = control["train_launches"]
    check(tc["flash_fwd"] == 12 * WINDOW_CONTROL_STEPS,
          f"train_window_control: B1 launched {tc['flash_fwd']} times in "
          f"{WINDOW_CONTROL_STEPS} steps without remat, not 12 a step")
    saved = control["train_peak_mem_bytes"] - rec["train_peak_mem_bytes"]
    emit({"phase": "train_window_memory",
          "remat_peak_mem_bytes": rec["train_peak_mem_bytes"],
          "dots_peak_mem_bytes": dots["train_peak_mem_bytes"],
          "control_peak_mem_bytes": control["train_peak_mem_bytes"],
          "saved_bytes": saved, "remat_step_ms": rec["step_ms_median"],
          "dots_step_ms": dots["step_ms_median"],
          "control_step_ms": control["step_ms_median"]})
    check(saved > 0,
          f"train_window: remat saved no memory: peak "
          f"{rec['train_peak_mem_bytes']} B against the control's "
          f"{control['train_peak_mem_bytes']} B")
    return rec


def phase_decode_llama(fa, torch, np) -> None:
    decode_phase(fa, torch, np, "decode_llama", LLAMA_OPTS)


def phase_serve_llama(torch, np) -> None:
    serve_identity(torch, np, "serve_llama", LLAMA_OPTS)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        sys.path.insert(0, REPO)
        return rank_entry(argv[1], argv[2:])
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, REPO)
    try:
        from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
        from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce
        from tensorflow_distributed_tpu_torch.parallel import (
            ring_attention as ra)
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS

    gpu = phase_device(torch)
    phase_build(fa, fce)
    flash = phase_kernels(fa, torch, F)
    ce = phase_ce_kernels(fce, torch, F)
    phase_model(fa, torch, np)
    phase_model_fused(fce, torch, np)
    dense = phase_train(kernels, torch)
    fused = phase_train_fused(kernels, torch, dense)
    phase_step_profile(torch)
    partial = phase_ring_kernels(fa, torch, gpu)
    ring_launches = phase_ring(fa, ra, torch, gpu)
    phase_train_ring(torch)
    phase_model_cnn(torch, np)
    phase_train_cnn(kernels, torch)
    phase_train_data(torch)
    phase_decode(fa, torch, np)
    phase_serve_identity(torch, np)
    phase_serve(torch)
    with tempfile.TemporaryDirectory(prefix="tfd_ckpt_") as ckpt_dir:
        phase_checkpoint(kernels, torch, ckpt_dir)
        phase_eval(kernels, torch, ckpt_dir)
        phase_generate(torch, np, ckpt_dir)
        phase_serve_checkpoint(torch, ckpt_dir)
    phase_model_llama(fa, torch, np)
    phase_train_llama(kernels, torch, fused)
    phase_train_window(kernels, torch)
    phase_decode_llama(fa, torch, np)
    phase_serve_llama(torch, np)

    err = {"flash_fwd": flash["errors"]["o_abs_err"],
           "flash_dq": flash["errors"]["dq_abs_err"],
           "flash_dkv": flash["errors"]["dkv_abs_err"],
           "fused_ce_fwd": max(ce["errors"]["ce_abs_err"],
                               ce["errors"]["lse_abs_err"]),
           "fused_ce_dx": ce["errors"]["dx_abs_err"],
           "fused_ce_dw": ce["errors"]["dw_abs_err"],
           "flash_fwd_partial": max(partial["errors"]["o_abs_err"],
                                    partial["errors"]["m_abs_err"],
                                    partial["errors"]["l_abs_err"]),
           "flash_dq_partial": partial["errors"]["dq_abs_err"],
           "flash_dkv_partial": partial["errors"]["dkv_abs_err"]}
    rows = []
    for kern in kernels:
        name = kern.name
        if name.endswith("_partial"):
            res, launched = partial, ring_launches
        elif name.startswith("flash"):
            res, launched = flash, dense["launches"]
        else:
            res, launched = ce, fused["launches"]
        bound_ms, bound_by = res["bounds"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[kern.library],
                     "replaces": REPLACES[name],
                     "launches": launched[name],
                     "max_abs_err": err[name], "ms": res["ms"][name],
                     "plain_ms": res["plain_ms"][name], "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library_ms": res["library_ms"][name]})
    print(gpu, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
