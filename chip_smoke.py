#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device  — the card (nvidia-smi name and power limit), torch, CUDA,
             and whether nvcc and ninja are on the machine;
2. build   — compiles the flash-attention kernels from
             ``tensorflow_distributed_tpu_torch/ops/csrc`` (sm_90a);
3. kernels — each kernel (forward, dQ, dK/dV) against its plain PyTorch
             version computed in f32 from the same bf16 inputs, at
             B=8 H=12 L=1024 D=64 (causal, non-causal, causal + window
             256) and one D=128 case; median times over 20 launches
             (CUDA events) beside the bound, the plain version and
             ``scaled_dot_product_attention`` (forward, fwd+bwd, and
             its flash backward alone) as yardsticks;
4. model   — a small GPT (head dim 64) on the card in bf16 through the
             kernels against the same weights on the CPU in f32;
5. train   — GPT-2-small training through the port's CLI path
             (seq 1024, batch 8, 30 steps, final eval): finite, falling
             loss and every kernel launched by the run.

It then prints the nvidia-smi line, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the port's package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

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
SOURCE = "tensorflow_distributed_tpu_torch/ops/csrc/flash_attention.cu"
TPU_SOURCE = "tensorflow_distributed_tpu/ops/flash_attention.py"
REPLACES = {"flash_fwd": f"{TPU_SOURCE}:183", "flash_dq": f"{TPU_SOURCE}:255",
            "flash_dkv": f"{TPU_SOURCE}:284"}


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


def sdpa_flash_bwd_ms(torch, q4, k4, v4, do4) -> float:
    """Time of the one library call that computes the causal dQ, dK and
    dV together from (q, k, v, out, lse, dO): the backward of PyTorch's
    flash SDPA, on [B, H, L, D] inputs, with its own forward's outputs."""
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    bwd = aten._scaled_dot_product_flash_attention_backward
    return time_ms(torch, lambda: bwd(do4, q4, k4, v4, out, lse, cum_q,
                                      cum_k, max_q, max_k, 0.0, True, seed,
                                      offset))


def phase_device(torch) -> str:
    gpu = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": gpu,
          "cuda_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "ninja": shutil.which("ninja") is not None,
          "nvcc": shutil.which("nvcc")})
    return gpu


def phase_build(fa) -> None:
    t0 = time.time()
    log = fa.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "ptxas": ptxas})


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
            emit({"phase": "timing", **case, "ms": results["ms"],
                  "plain_ms": results["plain_ms"],
                  "sdpa_fwd_ms": sdpa_fwd,
                  "sdpa_fwd_bwd_ms": time_ms(torch, sdpa_fwd_bwd),
                  "sdpa_flash_bwd_ms": sdpa_flash_bwd_ms(torch, q4, k4, v4,
                                                         do4),
                  "flash_dq_plus_dkv_ms": (results["ms"]["flash_dq"]
                                           + results["ms"]["flash_dkv"]),
                  "flash_fwd_bwd_ms": sum(results["ms"].values()),
                  "bound_ms": {k: b[0] for k, b in results["bounds"].items()}})
        del q, k, v, do, out, lse, dq, dk, dv, f, ref_o, ref_lse, ref_dq
        del ref_dk, ref_dv
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


def phase_train(fa, torch):
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    cfg = parse_args(TRAIN_ARGV)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.time()
    result = train(cfg, logger=MetricLogger(stream=sys.stderr))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {kern.name: kern.launches for kern in fa.KERNELS}
    records = [r for r in result.logger.records if "loss" in r.metrics]
    losses = [r.metrics["loss"] for r in records]
    times = [r.wall_time for r in records]
    step_s = [b - a for a, b in zip(times, times[1:])][4:]  # steps 6..30
    step_ms = statistics.median(step_s) * 1e3
    tokens = cfg.batch_size * cfg.seq_len
    n_layers, steps = 12, cfg.train_steps
    emit({"phase": "train", "argv": TRAIN_ARGV, "steps": len(losses),
          "first_loss": losses[0], "last5_mean_loss": statistics.mean(
              losses[-5:]),
          "step_ms_median": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "eval": result.final_metrics, "launches": launches,
          "wall_s": round(wall, 3)})
    check(len(losses) == steps, f"expected {steps} loss records")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(statistics.mean(losses[-5:]) < losses[0],
          f"loss did not fall: {losses}")
    check(math.isfinite(result.final_metrics.get("loss", math.nan)),
          "final eval did not run")
    check(launches["flash_dq"] == n_layers * steps
          and launches["flash_dkv"] == n_layers * steps
          and launches["flash_fwd"] >= n_layers * steps,
          f"the run did not go through every kernel: {launches}")
    return launches


def main() -> int:
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
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = phase_device(torch)
    phase_build(fa)
    kern = phase_kernels(fa, torch, F)
    phase_model(fa, torch, np)
    launches = phase_train(fa, torch)

    rows = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        err = kern["errors"]
        max_abs = {"flash_fwd": err["o_abs_err"],
                   "flash_dq": err["dq_abs_err"],
                   "flash_dkv": err["dkv_abs_err"]}[name]
        bound_ms, bound_by = kern["bounds"][name]
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": max_abs, "ms": kern["ms"][name],
                     "plain_ms": kern["plain_ms"][name], "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library_ms": kern["library_ms"][name]})
    print(gpu, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
