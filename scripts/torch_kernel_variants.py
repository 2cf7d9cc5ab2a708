#!/usr/bin/env python3
"""Tile variants of the port's Hopper dQ (B2) and fused-CE forward (B4)
kernels, built side by side, held to their plain versions and timed in
turns on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 scripts/torch_kernel_variants.py

Each variant is a copy of ``ops/csrc/<library>.cu`` with one of its
tile constants changed, built by nvcc into ``build/variants/``:

- B2 (``flash_dq_hopper``): ``CONSUMERS`` 1 or 2 (64 or 128 query rows
  a CTA) x ``BN`` 64 or 128 (keys a stage); checked against
  ``flash_dq_reference`` (max abs error / max |reference| <= 2e-2, as
  chip_smoke.py), then timed at GPT-2-small's causal attention (B*H 96,
  L 1024, D 64), non-causal, causal + window 256, and D 128 (B*H 16);
- B4 (``fused_ce_fwd_hopper``): ``STAGES`` 4 or 5; checked against
  ``fused_ce_fwd_reference`` (ce and lse <= 1e-3), timed at GPT-2-small's
  head (T 8192, D 768, V 50257, bias, eps 0.1).

Times are device times from torch.profiler (ms a call over 20 calls),
three rounds with the variants' order reversed every other round. Each
line printed is one JSON object; the first is the card's nvidia-smi name
and power limit. The port itself is untouched: each variant's library
is bound in place of the built one only while it is measured.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tensorflow_distributed_tpu_torch", "ops", "csrc")
OUT = os.path.join(REPO, "build", "variants")
ROUNDS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def variant_sources():
    """{tag: (library, source text)}: the shipped constants replaced."""
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        flash = f.read()
    with open(os.path.join(CSRC, "fused_ce.cu")) as f:
        ce = f.read()
    hdq = flash.index("namespace hdq {")
    out = {}
    for consumers in (1, 2):
        for bn in (64, 128):
            body = flash[hdq:]
            for name, value in (("BN", bn), ("CONSUMERS", consumers)):
                old = next(ln for ln in body.splitlines()
                           if ln.startswith(f"constexpr int {name} = "))
                body = body.replace(old, f"constexpr int {name} = {value};", 1)
            out[f"dq_bm{64 * consumers}_bn{bn}"] = ("flash_attention",
                                                    flash[:hdq] + body)
    hfw = ce.index("namespace hfw {")
    for stages in (4, 5):
        body = ce[hfw:]
        old = next(ln for ln in body.splitlines()
                   if ln.startswith("constexpr int STAGES = "))
        out[f"ce_stages{stages}"] = (
            "fused_ce", ce[:hfw] + body.replace(
                old, f"constexpr int STAGES = {stages};", 1))
    return out


def build(tag, text, cuda_ext):
    src = os.path.join(OUT, f"{tag}.cu")
    lib = os.path.join(OUT, f"lib{tag}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([cuda_ext.nvcc_path(), *cuda_ext.NVCC_FLAGS,
                           "-I", CSRC, "-o", lib, src],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{log}")
    return lib, log


def device_ms(torch, fn, iters=20):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        total += getattr(e, "self_cuda_time_total", 0) if us is None else us
    return total / iters / 1e3


def bind(kern, lib):
    fn = getattr(ctypes.CDLL(lib), f"tfd_{kern.name}")
    fn.argtypes = kern._argtypes
    fn.restype = ctypes.c_int
    kern._fn = fn


def in_turns(tags, measure):
    """{tag: [one measurement a round]}, the order reversed each round."""
    got = {t: [] for t in tags}
    for r in range(ROUNDS):
        for tag in (tags if r % 2 == 0 else tags[::-1]):
            got[tag].append(measure(tag))
    return got


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tensorflow_distributed_tpu_torch.ops import cuda_ext
    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce

    emit({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()})
    os.makedirs(OUT, exist_ok=True)
    sources = variant_sources()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(
            lambda tag: build(tag, sources[tag][1], cuda_ext), sources)))
    for tag, (_, log) in built.items():
        emit({"variant": tag, "ptxas": sorted({
            ln.strip() for ln in log.splitlines()
            if "C75" in ln or "setmaxnreg" in ln
            or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads"
                not in ln)})})

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {"causal": (96, 1024, 64, True, 0),
             "noncausal": (96, 1024, 64, False, 0),
             "window256": (96, 1024, 64, True, 256),
             "D128": (16, 1024, 128, True, 0)}
    data = {}
    for name, (BH, L, D, causal, window) in cases.items():
        q, k, v, do = (torch.randn(BH, L, D, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal, window)
        f = [t.float() for t in (q, k, v, out, do)]
        ref = fa.flash_dq_reference(*f[:4], lse, f[4], causal, window)
        data[name] = ((q, k, v, out, lse, do, causal, window), ref)
    dq_tags = [t for t in sources if t.startswith("dq_")]
    for tag in dq_tags:
        bind(fa.FLASH_DQ, built[tag][0])
        errs = {}
        for name, (args, ref) in data.items():
            dq = fa.flash_dq(*args)
            torch.cuda.synchronize()
            errs[name] = float((dq.float() - ref).abs().max()
                               / ref.abs().max())
        emit({"variant": tag, "dq_rel_err": errs})
        if max(errs.values()) > 2e-2:
            print(f"{tag} disagrees with the plain version", file=sys.stderr)
            return 1
    for name, (args, _) in data.items():
        def measure(tag):
            bind(fa.FLASH_DQ, built[tag][0])
            return device_ms(torch, lambda: fa.flash_dq(*args))
        emit({"kernel": "flash_dq", "case": name,
              "device_ms": in_turns(dq_tags, measure)})
    fa.FLASH_DQ._fn = None
    del data
    torch.cuda.empty_cache()

    T, D, V = 8192, 768, 50257
    x = torch.randn((T, D), generator=g, device="cuda").to(torch.bfloat16)
    w = (0.05 * torch.randn((V, D), generator=g, device="cuda")).to(
        torch.bfloat16)
    b = 0.1 * torch.randn(V, generator=g, device="cuda")
    t = torch.randint(0, V, (T,), generator=g, device="cuda",
                      dtype=torch.int32)
    ref_ce, _, ref_lse = fce.fused_ce_fwd_reference(x, w, b, t, V, 0.1)
    ce_tags = [t_ for t_ in sources if t_.startswith("ce_")]
    for tag in ce_tags:
        bind(fce.FUSED_CE_FWD, built[tag][0])
        ce, _, lse = fce.fused_ce_fwd(x, w, b, t, V, 0.1)
        torch.cuda.synchronize()
        err = max(float((ce - ref_ce).abs().max()),
                  float((lse - ref_lse).abs().max()))
        emit({"variant": tag, "ce_lse_abs_err": err})
        if err > 1e-3:
            print(f"{tag} disagrees with the plain version", file=sys.stderr)
            return 1

    def measure_ce(tag):
        bind(fce.FUSED_CE_FWD, built[tag][0])
        return device_ms(torch, lambda: fce.fused_ce_fwd(x, w, b, t, V, 0.1),
                         10)
    emit({"kernel": "fused_ce_fwd", "case": "T8192_D768_V50257",
          "device_ms": in_turns(ce_tags, measure_ce)})
    fce.FUSED_CE_FWD._fn = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
