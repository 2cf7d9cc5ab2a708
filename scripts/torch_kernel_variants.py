#!/usr/bin/env python3
"""Tile variants of the port's Hopper kernels, built side by side, held
to their plain versions and timed in turns on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 scripts/torch_kernel_variants.py [group ...]

Each variant is a copy of ``ops/csrc/<library>.cu`` with tile constants
of one kernel changed, built by nvcc into ``build/variants/``. The
groups (all of them without arguments):

- ``dq``: B2 (``flash_dq_hopper<D, false>``), ``CONSUMERS`` 1 or 2 (64
  or 128 query rows a CTA) x ``BN`` 64 or 128 (keys a stage); checked
  against ``flash_dq_reference``, then timed at GPT-2-small's causal
  attention (B*H 96, L 1024, D 64), non-causal, causal + window 256, and
  D 128 (B*H 16);
- ``fwd_partial``: B7 (``flash_fwd_hopper<D, true>``),
  ``PARTIAL_CONSUMERS`` 1 or 2 (64 or 128 query rows a CTA) x
  ``PARTIAL_BN`` 64 or 128 (keys a stage); checked against
  ``flash_fwd_partial_reference`` (o relative, m and l <= 1e-3 absolute),
  timed at the ring's half-blocks (chip_smoke.py's RING_KERNEL_CASES:
  B*H 96 with 128 x 128 and B*H 32 with 512 x 512, full and causal,
  D 64);
- ``dq_partial``: B8 (``flash_dq_hopper<D, true>``), the same choices
  (``PARTIAL_CONSUMERS``, ``PARTIAL_BN``); checked against
  ``flash_dq_partial_reference``, timed at the same half-blocks;
- ``dkv_partial``: B9 (``flash_dkv_hopper<D, true>``),
  ``PARTIAL_CONSUMERS`` 1 or 2 (64 or 128 keys a CTA) x ``PARTIAL_BM``
  64 or 128 (query rows a stage); checked against
  ``flash_dkv_partial_reference``, timed at the same half-blocks;
- ``ce``: B4 (``fused_ce_fwd_hopper``), ``STAGES`` 4 or 5; checked
  against ``fused_ce_fwd_reference`` (ce and lse <= 1e-3), timed at
  GPT-2-small's head (T 8192, D 768, V 50257, bias, eps 0.1).

The attention variants are checked at max abs error / max |reference|
<= 2e-2 (B7's m and l at max abs error <= 1e-3), as chip_smoke.py.
Times are device times from torch.profiler (ms a call over 20 calls),
three rounds with the variants' order reversed every other round. Each
line printed is one JSON object; the first is the card's nvidia-smi
name and power limit, then each variant's ptxas spill, setmaxnreg and
C75xx lines. The port itself is untouched: each variant's library is
bound in place of the built one only while it is measured.
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
GROUPS = ("dq", "fwd_partial", "dq_partial", "dkv_partial", "ce")
TOL_REL = 2e-2
TOL_STATS = 1e-3  # B7's m and l, max abs error
# The ring's half-blocks (chip_smoke.py RING_KERNEL_CASES, D 64):
# name -> (B*H, rows, causal).
RING_CASES = {"rows128_full": (96, 128, False), "rows128_causal": (96, 128, True),
              "rows512_full": (32, 512, False), "rows512_causal": (32, 512, True)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def with_constants(text: str, namespace: str, values) -> str:
    """``text`` with the first ``constexpr int NAME = ...;`` line after
    ``namespace <namespace> {`` replaced, for each NAME in ``values``."""
    start = text.index(f"namespace {namespace} {{")
    body = text[start:]
    for name, value in values.items():
        old = next(ln for ln in body.splitlines()
                   if ln.startswith(f"constexpr int {name} = "))
        body = body.replace(old, f"constexpr int {name} = {value};", 1)
    return text[:start] + body


def variant_sources(groups):
    """{tag: (library, source text)}: the shipped constants replaced."""
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        flash = f.read()
    with open(os.path.join(CSRC, "fused_ce.cu")) as f:
        ce = f.read()
    out = {}
    for consumers in (1, 2):
        for tile in (64, 128):
            if "dq" in groups:
                out[f"dq_bm{64 * consumers}_bn{tile}"] = (
                    "flash_attention", with_constants(
                        flash, "hdq", {"BN": tile, "CONSUMERS": consumers}))
            if "fwd_partial" in groups:
                out[f"fwd_partial_bm{64 * consumers}_bn{tile}"] = (
                    "flash_attention", with_constants(
                        flash, "hfwd", {"PARTIAL_BN": tile,
                                        "PARTIAL_CONSUMERS": consumers}))
            if "dq_partial" in groups:
                out[f"dq_partial_bm{64 * consumers}_bn{tile}"] = (
                    "flash_attention", with_constants(
                        flash, "hdq", {"PARTIAL_BN": tile,
                                       "PARTIAL_CONSUMERS": consumers}))
            if "dkv_partial" in groups:
                out[f"dkv_partial_bn{64 * consumers}_bm{tile}"] = (
                    "flash_attention", with_constants(
                        flash, "hdkv", {"PARTIAL_BM": tile,
                                        "PARTIAL_CONSUMERS": consumers}))
    if "ce" in groups:
        for stages in (4, 5):
            out[f"ce_stages{stages}"] = ("fused_ce", with_constants(
                ce, "hfw", {"STAGES": stages}))
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


def compare(torch, kern, tags, built, cases, tols=None) -> bool:
    """Each variant of ``kern`` against the plain version on every case
    ({name: (call, refs)}: ``call()`` returns the kernel's outputs in the
    order of ``refs``), then the device times in turns, case by case.
    ``tols``: (limit, relative) for each output; by default each at
    TOL_REL of max |reference|. False when a variant disagrees."""
    for tag in tags:
        bind(kern, built[tag][0])
        errs, ok = {}, True
        for name, (call, refs) in cases.items():
            got = call()
            torch.cuda.synchronize()
            errs[name] = []
            for g, r, (limit, rel) in zip(got, refs,
                                          tols or [(TOL_REL, True)] * len(refs)):
                err = float((g.float() - r).abs().max())
                errs[name].append(err / float(r.abs().max()) if rel else err)
                ok = ok and errs[name][-1] <= limit
        emit({"variant": tag, "kernel": kern.name,
              "rel_err" if tols is None else "err": errs})
        if not ok:
            print(f"{tag} disagrees with the plain version", file=sys.stderr)
            return False
    for name, (call, _) in cases.items():
        def measure(tag):
            bind(kern, built[tag][0])
            return device_ms(torch, call)
        emit({"kernel": kern.name, "case": name,
              "device_ms": in_turns(tags, measure)})
    kern._fn = None
    return True


def flash_dq_cases(torch, fa, g):
    cases = {}
    for name, (BH, L, D, causal, window) in {
            "causal": (96, 1024, 64, True, 0),
            "noncausal": (96, 1024, 64, False, 0),
            "window256": (96, 1024, 64, True, 256),
            "D128": (16, 1024, 128, True, 0)}.items():
        q, k, v, do = (torch.randn(BH, L, D, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal, window)
        f = [t.float() for t in (q, k, v, out, do)]
        ref = fa.flash_dq_reference(*f[:4], lse, f[4], causal, window)
        args = (q, k, v, out, lse, do, causal, window)
        cases[name] = ((lambda a=args: (fa.flash_dq(*a),)), (ref,))
    return cases


def ring_cases(torch, fa, g, kernel):
    """The partial forward (``kernel`` "fwd"), dQ ("dq") or dK/dV
    ("dkv") at the ring's half-blocks, m from the partial forward."""
    cases = {}
    for name, (BH, n, causal) in RING_CASES.items():
        q, k, v = (torch.randn(BH, n, 64, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        do = torch.randn(BH, n, 64, generator=g, device="cuda")
        dl = torch.randn(BH, n, generator=g, device="cuda")
        _, m, _ = fa.flash_fwd_partial(q, k, v, causal)
        f = [t.float() for t in (q, k, v)]
        args = (q, k, v, m, do, dl, causal)
        if kernel == "fwd":
            refs = fa.flash_fwd_partial_reference(*f, causal)
            call = (lambda a=(q, k, v, causal): fa.flash_fwd_partial(*a))
        elif kernel == "dq":
            refs = (fa.flash_dq_partial_reference(*f, m, do, dl, causal),)
            call = (lambda a=args: (fa.flash_dq_partial(*a),))
        else:
            refs = fa.flash_dkv_partial_reference(*f, m, do, dl, causal)
            call = (lambda a=args: fa.flash_dkv_partial(*a))
        cases[name] = (call, refs)
    return cases


def main(argv=None) -> int:
    groups = sys.argv[1:] if argv is None else argv
    groups = groups or list(GROUPS)
    unknown = sorted(set(groups) - set(GROUPS))
    if unknown:
        print(f"torch_kernel_variants: unknown group(s) {unknown}; "
              f"choose from {list(GROUPS)}", file=sys.stderr)
        return 2
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
    sources = variant_sources(groups)
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
    for group, kern, make, tols in (
            ("dq", fa.FLASH_DQ, lambda: flash_dq_cases(torch, fa, g), None),
            ("fwd_partial", fa.FLASH_FWD_PARTIAL,
             lambda: ring_cases(torch, fa, g, "fwd"),
             [(TOL_REL, True), (TOL_STATS, False), (TOL_STATS, False)]),
            ("dq_partial", fa.FLASH_DQ_PARTIAL,
             lambda: ring_cases(torch, fa, g, "dq"), None),
            ("dkv_partial", fa.FLASH_DKV_PARTIAL,
             lambda: ring_cases(torch, fa, g, "dkv"), None)):
        if group not in groups:
            continue
        tags = [t for t in sources if t.startswith(f"{group}_b")]
        if not compare(torch, kern, tags, built, make(), tols):
            return 1
        torch.cuda.empty_cache()
    if "ce" not in groups:
        return 0

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
