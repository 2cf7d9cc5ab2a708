#!/usr/bin/env python3
"""What the coordinated preemption stop costs a training run of four
processes, on four NVIDIA GPUs.

Run from the repository root on a machine with four CUDA GPUs and nvcc:

    python3 scripts/torch_preempt_guard_cost.py [LABEL=CHECKOUT ...]

Each ``LABEL=CHECKOUT`` names a checkout of the repository whose kernel
sources are this one's (default: ``this=.``); list one several times to
alternate, as ``parent=P this=. this=. parent=P``. The kernels are built
once here and the libraries copied into each other checkout's build
directory. Then, for each checkout in the order given, torchrun runs its
CLI on four processes: GPT-2-small, seq 1024, global batch 8, bf16,
``--mesh.data 4``, STEPS steps, a loss fetch every LOG_EVERY steps, with
a ``--checkpoint-dir`` (the preemption guard is armed; every multi-
process run with one takes the guard's host agreement once a step) and
no save inside the timed steps. Each run prints one JSON line: the
chief's steps/s and tokens/s over the steps after the first (its
``done`` record), the median ms a step between its step records, and
the run's wall seconds. The first line is the cards' nvidia-smi names
and power limits.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 4
STEPS = 60
LOG_EVERY = 10
ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size", "small",
        "--seq-len", "1024", "--batch-size", "8", "--eval-every", "0",
        "--eval-batch-size", "8", "--dropout-rate", "0",
        "--compute-dtype", "bfloat16", "--mesh.data", str(NPROC),
        "--train-steps", str(STEPS), "--log-every", str(LOG_EVERY),
        "--checkpoint-every", str(10 * STEPS)]
STEP_LINE = re.compile(r"^\[step\s+(\d+)\] t=\s*([0-9.]+)s")


def run(label: str, checkout: str, cs) -> dict:
    """One torchrun of ``checkout``'s CLI: its JSON line's fields."""
    with tempfile.TemporaryDirectory(prefix="tfd_guard_cost_") as ckpt:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(NPROC), "-m",
               "tensorflow_distributed_tpu_torch.cli", *ARGV,
               "--checkpoint-dir", ckpt]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=checkout, capture_output=True,
                              text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=checkout))
        wall = time.time() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        cs.fail(f"{label}: torchrun exited {proc.returncode}")
    done = next(json.loads(line) for line in proc.stdout.splitlines()
                if line.startswith('{"event": "done"'))
    marks = [(int(m[1]), float(m[2])) for m in map(
        STEP_LINE.match, proc.stdout.splitlines()) if m]
    step_ms = [1e3 * (t1 - t0) / (s1 - s0) for (s0, t0), (s1, t1)
               in zip(marks, marks[1:]) if s0 >= LOG_EVERY]
    return {"script": "torch_preempt_guard_cost", "run": label,
            "checkout": checkout, "steps": done["steps"],
            "steps_per_sec": done["steps_per_sec"],
            "tokens_per_sec": done["tokens_per_sec"],
            "step_ms_median": (statistics.median(step_ms) if step_ms
                               else None),
            "wall_s": round(wall, 3)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if torch.cuda.device_count() < NPROC:
        cs.fail(f"needs {NPROC} CUDA devices, have "
                f"{torch.cuda.device_count()}")
    runs = [a.split("=", 1) for a in argv] or [["this", "."]]
    sys.path.insert(0, REPO)
    from tensorflow_distributed_tpu_torch.ops import cuda_ext
    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce

    print(cs.nvidia_smi_line(), flush=True)
    cs.phase_build(fa, fce)
    for checkout in {os.path.abspath(c) for _, c in runs}:
        dest = os.path.join(checkout, "build", "torch_ext")
        if os.path.abspath(dest) != os.path.abspath(str(cuda_ext.BUILD_DIR)):
            os.makedirs(dest, exist_ok=True)
            for lib in cuda_ext.BUILD_DIR.glob("*.so"):
                shutil.copy2(lib, dest)
    for label, checkout in runs:
        cs.emit(run(label, os.path.abspath(checkout), cs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
