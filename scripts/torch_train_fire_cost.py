#!/usr/bin/env python3
"""What the train loop's per-step readers cost, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 scripts/torch_train_fire_cost.py

GPT-2-small on the fused-CE kernels (``chip_smoke.py``'s train_fire
flags, 40 steps a run), in one process after one build:

- ``plain`` and ``all`` (every reader: ``--resilience.nonfinite
  skip_batch``, a spike window of 4, data and sync watchdogs of 30 s),
  in turns, REPEATS times each, first with a loss fetch every step
  (``--log-every 1``, as the smoke runs them), then with one every ten
  steps (``--log-every 10``, where nothing else syncs a step);
- each reader alone once at ``--log-every 10``: the data watchdog, the
  sync watchdog, ``halt`` (the window of unretired steps, no verdict
  read) and ``skip_batch`` (the verdict read before each update).

Each run prints one JSON line: the untraced step ms (the median over the
step records' intervals from step 3 on, outside steps 10-21, per step:
steps 31-40 alone at ``--log-every 10``), and from torch.profiler over
the ten steps between the records of steps 10 and 20 (each record ends
in the loss fetch): the step ms, launches, device busy ms and idle share
a step. The first line is the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 3


def main() -> int:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a GPU")
    sys.path.insert(0, REPO)
    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS
    print(cs.nvidia_smi_line(), flush=True)
    cs.phase_build(fa, fce)
    cs.TRAIN_FIRE_PROFILE = (10, 20)
    base = cs.with_flags(cs.TRAIN_FIRE_ARGV, train_steps=40)
    wd = cs.TRAIN_FIRE_WATCH
    readers = {"plain": [], "all": wd,
               "data_watchdog": ["--resilience.data-timeout-s", "30"],
               "sync_watchdog": ["--resilience.sync-timeout-s", "30"],
               "halt": ["--resilience.nonfinite", "halt"],
               "skip_batch": ["--resilience.nonfinite", "skip_batch"]}
    runs = []
    for log_every in (1, 10):
        for rep in range(REPEATS):
            pair = ["plain", "all"] if rep % 2 == 0 else ["all", "plain"]
            runs += [(name, log_every) for name in pair]
    runs += [(name, 10) for name in ("data_watchdog", "sync_watchdog",
                                      "halt", "skip_batch")]
    for name, log_every in runs:
        argv = cs.with_flags(base + readers[name], log_every=log_every)
        rec = cs.fire_train(kernels, torch, argv)
        cs.fire_launch_check(rec, name)
        cs.emit({"script": "torch_train_fire_cost", "run": name,
                 "log_every": log_every,
                 "step_ms": rec["step_ms_median"],
                 **{k: rec.get(k) for k in (
                     "traced_step_ms", "launches_per_step",
                     "device_busy_ms", "device_idle_share")},
                 "final_loss": rec["losses"][-1]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
