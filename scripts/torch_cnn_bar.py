#!/usr/bin/env python3
"""How firmly the reference's job clears ``chip_smoke.py``'s accuracy
bar on one NVIDIA GPU: the bar's run (the committed MNIST fixture, 64
validation rows, batch 64, 50 steps, lr 2e-3) at seeds 0-7, then seed 0
five times as cuDNN picks its kernels and three times with
``torch.backends.cudnn.deterministic``, at the bar's bf16 compute and at
f32 (the JAX package's test dtype).

Run from the repository root on a machine with a CUDA GPU:

    python3 scripts/torch_cnn_bar.py

Prints the card's nvidia-smi name and power limit, then one JSON object
per group: {dtype, group, runs: [[val_accuracy, val_loss], ...]}.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(8)
REPEATS = 5
DETERMINISTIC_REPEATS = 3


def main() -> int:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this needs a GPU")
    sys.path.insert(0, REPO)
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.check_fixture(smoke.FIXTURE_DIR)
    print(smoke.nvidia_smi_line(), flush=True)

    def bar(dtype, seed=0):
        argv = smoke.TRAIN_CNN_ARGV + ["--compute-dtype", dtype, "--seed",
                                       str(seed), "--log-every", "0"]
        m = train(parse_args(argv),
                  logger=MetricLogger(enabled=False)).final_metrics
        return [m["accuracy"], m["loss"]]

    for dtype in ("bfloat16", "float32"):
        groups = {"seeds_0_7": lambda: [bar(dtype, s) for s in SEEDS],
                  "seed_0_repeated": lambda: [bar(dtype)
                                              for _ in range(REPEATS)]}
        for group, runs in groups.items():
            print(json.dumps({"dtype": dtype, "group": group,
                              "runs": runs()}), flush=True)
        torch.backends.cudnn.deterministic = True
        print(json.dumps({"dtype": dtype, "group": "seed_0_deterministic",
                          "runs": [bar(dtype) for _ in range(
                              DETERMINISTIC_REPEATS)]}), flush=True)
        torch.backends.cudnn.deterministic = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
