#!/usr/bin/env python3
"""The phases of ``chip_smoke.py`` that span cards, alone, on every card
of the machine: the kernel build, then ``train_ring`` (GPT-2-small under
``--mesh.seq S``, S = 4 with four cards, else 2) and ``train_data``
(the CNN and GPT-2-small under ``--mesh.data N``, N = min(cards, 4),
and on four cards GPT-2-small at ``--mesh.data 2 --mesh.seq 2``), each
torchrun held to a one-card run of the same global batch.

Run from the repository root on a machine with two or more CUDA GPUs:

    python3 scripts/torch_multicard.py

Prints the phases' JSON lines (as chip_smoke.py does) and, last, the
card's nvidia-smi name and power limit; exits non-zero on a failed check
or without a GPU.
"""

from __future__ import annotations

import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this needs GPUs")
    sys.path.insert(0, REPO)
    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = smoke.phase_device(torch)
    smoke.phase_build(fa, fce)
    smoke.phase_train_ring(torch)
    smoke.phase_train_data(torch)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
