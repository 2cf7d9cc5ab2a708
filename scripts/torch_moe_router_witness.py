"""Do the port's MoE routers follow JAX's at GPT-2-small's width?

A witness for ROADMAP.md C6 (not a test): JAX's ``train()`` and the
port's, on the CPU in f32, train ``moe_lm`` at the MoE cell's width (d
768, 12 heads, d_ff 3072, E 8, top-2, capacity 1.25, Adam 1e-3, the
model vocabulary 50257 over the 64-token synthetic stream, as
``chip_smoke.py``'s ``train_moe``) from JAX's init, with fewer layers, a
short sequence and a small batch so that it runs on a CPU, and dropout
0 (the two packages draw different masks). It prints, for every step,
both packages' ``dropped_frac`` and load balance (``aux_loss``) and
their differences, then a JSON summary line.

    python scripts/torch_moe_router_witness.py [--layers 2] [--steps 20]
        [--seq-len 64] [--batch-size 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _metrics(logger, key):
    return [r.metrics[key] for r in logger.records if key in r.metrics]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    args = ap.parse_args(argv)

    import jax
    from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
    from tensorflow_distributed_tpu.models import transformer as jtf
    from tensorflow_distributed_tpu.parallel import make_mesh
    from tensorflow_distributed_tpu.train import loop as jloop
    from tensorflow_distributed_tpu.train.tasks import make_task
    from tensorflow_distributed_tpu.utils.logging import (
        MetricLogger as JaxLogger)
    from tensorflow_distributed_tpu_torch import interop
    from tensorflow_distributed_tpu_torch.config import TrainConfig
    from tensorflow_distributed_tpu_torch.models import transformer as ttf
    from tensorflow_distributed_tpu_torch.train import loop as tloop
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    # GPT-2-small's width at fewer layers, in both packages' presets.
    for sizes in (jtf.GPT2_SIZES, ttf.GPT2_SIZES):
        sizes["small"] = dict(sizes["small"], n_layers=args.layers)
    fields = dict(model="moe_lm", model_size="small", moe_experts=8,
                  moe_top_k=2, moe_capacity_factor=1.25,
                  learning_rate=1e-3, seq_len=args.seq_len,
                  batch_size=args.batch_size, train_steps=args.steps,
                  eval_every=0, log_every=1, eval_batch_size=8,
                  compute_dtype="float32", dropout_rate=0.0, seed=0)
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             make_task(jcfg, mesh))
    init = interop.params_from_flax(jax.device_get(jstate.params))
    res = tloop.train(TrainConfig(**fields, device="cpu"),
                      logger=MetricLogger(enabled=False), init_params=init)
    rows = {k: (_metrics(jres.logger, k), _metrics(res.logger, k))
            for k in ("loss", "aux_loss", "dropped_frac")}
    print(f"{'step':>4} {'jax dropped':>12} {'port dropped':>12} "
          f"{'jax lb':>9} {'port lb':>9} {'jax loss':>9} {'port loss':>9}")
    for i in range(args.steps):
        print(f"{i + 1:>4} {rows['dropped_frac'][0][i]:>12.6f} "
              f"{rows['dropped_frac'][1][i]:>12.6f} "
              f"{rows['aux_loss'][0][i]:>9.6f} {rows['aux_loss'][1][i]:>9.6f} "
              f"{rows['loss'][0][i]:>9.5f} {rows['loss'][1][i]:>9.5f}")
    summary = {"layers": args.layers, "steps": args.steps,
               "seq_len": args.seq_len, "batch_size": args.batch_size}
    for k, (j, t) in rows.items():
        summary[f"max_abs_diff_{k}"] = max(abs(a - b) for a, b in zip(j, t))
        summary[f"jax_{k}_last"] = j[-1]
        summary[f"port_{k}_last"] = t[-1]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
