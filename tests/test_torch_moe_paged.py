"""PyTorch port: the paged engine serving a mixture-of-experts model,
against the JAX package's paged engine on the CPU (ROADMAP.md C7).

The checkpoint is JAX's own (2 steps of the tiny ``moe_lm``, EMA on).
Both CLIs serve the same synthetic workload through ``--serve.paged``
with sessions of two turns: each second turn extends its first turn's
prompt, so the radix prefix cache hits and the engine prefills only the
tail, at an offset, as its own routing group (its pad tokens take
capacity in it, in both packages). Every stream, and the paged engine's
prefix and page counters, equal JAX's exactly.
"""

import json

import pytest

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.config import parse_args as jax_parse_args
from tensorflow_distributed_tpu.serve import run as jserve
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu_torch import cli
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401

MOE = dict(model="moe_lm", model_size="tiny", seq_len=32, batch_size=8,
           eval_every=0, log_every=1, eval_batch_size=8,
           compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
           seed=0, ema_decay=0.9, moe_capacity_factor=1.0)
ARGV = ["--model", "moe_lm", "--model-size", "tiny", "--seq-len", "32",
        "--batch-size", "8", "--eval-batch-size", "8", "--compute-dtype",
        "float32", "--ema-decay", "0.9", "--moe-capacity-factor", "1.0"]
PAGED = ["--mode", "serve", "--serve.num-slots", "2",
         "--serve.num-requests", "6", "--serve.prompt-len-min", "5",
         "--serve.prompt-len-max", "11", "--serve.max-new-tokens", "6",
         "--serve.stream", "true", "--serve.paged", "true",
         "--serve.page-size", "4", "--serve.session-turns", "2"]


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_moe_paged"))
    jloop.train(JaxConfig(**MOE, train_steps=2, checkpoint_dir=d,
                          checkpoint_every=2),
                logger=MetricLogger(enabled=False))
    return d


def _streams(out):
    by_rid = {}
    for line in out.splitlines():
        if line.startswith("[serve] rid="):
            rid, tok = line.split()[1:3]
            by_rid.setdefault(int(rid[4:]), []).append(int(tok[4:]))
    return by_rid


def _paged_line(out):
    return next(line for line in out.splitlines()
                if line.startswith("[serve] paged:"))


def test_paged_engine_streams_equal_the_jax_paged_engine(jax_ckpt, capsys):
    argv = ARGV + PAGED + ["--checkpoint-dir", jax_ckpt]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = jserve.serve_run(jax_parse_args(argv))
    jout = capsys.readouterr().out
    streams = _streams(out)
    assert sorted(streams) == list(range(6))
    assert all(len(s) == 6 for s in streams.values())
    assert streams == _streams(jout)
    # The second turns hit the radix cache: their tails prefill at an
    # offset.
    paged = _paged_line(out)
    assert paged == _paged_line(jout)
    summary = next(json.loads(line) for line in out.splitlines()
                   if line.startswith('{"event": "serve_summary"'))
    assert summary["prefix_hits"] > 0
    for key in ("requests", "total_new_tokens", "decode_steps", "prefills",
                "prefix_hits"):
        assert summary[key] == want[key], key
