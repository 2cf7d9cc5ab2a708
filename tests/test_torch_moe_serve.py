"""PyTorch port: a mixture-of-experts checkpoint through ``--mode eval``,
``--mode generate`` and ``--mode serve`` against the JAX package on the
CPU.

The checkpoint is the JAX package's own: its ``train()`` writes it (2
steps of the tiny ``moe_lm``, EMA on). The port restores it and saves
the JAX bytes again (``state.msgpack`` and ``manifest.json`` byte for
byte); its eval record equals JAX's ``evaluate_only`` to 1e-5 (the
router metrics included); its greedy tokens equal JAX's
``generate_only``'s exactly (decode steps route each token as a group
of one); and the dense engine's streams equal the JAX engine's on the
same requests exactly (the engine prefills at a bucket length, so pad
tokens take capacity in the prefill's routing group: the JAX engine,
not ``generate()``, is the reference).
"""

import json

import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.config import parse_args as jax_parse_args
from tensorflow_distributed_tpu.serve import run as jserve
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu_torch import cli
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401

MOE = dict(model="moe_lm", model_size="tiny", seq_len=32, batch_size=8,
           eval_every=0, log_every=1, eval_batch_size=8,
           compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
           seed=0, ema_decay=0.9, moe_capacity_factor=1.0)
ARGV = ["--model", "moe_lm", "--model-size", "tiny", "--seq-len", "32",
        "--batch-size", "8", "--eval-batch-size", "8", "--compute-dtype",
        "float32", "--ema-decay", "0.9", "--moe-capacity-factor", "1.0"]


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A moe_lm checkpoint written by the JAX package: 2 steps, EMA on."""
    d = str(tmp_path_factory.mktemp("jax_moe_ckpt"))
    jloop.train(JaxConfig(**MOE, train_steps=2, checkpoint_dir=d,
                          checkpoint_every=2),
                logger=MetricLogger(enabled=False))
    assert ckpt.available_steps(d) == [2]
    return d


def _record(out: str, event: str) -> dict:
    return next(json.loads(line) for line in out.splitlines()
                if line.startswith(f'{{"event": "{event}"'))


def test_port_restores_and_saves_the_jax_bytes(jax_ckpt, tmp_path):
    _, state = tloop._build_model_and_state(TrainConfig(**MOE, device="cpu"),
                                            torch.device("cpu"))
    state = ckpt.restore(jax_ckpt, state)
    assert state.step == 2 and state.ema is not None
    assert state.params["layer_1.moe_mlp.wi"].shape == (4, 32, 64)
    ckpt.save(str(tmp_path), state)
    for name in ("state.msgpack", "manifest.json"):
        with open(f"{jax_ckpt}/step_00000002/{name}", "rb") as f:
            assert (tmp_path / "step_00000002" / name).read_bytes() == \
                f.read(), name


def test_cli_eval_and_generate_equal_jax(jax_ckpt, capsys):
    assert cli.main(ARGV + ["--device", "cpu", "--mode", "eval",
                            "--checkpoint-dir", jax_ckpt]) == 0
    got = _record(capsys.readouterr().out, "eval")
    want = jloop.evaluate_only(JaxConfig(**MOE, mode="eval",
                                         checkpoint_dir=jax_ckpt),
                               logger=MetricLogger(enabled=False))
    assert {"aux_loss", "z_loss", "dropped_frac"} <= set(want)
    for k, v in want.items():
        assert abs(got[f"val_{k}"] - v) <= 1e-5 + 5e-6, k  # 5 decimals
    assert cli.main(ARGV + ["--device", "cpu", "--mode", "generate",
                            "--checkpoint-dir", jax_ckpt, "--prompt",
                            "5,9,1,33", "--max-new-tokens", "10"]) == 0
    got = _record(capsys.readouterr().out, "generate")
    want = jloop.generate_only(
        JaxConfig(**MOE, mode="generate", checkpoint_dir=jax_ckpt,
                  prompt="5,9,1,33", max_new_tokens=10),
        logger=MetricLogger(enabled=False))
    assert got["new_tokens"] == want["new_tokens"]
    assert len(got["new_tokens"]) == 10


def _streams(out):
    by_rid = {}
    for line in out.splitlines():
        if line.startswith("[serve] rid="):
            rid, tok = line.split()[1:3]
            by_rid.setdefault(int(rid[4:]), []).append(int(tok[4:]))
    return by_rid


def test_dense_engine_streams_equal_the_jax_engine(jax_ckpt, capsys):
    argv = ARGV + ["--mode", "serve", "--checkpoint-dir", jax_ckpt,
                   "--serve.num-slots", "3", "--serve.num-requests", "6",
                   "--serve.prompt-len-min", "3", "--serve.prompt-len-max",
                   "12", "--serve.max-new-tokens", "8", "--serve.stream",
                   "true"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    summary = _record(out, "serve_summary")
    want = jserve.serve_run(jax_parse_args(argv))
    jout = capsys.readouterr().out
    streams = _streams(out)
    assert sorted(streams) == list(range(6))
    assert streams == _streams(jout)
    for key in ("requests", "total_new_tokens", "decode_steps", "prefills",
                "buckets", "params"):
        assert summary[key] == want[key], key
    assert np.all([len(s) == 8 for s in streams.values()])
