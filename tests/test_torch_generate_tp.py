"""PyTorch port: ``--mode generate --mesh.model 2`` (torchrun over gloo)
against the JAX package's ``--mode generate`` on the CPU.

The checkpoint is the JAX package's own (2 steps of the tiny GPT with
an EMA, written by its ``train()``). Under ``--mesh.model 2`` each rank
restores its heads' slice, decodes over its slice of the cache, and the
ranks pick from the gathered logits, the chief's picks broadcast: the
greedy tokens and beam search's best beam (2 beams) equal JAX's
``generate_only``, and a sampled continuation equals the port's own on
one process (the same seed: the same generator on every rank).
"""

import json
import os
import subprocess
import sys

import pytest

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.utils.logging import MetricLogger
from tensorflow_distributed_tpu_torch import cli
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
            eval_every=0, log_every=1, eval_batch_size=8,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0, ema_decay=0.9)
ARGV = ["--mode", "generate", "--model", "gpt_lm", "--model-size", "tiny",
        "--seq-len", "32", "--batch-size", "8", "--eval-batch-size", "8",
        "--compute-dtype", "float32", "--ema-decay", "0.9", "--device",
        "cpu", "--prompt", "5,9,1,33", "--max-new-tokens", "10"]


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jloop.train(JaxConfig(**TINY, train_steps=2, checkpoint_dir=d,
                          checkpoint_every=2),
                logger=MetricLogger(enabled=False))
    assert ckpt.available_steps(d) == [2]
    return d


def _record(out: str) -> dict:
    return next(json.loads(line) for line in out.splitlines()
                if line.startswith('{"event": "generate"'))


def _torchrun(argv) -> dict:
    """The chief's generate record of ``argv`` over 2 gloo ranks, after
    both ranks exited 0."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tensorflow_distributed_tpu_torch.cli",
         *argv, "--mesh.model", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    records = [line for line in out.stdout.splitlines()
               if line.startswith('{"event": "generate"')]
    assert len(records) == 1, out.stdout  # the chief's alone
    return json.loads(records[0])


@pytest.mark.parametrize("beams", [1, 2])
def test_generate_over_the_model_axis_equals_jax(jax_ckpt, beams):
    got = _torchrun(ARGV + ["--checkpoint-dir", jax_ckpt,
                            "--num-beams", str(beams)])
    want = jloop.generate_only(
        JaxConfig(**TINY, mode="generate", checkpoint_dir=jax_ckpt,
                  prompt="5,9,1,33", max_new_tokens=10, num_beams=beams),
        logger=MetricLogger(enabled=False))
    assert got["step"] == want["step"] == 2
    assert got["new_tokens"] == want["new_tokens"]
    if beams > 1:
        assert abs(got["beam_score"] - want["beam_score"]) <= 1e-5


def test_sampled_generate_over_the_model_axis_equals_one_process(
        jax_ckpt, capsys):
    sample = ARGV + ["--checkpoint-dir", jax_ckpt, "--gen-temperature",
                     "1.0", "--gen-top-k", "20", "--seed", "3"]
    got = _torchrun(sample)
    assert cli.main(sample) == 0
    assert got == _record(capsys.readouterr().out)
