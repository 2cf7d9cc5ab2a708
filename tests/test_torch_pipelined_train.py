"""PyTorch port: ``pipelined_lm`` through ``train()``, checkpoints and
``--mode eval``, against the JAX package on the CPU.

From JAX's init, a tiny ``pipelined_lm`` (4 layers, seq 16, 16 rows, 4
microbatches, f32) trains 5 steps over a gloo world of data 2 x pipe 2
(4 processes; ``spawn_ranks`` under its deadline) and 4 steps over pipe
2: the losses and the final eval follow JAX ``train()``'s 1F1B on data 4
x pipe 2 to 1e-4, and equal the stacked transport's (every stage in one
process) within 1e-6; the port's own GPipe stays within 1e-5 of its
1F1B. A save at step 2 under pipe 2 is, byte for byte, what JAX writes
of the same state after restoring it; a resume from it continues as the
straight run; it restores into the stacked transport's pipe 2 and is
refused at another stage count (JAX cannot restack it either); ``--mode eval`` of the
final save equals JAX's ``evaluate_only`` of it. Adafactor over pipe 2,
whose block RMS runs over JAX's stacked leaf (every layer, both stages),
follows JAX's 3 steps to 1e-4, equals the stacked transport's within
1e-6, and saves JAX's bytes (one placeholder a stacked leaf).
"""

import os
import shutil

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import checkpoint as jckpt
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import MetricLogger as JaxLogger
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import MeshConfig, TrainConfig
from tensorflow_distributed_tpu_torch.data.prefetch import to_device
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from torch_ring_workers import pipe_runs, spawn_ranks
from torch_threads import _one_thread  # noqa: F401

PIPE = dict(model="pipelined_lm", model_size="tiny", seq_len=16,
            batch_size=16, train_steps=5, eval_every=0, log_every=1,
            eval_batch_size=16, compute_dtype="float32", dropout_rate=0.0,
            learning_rate=3e-3, seed=0, pipeline_microbatches=4)
JAX_MESH = dict(data=4, pipe=2)
ADAFACTOR = dict(PIPE, optimizer="adafactor", train_steps=3)
CPU = torch.device("cpu")


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX train() (5 steps) and its init; the port's gloo runs: pipe 2
    (2 steps with a save, a resume to 4, a straight 4, --mode eval of
    the last save) and data 2 x pipe 2 (5 steps)."""
    d = tmp_path_factory.mktemp("pipe")
    jcfg = JaxConfig(**PIPE, mesh=JaxMesh(**JAX_MESH))
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm,
                                             jax_make_task(jcfg, jm))
    tree = nn.meta.unbox(jax.device_get(jstate.params))
    init = interop.params_from_flax(interop.pipelined_to_layers(tree, 2))
    torch.save(init, d / "init.pt")
    ck = str(d / "ck")
    first = dict(PIPE, train_steps=2, checkpoint_dir=ck, checkpoint_every=2)
    pipe2 = {"pipe": 2}
    af = str(d / "af")
    spawn_ranks(pipe_runs, 2, d, [
        ("train", "adafactor", dict(ADAFACTOR, checkpoint_dir=af,
                                    checkpoint_every=3), pipe2,
         d / "init.pt"),
        ("train", "first", first, pipe2, d / "init.pt"),
        ("train", "resumed", dict(first, train_steps=4, resume=True),
         pipe2, None),
        ("train", "straight", dict(PIPE, train_steps=4), pipe2,
         d / "init.pt"),
        ("eval", "eval", dict(PIPE, mode="eval", checkpoint_dir=ck), pipe2,
         None)], d)
    two = [torch.load(d / f"rank{r}.pt") for r in range(2)]
    d4 = d / "d2p2"
    d4.mkdir()
    spawn_ranks(pipe_runs, 4, d4, [
        ("train", "d2p2", PIPE, {"data": 2, "pipe": 2}, d / "init.pt")], d4)
    four = [torch.load(d4 / f"rank{r}.pt")["d2p2"] for r in range(4)]
    return {"jax": jres, "init": init, "ck": ck, "two": two, "four": four,
            "dir": d, "af": af}


def test_train_follows_jax(runs):
    want = _losses(runs["jax"].logger)
    for got in runs["four"]:
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(got["final"][k],
                                       runs["jax"].final_metrics[k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    for rank in runs["two"]:
        np.testing.assert_allclose(rank["straight"]["losses"], want[:4],
                                   rtol=1e-4)
    # A stage's blocks live on its pipe ranks only; the shell on all.
    held = [set(n.split(".")[0] for n in r["local"]) for r in runs["four"]]
    assert held[0] == held[2] == {"tok_emb", "pos_emb", "ln_f", "lm_head",
                                  "layer_0", "layer_1"}
    assert held[1] == held[3] == {"tok_emb", "pos_emb", "ln_f", "lm_head",
                                  "layer_2", "layer_3"}


def _stacked_losses(init, **fields):
    cfg = TrainConfig(**dict(PIPE, **fields), device="cpu",
                      mesh=MeshConfig(pipe=2))
    task, state, step = tloop.build_stacked(cfg, CPU, init_params=init)
    stream = task.train_stream(0)
    losses = []
    for _ in range(cfg.train_steps):
        state, metrics = step(state, to_device(next(stream), CPU))
        losses.append(float(metrics["loss"]))
    return losses, state


def test_gloo_ranks_equal_the_stacked_transport(runs):
    stacked, state = _stacked_losses(runs["init"])
    for got in runs["four"]:
        np.testing.assert_allclose(got["losses"], stacked, rtol=1e-6)
    for name, p in runs["four"][0]["params"].items():
        torch.testing.assert_close(p, state.params[name].detach(),
                                   rtol=1e-4, atol=5e-6)


def test_gpipe_stays_within_1e5_of_1f1b(runs):
    one_f, _ = _stacked_losses(runs["init"])
    gpipe, _ = _stacked_losses(runs["init"], pipeline_schedule="gpipe")
    np.testing.assert_allclose(gpipe, one_f, rtol=1e-5)


def test_save_is_jaxs_bytes_resumes_and_restores(runs, tmp_path):
    ck = runs["ck"]
    copy = str(tmp_path / "at2")
    os.makedirs(copy)
    shutil.copytree(os.path.join(ck, "step_00000002"),
                    os.path.join(copy, "step_00000002"))
    jcfg = JaxConfig(**PIPE, mesh=JaxMesh(**JAX_MESH))
    jm = make_mesh(jcfg.mesh)
    _, template = jloop._build_model_and_state(jcfg, jm,
                                               jax_make_task(jcfg, jm))
    jstate = jckpt.restore(copy, template)
    jckpt.save(str(tmp_path / "jax"), jstate)
    for name in ("state.msgpack", "manifest.json"):
        with open(os.path.join(copy, "step_00000002", name), "rb") as f:
            port_bytes = f.read()
        with open(tmp_path / "jax" / "step_00000002" / name, "rb") as f:
            assert f.read() == port_bytes, name
    for rank in runs["two"]:
        np.testing.assert_allclose(rank["resumed"]["losses"],
                                   rank["straight"]["losses"][2:],
                                   rtol=1e-6)
    # The stacked transport's pipe 2 takes each stage's layers back.
    cfg = TrainConfig(**PIPE, device="cpu", mesh=MeshConfig(pipe=2))
    _, state, _ = tloop.build_stacked(cfg, CPU)
    state = ckpt.restore(copy, state)
    assert state.step == 2
    for name, p in runs["two"][0]["first"]["params"].items():
        assert torch.equal(state.params[name].detach(), p), name
    one = TrainConfig(**PIPE, device="cpu")
    _, single = tloop._build_model_and_state(one, CPU)
    with pytest.raises(ValueError, match="cannot restack it either"):
        ckpt.restore(copy, single)


def test_mode_eval_matches_jax_evaluate_only(runs):
    want = jloop.evaluate_only(
        JaxConfig(**PIPE, mode="eval", checkpoint_dir=runs["ck"],
                  mesh=JaxMesh(**JAX_MESH)), logger=JaxLogger(enabled=False))
    for rank in runs["two"]:
        got = rank["eval"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)


def test_adafactor_follows_jax_and_saves_its_bytes(runs, tmp_path):
    jcfg = JaxConfig(**ADAFACTOR, mesh=JaxMesh(**JAX_MESH))
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    want = _losses(jres.logger)
    stacked, _ = _stacked_losses(runs["init"], optimizer="adafactor",
                                 train_steps=3)
    for rank in runs["two"]:
        got = rank["adafactor"]["losses"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(got, stacked, rtol=1e-6)
    jm = make_mesh(jcfg.mesh)
    _, template = jloop._build_model_and_state(jcfg, jm,
                                               jax_make_task(jcfg, jm))
    jckpt.save(str(tmp_path), jckpt.restore(runs["af"], template))
    for name in ("state.msgpack", "manifest.json"):
        with open(os.path.join(runs["af"], "step_00000003", name),
                  "rb") as f:
            port_bytes = f.read()
        with open(tmp_path / "step_00000003" / name, "rb") as f:
            assert f.read() == port_bytes, name
