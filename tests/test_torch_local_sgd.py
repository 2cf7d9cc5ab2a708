"""PyTorch port: local SGD (``train/local_sgd.py``, ``--param-sync-every
H``), its replica-stacked checkpoint and the averaged restores, against
the JAX package on the CPU.

JAX runs on 4 of its 8 CPU devices (``TFD_DEVICE_MASK=4`` for its
``train()``), the port on ``stacked_data(4)`` (the 4 replicas in one
process) and over a gloo world of 4 processes:

- H = 1 with SGD is the synchronous data-parallel step (JAX's
  ``test_h1_sgd_equals_sync_dp``), and the replicas' step equals JAX's
  ``make_local_sgd_train_step``; at H = 4 the replicas diverge for 3
  steps and are equal to the bit after the 4th, each equal to JAX's
  replica; ``stack_state`` and the config refuse what JAX refuses, with
  its messages.
- A 5-step ``train()`` of the MNIST CNN (synthetic digits) at H 2
  follows JAX's ``train()`` to 1e-4, on the stacked transport and over
  gloo; a tiny ``gpt_lm`` follows local SGD over JAX's own train step, a
  replica at a time (JAX's local-SGD step cannot run a transformer: its
  activation sharding constraints name the data axis inside the
  data-only ``shard_map``).
- The gloo run's save is, byte for byte, what JAX writes of the same
  state after restoring it; ``--mode eval`` of it equals JAX's
  ``evaluate_only`` (its ``restore_averaged`` path), and the port's
  ``restore_averaged`` and ``restore_params`` equal JAX's; a plain
  checkpoint into a stacked template, and the reverse, raise naming
  ``--param-sync-every``.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.parallel.sharding import shard_batch
from tensorflow_distributed_tpu.train import checkpoint as jckpt
from tensorflow_distributed_tpu.train import local_sgd as jlsgd
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train import step as jstep
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import MetricLogger as JaxLogger
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import MeshConfig, TrainConfig
from tensorflow_distributed_tpu_torch.data.prefetch import to_device
from tensorflow_distributed_tpu_torch.parallel.mesh import stacked_data
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.train.local_sgd import (
    averaged_view, make_local_sgd_train_step, stack_state)
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_ring_workers import pipe_runs, spawn_ranks
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
CNN = dict(dataset="synthetic", batch_size=32, train_steps=5, eval_every=0,
           log_every=1, eval_batch_size=32, compute_dtype="float32",
           learning_rate=1e-3, seed=0, param_sync_every=2, dropout_rate=0.0)
GPT = dict(model="gpt_lm", model_size="tiny", dataset="synthetic",
           seq_len=16, batch_size=16, train_steps=5, eval_every=0,
           log_every=1, eval_batch_size=16, compute_dtype="float32",
           dropout_rate=0.0, learning_rate=3e-3, seed=0, param_sync_every=2)
SGD = dict(optimizer="sgd", learning_rate=1e-2,
           train_steps=4)


@pytest.fixture(scope="module")
def four_devices():
    """JAX's train() and evaluate_only() on 4 of the 8 devices."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFD_DEVICE_MASK", "4")
        yield make_mesh(JaxMesh(data=4), jax.devices()[:4])


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _jax_init(jcfg, mesh):
    """JAX's state of ``jcfg`` on ``mesh`` (its train()'s init) and the
    port's params of it."""
    _, state = jloop._build_model_and_state(jcfg, mesh,
                                            jax_make_task(jcfg, mesh))
    return state, interop.params_from_flax(jax.device_get(state.params))


def _stacked(fields, init, steps=None, sync_every=None):
    """The port's local SGD on stacked_data(4) from ``init``: (losses,
    the StackedState, the spread of a leaf over the replicas each
    step). ``sync_every`` overrides H (1 is not local SGD in a config)."""
    cfg = TrainConfig(**fields, device="cpu", mesh=MeshConfig(data=4))
    task, state, step = tloop.build_stacked(cfg, CPU, init_params=init)
    if sync_every is not None:
        step = make_local_sgd_train_step(task.loss, CPU, state.mesh,
                                         sync_every)
    stream = task.train_stream(0)
    losses, spreads = [], []
    for _ in range(steps or cfg.train_steps):
        state, metrics = step(state, to_device(next(stream), CPU))
        losses.append(float(metrics["loss"]))
        leaves = [next(iter(r.params.values())).detach()
                  for r in getattr(state, "replicas", [state])]
        spreads.append(max(float((x - leaves[0]).abs().max())
                           for x in leaves))
    return losses, state, spreads


# --- the step's algebra ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_cnn(four_devices):
    """JAX's train() of the CNN at H 2 (5 steps, a save at step 5) and
    its init."""
    jcfg = JaxConfig(**CNN, mesh=JaxMesh(data=4))
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    _, init = _jax_init(jcfg, four_devices)
    return jres, init


def test_h1_sgd_equals_sync_dp(jax_cnn):
    _, init = jax_cnn
    fields = dict(CNN, **SGD)
    sync, sstate, _ = _stacked(dict(fields, param_sync_every=1), init, 1)
    local, lstate, _ = _stacked(fields, init, 1, sync_every=1)
    np.testing.assert_allclose(local, sync, rtol=1e-6)
    av = averaged_view(lstate)
    for name, p in sstate.params.items():
        torch.testing.assert_close(av.params[name], p.detach(), rtol=0,
                                   atol=1e-6)
    assert av.step == 1


def test_replicas_diverge_then_resync_as_jaxs(jax_cnn, four_devices):
    """H 4 over 4 steps on one batch stream: the replicas differ after
    steps 1-3 and are equal to the bit after step 4, each replica
    equal to JAX's make_local_sgd_train_step's."""
    _, init = jax_cnn
    fields = dict(CNN, **SGD, param_sync_every=4)
    _, state, spreads = _stacked(fields, init)
    assert all(s > 0 for s in spreads[:3]), spreads
    assert spreads[3] == 0.0, spreads
    jcfg = JaxConfig(**fields, mesh=JaxMesh(data=4))
    task = jax_make_task(jcfg, four_devices)
    _, jstate = jloop._build_model_and_state(jcfg, four_devices, task)
    jstate = jlsgd.stack_state(jstate, four_devices)
    step = jlsgd.make_local_sgd_train_step(four_devices, 4, jcfg.seed,
                                           loss=task.loss, donate=False)
    stream = task.train_stream(0)
    for _ in range(4):
        jstate, _ = step(jstate, shard_batch(four_devices, next(stream)))
    want = interop.stack_trees([interop.state_to_flax(r)
                                for r in state.replicas])
    got = jax.device_get(jstate.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        keys = [k.key for k in path]
        mine = want["params"]
        for k in keys:
            mine = mine[k]
        np.testing.assert_allclose(mine, np.asarray(leaf), atol=1e-5,
                                   err_msg="/".join(keys))


def test_stack_state_refuses_extra_and_ema():
    cfg = TrainConfig(model="resnet20", dataset="cifar10_synthetic",
                      device="cpu")
    _, state = tloop._build_model_and_state(cfg, CPU)
    with pytest.raises(ValueError, match="extra state"):
        stack_state(state, stacked_data(2))
    cfg = TrainConfig(**dict(CNN, param_sync_every=1), ema_decay=0.9,
                      device="cpu")
    _, state = tloop._build_model_and_state(cfg, CPU)
    state.ema = {n: p.detach().clone() for n, p in state.params.items()}
    with pytest.raises(ValueError, match="ema"):
        stack_state(state, stacked_data(2))


@pytest.mark.parametrize("kw", [
    dict(param_sync_every=0), dict(param_sync_every=4, mesh=dict(data=4,
                                                                  model=2)),
    dict(param_sync_every=4, param_partition="fsdp"),
    dict(param_sync_every=4, grad_accum_steps=2),
    dict(param_sync_every=4, ema_decay=0.9),
    dict(param_sync_every=4, model="resnet20")])
def test_config_checks_raise_jaxs_message(kw):
    kw = dict(kw)
    mesh = kw.pop("mesh", {})
    with pytest.raises(ValueError) as jerr:
        JaxConfig(batch_size=32, **kw, mesh=JaxMesh(**mesh)).validate()
    with pytest.raises(ValueError) as terr:
        TrainConfig(batch_size=32, **kw, mesh=MeshConfig(**mesh)).validate()
    assert str(terr.value) == str(jerr.value)
    TrainConfig(param_sync_every=4, batch_size=32).validate()


# --- train(), the save and the restores -----------------------------------

@pytest.fixture(scope="module")
def gloo(tmp_path_factory, jax_cnn):
    """Over 4 gloo processes: the CNN's train() at H 2 from JAX's init
    (saving at step 5), --mode eval of the save, and the tiny GPT's
    train() at H 2 from its JAX init."""
    d = tmp_path_factory.mktemp("lsgd")
    _, cnn_init = jax_cnn
    torch.save(cnn_init, d / "cnn.pt")
    jcfg = JaxConfig(**GPT, mesh=JaxMesh(data=4))
    mesh = make_mesh(jcfg.mesh, jax.devices()[:4])
    _, gpt_init = _jax_init(jcfg, mesh)
    torch.save(gpt_init, d / "gpt.pt")
    ck = str(d / "ck")
    data4 = {"data": 4}
    spawn_ranks(pipe_runs, 4, d, [
        ("train", "cnn", dict(CNN, checkpoint_dir=ck, checkpoint_every=5),
         data4, d / "cnn.pt"),
        ("eval", "eval", dict(CNN, mode="eval", checkpoint_dir=ck), data4,
         None),
        ("train", "gpt", GPT, data4, d / "gpt.pt")], d)
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(4)]
    return {"ranks": ranks, "ck": ck, "gpt_init": gpt_init}


def test_cnn_train_follows_jax_stacked_and_over_gloo(jax_cnn, gloo):
    jres, init = jax_cnn
    want = _losses(jres.logger)
    stacked, _, _ = _stacked(CNN, init)
    np.testing.assert_allclose(stacked, want, rtol=1e-4)
    for rank in gloo["ranks"]:
        got = rank["cnn"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        np.testing.assert_allclose(got["losses"], stacked, rtol=1e-6)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(got["final"][k],
                                       jres.final_metrics[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_gpt_follows_jax_replicas_stacked_and_over_gloo(gloo):
    """JAX's local-SGD step cannot run a transformer (its activation
    sharding constraints name the data axis inside the data-only
    shard_map), so the oracle is local SGD's definition over JAX's own
    step: each replica JAX's ``make_train_step`` on one device over its
    rows, the params averaged every H steps, the loss the replicas'
    mean."""
    jcfg = JaxConfig(**GPT, mesh=JaxMesh(data=1))
    one = make_mesh(jcfg.mesh, jax.devices()[:1])
    task = jax_make_task(jcfg, one)
    _, state = jloop._build_model_and_state(jcfg, one, task)
    step = jstep.make_train_step(one, loss=task.loss,
                                 batch_shardings=task.batch_shardings,
                                 donate=False)
    replicas = [state] * 4
    stream = task.train_stream(0)
    want = []
    for i in range(GPT["train_steps"]):
        batch = next(stream)
        losses = []
        for r in range(4):
            rows = {k: v[4 * r:4 * r + 4] for k, v in batch.items()}
            replicas[r], met = step(replicas[r], shard_batch(one, rows))
            losses.append(float(met["loss"]))
        want.append(float(np.mean(losses)))
        if (i + 1) % GPT["param_sync_every"] == 0:
            mean = jax.tree_util.tree_map(lambda *p: sum(p) / 4,
                                          *[r.params for r in replicas])
            replicas = [r.replace(params=mean) for r in replicas]
    stacked, _, _ = _stacked(GPT, gloo["gpt_init"])
    np.testing.assert_allclose(stacked, want, rtol=1e-4)
    for rank in gloo["ranks"]:
        np.testing.assert_allclose(rank["gpt"]["losses"], want, rtol=1e-4)
        np.testing.assert_allclose(rank["gpt"]["losses"], stacked,
                                   rtol=1e-6)


def _jax_template(four_devices, stacked):
    jcfg = JaxConfig(**CNN, mesh=JaxMesh(data=4))
    _, state = jloop._build_model_and_state(
        jcfg, four_devices, jax_make_task(jcfg, four_devices))
    return jlsgd.stack_state(state, four_devices) if stacked else state


def test_save_is_jaxs_bytes(gloo, four_devices, tmp_path):
    ck = gloo["ck"]
    assert ckpt.latest_step(ck) == 5
    jstate = jckpt.restore(ck, _jax_template(four_devices, True))
    jckpt.save(str(tmp_path), jstate)
    for name in ("state.msgpack", "manifest.json"):
        with open(os.path.join(ck, "step_00000005", name), "rb") as f:
            port_bytes = f.read()
        with open(tmp_path / "step_00000005" / name, "rb") as f:
            assert f.read() == port_bytes, name


def test_mode_eval_and_averaged_restores_match_jax(gloo, four_devices):
    ck = gloo["ck"]
    want = jloop.evaluate_only(
        JaxConfig(**CNN, mode="eval", checkpoint_dir=ck,
                  mesh=JaxMesh(data=4)), logger=JaxLogger(enabled=False))
    got = tloop.evaluate_only(
        TrainConfig(**CNN, mode="eval", checkpoint_dir=ck, device="cpu"),
        logger=MetricLogger(enabled=False))
    for metrics in [got] + [r["eval"] for r in gloo["ranks"]]:
        assert set(metrics) == set(want)
        for k in want:
            np.testing.assert_allclose(metrics[k], want[k], rtol=1e-5,
                                       err_msg=k)
    jav = jckpt.restore_averaged(ck, _jax_template(four_devices, False))
    _, plain = tloop._build_model_and_state(
        TrainConfig(**CNN, device="cpu"), CPU)
    tav = ckpt.restore_averaged(ck, plain)
    assert tav.step == int(jav.step) == 5
    want_params = interop.params_from_flax(jax.device_get(jav.params))
    for name, p in tav.params.items():
        assert torch.equal(p.detach(), want_params[name]), name
    jswap, jstep = jckpt.restore_params(ck, jav.params)
    tswap, tstep = ckpt.restore_params(ck, tav.model)
    assert tstep == jstep == 5
    for name, t in interop.params_from_flax(
            jax.device_get(jswap)).items():
        assert torch.equal(tswap[name], t), name


def test_sync_flip_across_resume_is_a_clear_error(gloo, tmp_path):
    _, plain = tloop._build_model_and_state(
        TrainConfig(**CNN, device="cpu"), CPU)
    with pytest.raises(ValueError, match="param-sync-every"):
        ckpt.restore(gloo["ck"], plain)
    ckpt.save(str(tmp_path), plain)
    _, fresh = tloop._build_model_and_state(
        TrainConfig(**CNN, device="cpu"), CPU)
    with pytest.raises(ValueError, match="param-sync-every"):
        ckpt.restore(str(tmp_path), stack_state(fresh, stacked_data(4)))
    with pytest.raises(ValueError, match="replica-stacked"):
        ckpt.restore_averaged(str(tmp_path), fresh)
    # The replicas restore from a copy of the stacked save.
    copy = tmp_path / "copy"
    shutil.copytree(gloo["ck"], copy)
    cfg = TrainConfig(**CNN, device="cpu", mesh=MeshConfig(data=4))
    _, stacked, _ = tloop.build_stacked(cfg, CPU)
    stacked = ckpt.restore(str(copy), stacked)
    assert stacked.step == 5
    av = averaged_view(stacked)
    for name, p in gloo["ranks"][0]["cnn"]["params"].items():
        torch.testing.assert_close(av.params[name].detach(), p, rtol=0,
                                   atol=1e-6)
