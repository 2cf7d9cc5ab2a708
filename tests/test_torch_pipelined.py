"""PyTorch port: ``models/pipelined.py``, GPipe through the standard
step's loss and ``train/pipeline_step.py``'s 1F1B, against the JAX
package on the CPU.

JAX runs on the 8-device CPU mesh (``data`` x ``pipe``), the port on
``StackedPipe(S)`` (every stage in one process); a data split does not
change a global-batch mean, so JAX's ``data=2, pipe=4`` is held against
the port's pipe 4. The tiny setup is JAX's test's (4 layers, max_len 16,
f32, vocab 64, 16 rows, 8 microbatches); each JAX oracle runs once per
module.

- The forward equals ``PipelinedLM.apply`` at S 2 and 4, V 2, and with
  RoPE, tying, SwiGLU, RMSNorm and GQA, to 1e-5.
- GPipe's loss and gradient (the pipelined loss's backward) equal
  ``jax.value_and_grad`` of JAX's apply and masked CE (JAX's GPipe
  train step is red on this tree, ROADMAP.md C).
- 1F1B recompute, stash and V 2 equal JAX's ``make_1f1b_train_step``:
  loss and ``grad_norm`` at rtol 1e-5 / 1e-4, the params after one step
  at atol 5e-6 and rtol 1e-4 (SGD, as JAX's own MoE parity test: an
  update is lr x grad, while Adam's first step lr g / (|g| + eps) turns
  the f32 noise of the key bias's exactly-zero gradient into 1e-5 moves).
- The fused-scan last stage (``ce_chunk``, tie off and on) equals JAX's
  1F1B with ``ce_chunk``; the MoE router losses through both schedules
  equal JAX's 1F1B's; with dropout on, recompute and stash (and GPipe)
  take the same step.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.data.lm import synthetic_clm
from tensorflow_distributed_tpu.models.pipelined import (
    pipelined_lm as jax_pipelined_lm)
from tensorflow_distributed_tpu.ops.losses import masked_ce_sums as jce
from tensorflow_distributed_tpu.parallel.mesh import make_mesh
from tensorflow_distributed_tpu.parallel.sharding import shard_batch
from tensorflow_distributed_tpu.train.pipeline_step import (
    make_1f1b_train_step as jax_1f1b)
from tensorflow_distributed_tpu.train.state import (
    create_train_state as jax_state)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.models.pipelined import pipelined_lm
from tensorflow_distributed_tpu_torch.parallel.mesh import stacked_pipe
from tensorflow_distributed_tpu_torch.train.optim import Optimizer
from tensorflow_distributed_tpu_torch.train.pipeline_step import (
    make_1f1b_train_step)
from tensorflow_distributed_tpu_torch.train.state import create_train_state
from tensorflow_distributed_tpu_torch.train.step import make_train_step
from tensorflow_distributed_tpu_torch.train.tasks import make_pipelined_loss
from torch_threads import _one_thread  # noqa: F401

TINY = dict(n_layers=4, max_len=16)
CPU = torch.device("cpu")
LR = 1e-2


def _batch():
    ds = synthetic_clm(n=32, seq_len=16, vocab_size=64)
    return ds.batch(np.arange(16))


def _jax(S, V=1, M=8, dropout=0.0, devices=None, data=None, **kw):
    """JAX's pipelined model on data x pipe S (the rest of the 8
    devices), its SGD train state and the host tree of its params."""
    devices = devices or jax.devices()
    mesh = make_mesh(JaxMesh(data=data or len(devices) // S, pipe=S),
                     devices)
    model = jax_pipelined_lm(mesh, num_microbatches=M, virtual_stages=V,
                             dropout_rate=dropout,
                             compute_dtype=jnp.float32, **TINY, **kw)
    state = jax_state(model, optax.sgd(LR), np.zeros((2, 16), np.int32),
                      mesh)
    return model, mesh, state, nn.meta.unbox(jax.device_get(state.params))


def _port(tree, S, V=1, M=8, dropout=0.0, **kw):
    """The port's model on StackedPipe(S) with JAX's params, and its SGD
    train state."""
    mesh = stacked_pipe(S)
    model = pipelined_lm("tiny", pipe=mesh.pp, num_microbatches=M,
                         virtual_stages=V, dropout_rate=dropout,
                         compute_dtype=torch.float32, **TINY, **kw)
    state = create_train_state(model, Optimizer("sgd", lambda c: LR), 0,
                               interop.shards_from_flax(tree, model))
    return model, mesh, state


def _torch_batch(host):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_params(state, model, want, atol=5e-6, rtol=1e-4):
    got = _flat(interop.params_to_flax(state.params, model))
    want = _flat(nn.meta.unbox(jax.device_get(want)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


# --- the forward --------------------------------------------------------

FORWARD = {"S2": (2, 1, {}), "S4_llama": (4, 1, dict(
    pos_emb="rope", tie_embeddings=True, mlp_variant="swiglu",
    norm="rmsnorm", n_kv_heads=2)), "S2_V2_tied": (2, 2, dict(
        tie_embeddings=True))}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_matches_jax_apply(case):
    S, V, kw = FORWARD[case]
    model, _, state, tree = _jax(S, V, M=4, **kw)
    tokens = np.arange(8 * 16, dtype=np.int32).reshape(8, 16) % 64
    want = jax.jit(lambda p, t: model.apply({"params": p}, t))(
        state.params, tokens)
    tmodel, _, _ = _port(tree, S, V, M=4, **kw)
    assert set(n.split(".")[0] for n in tmodel.state_dict()) >= {
        f"layer_{g}" for g in range(4)}
    got = tmodel(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# --- GPipe: the pipelined loss's backward ------------------------------

def test_gpipe_loss_and_gradient_match_jax_value_and_grad():
    """JAX: value_and_grad of apply + the masked-CE mean (JAX's GPipe
    train step is the red one); the port: the pipelined loss through its
    GPipe forward and autograd's backward."""
    model, _, state, tree = _jax(4)
    host = _batch()

    def loss(p):
        logits = model.apply({"params": p}, host["tokens"])
        ce, _, n = jce(logits, host["targets"], host["mask"])
        return ce / jnp.maximum(n, 1.0)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(state.params)
    tmodel, _, _ = _port(tree, 4)
    value, metrics = make_pipelined_loss()(tmodel, _torch_batch(host),
                                           train=True)
    value.backward()
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    got = _flat(interop.params_to_flax(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel))
    want = _flat(nn.meta.unbox(jax.device_get(jgrads)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)


# --- 1F1B against JAX's make_1f1b_train_step ---------------------------

@pytest.fixture(scope="module")
def jax_1f1b_s4():
    model, mesh, state, tree = _jax(4)
    host = _batch()
    st, met = jax_1f1b(model, mesh, donate=False, grad_norm_metric=True)(
        state, shard_batch(mesh, host, seq_axis=1))
    return tree, host, st.params, {k: float(v) for k, v in met.items()}


@pytest.mark.parametrize("backward", ["recompute", "stash"])
def test_1f1b_matches_jax(jax_1f1b_s4, backward):
    tree, host, jparams, jmet = jax_1f1b_s4
    model, mesh, state = _port(tree, 4)
    step = make_1f1b_train_step(model, CPU, mesh, grad_norm_metric=True,
                                backward=backward)
    state, met = step(state, _torch_batch(host))
    np.testing.assert_allclose(float(met["loss"]), jmet["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), jmet["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(met["accuracy"]), jmet["accuracy"],
                               rtol=1e-6)
    _assert_params(state, model, jparams)


def test_gpipe_step_takes_jaxs_1f1b_step(jax_1f1b_s4):
    """The port's GPipe schedule through the standard step lands on
    JAX's 1F1B step (the same math)."""
    tree, host, jparams, jmet = jax_1f1b_s4
    model, mesh, state = _port(tree, 4)
    step = make_train_step(make_pipelined_loss(), CPU, grad_norm_metric=True,
                           mesh=mesh)
    state, met = step(state, _torch_batch(host))
    np.testing.assert_allclose(float(met["loss"]), jmet["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), jmet["grad_norm"],
                               rtol=1e-4)
    _assert_params(state, model, jparams)


def test_interleaved_1f1b_matches_jax():
    model, mesh, state, tree = _jax(2, V=2)
    host = _batch()
    st, jmet = jax_1f1b(model, mesh, donate=False, grad_norm_metric=True)(
        state, shard_batch(mesh, host, seq_axis=1))
    tmodel, tmesh, tstate = _port(tree, 2, V=2)
    step = make_1f1b_train_step(tmodel, CPU, tmesh, grad_norm_metric=True)
    tstate, met = step(tstate, _torch_batch(host))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    _assert_params(tstate, tmodel, st.params)


@pytest.mark.parametrize("tie", [False, True])
def test_fused_scan_last_stage_matches_jax(tie):
    """ce_chunk > 0: the last stage's head inside the fused loss's scan
    form (JAX's test's setup: chunk 24 over vocab 64; RoPE when tied)."""
    kw = dict(tie_embeddings=tie, pos_emb="rope" if tie else "learned")
    model, mesh, state, tree = _jax(4, **kw)
    host = _batch()
    st, jmet = jax_1f1b(model, mesh, donate=False, grad_norm_metric=True,
                        ce_chunk=24)(state, shard_batch(mesh, host,
                                                        seq_axis=1))
    tmodel, tmesh, tstate = _port(tree, 4, **kw)
    step = make_1f1b_train_step(tmodel, CPU, tmesh, grad_norm_metric=True,
                                ce_chunk=24)
    tstate, met = step(tstate, _torch_batch(host))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    _assert_params(tstate, tmodel, st.params)


@pytest.fixture(scope="module")
def jax_moe():
    model, mesh, state, tree = _jax(2, M=4, devices=jax.devices()[:4],
                                    moe_experts=4)
    host = _batch()
    st, jmet = jax_1f1b(model, mesh, donate=False, moe_aux_weight=0.01,
                        moe_zloss_weight=1e-3)(
        state, shard_batch(mesh, host, seq_axis=1))
    return tree, host, st.params, {k: float(v) for k, v in jmet.items()}


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_moe_router_losses_through_both_schedules_match_jax(jax_moe,
                                                            schedule):
    """JAX's 1F1B on data 2 x pipe 2 with 4 experts (the oracle of its
    own MoE schedule test): aux_loss, z_loss, loss and the params after
    one SGD step, for the port's 1F1B and its GPipe."""
    tree, host, jparams, jmet = jax_moe
    tmodel, tmesh, tstate = _port(tree, 2, M=4, moe_experts=4)
    if schedule == "1f1b":
        step = make_1f1b_train_step(tmodel, CPU, tmesh, moe_aux_weight=0.01,
                                    moe_zloss_weight=1e-3)
    else:
        step = make_train_step(make_pipelined_loss(
            moe=True, aux_weight=0.01, zloss_weight=1e-3), CPU, mesh=tmesh)
    tstate, met = step(tstate, _torch_batch(host))
    assert float(met["aux_loss"]) > 0.0
    for k in ("aux_loss", "z_loss", "loss", "dropped_frac"):
        np.testing.assert_allclose(float(met[k]), jmet[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_params(tstate, tmodel, jparams)
    gate = tmodel.layer_0.moe_mlp.gate.detach()
    assert float((gate - torch.tensor(np.asarray(
        tree["blocks"]["moe_mlp"]["gate"][0, 0]))).abs().max()) > 0.0


def test_recompute_equals_stash_with_dropout():
    """Dropout 0.1: every slot draws its masks from (step seed,
    microbatch, virtual stage), so the recomputed forward replays the
    forward tick's masks: recompute, stash and GPipe take one step."""
    _, _, _, tree = _jax(4)
    host = _torch_batch(_batch())
    results = []
    for backward in ("recompute", "stash", "gpipe"):
        model, mesh, state = _port(tree, 4, dropout=0.1)
        if backward == "gpipe":
            step = make_train_step(make_pipelined_loss(), CPU, seed=3,
                                   mesh=mesh)
        else:
            step = make_1f1b_train_step(model, CPU, mesh, seed=3,
                                        backward=backward)
        state, met = step(state, host)
        results.append((float(met["loss"]), {n: p.detach().clone() for n, p
                                             in state.params.items()}))
    (l0, p0), *rest = results
    for loss, params in rest:
        assert abs(loss - l0) <= 1e-6 * abs(l0)
        for n, p in p0.items():
            torch.testing.assert_close(params[n], p, rtol=1e-5, atol=1e-7)
    model, mesh, state = _port(tree, 4)
    no_drop = make_1f1b_train_step(model, CPU, mesh, seed=3)(state, host)[1]
    assert abs(float(no_drop["loss"]) - l0) > 1e-4  # the masks were drawn


def _adafactor_case(seed=0, layers=4):
    """Stacked [layers, 160, 200] kernels (factored: 160 >= 128) and
    [layers, 48] biases, each layer at its own scale (so the layers'
    block RMS differ), with gradients."""
    rng = np.random.default_rng(seed)
    scale = np.geomspace(0.01, 1.0, layers)[:, None]
    w = (rng.normal(size=(layers, 160 * 200)) * scale).reshape(
        layers, 160, 200).astype(np.float32)
    b = (rng.normal(size=(layers, 48)) * scale).astype(np.float32)
    gw = (rng.normal(size=w.shape) * 3).astype(np.float32)
    gb = rng.normal(size=b.shape).astype(np.float32)
    return {"w": w, "b": b}, {"w": gw, "b": gb}


def _port_adafactor(params, grads, layers, group_sum=None):
    """The port's Adafactor over one tensor a layer (``layer_g.w``,
    ``layer_g.b``), each grouped into its stacked JAX leaf."""
    names = {f"layer_{g}.{k}": (k, g) for g in layers for k in params}
    tp = {n: torch.tensor(params[k][g]) for n, (k, g) in names.items()}
    tg = {n: torch.tensor(grads[k][g]) for n, (k, g) in names.items()}
    same = (lambda t: t, lambda t: t)
    opt = Optimizer("adafactor", lambda c: 1e-2,
                    layouts={n: same for n in names},
                    groups={n: k for n, (k, _) in names.items()},
                    group_sum=group_sum)
    state = opt.init(tp)
    return opt, state, tp, tg, names


def test_adafactor_block_rms_spans_the_stacked_leaf():
    """optax.adafactor on stacked leaves (one block RMS over every
    layer) against the port's per-layer tensors grouped into them: the
    updates to 1e-6; and the per-layer RMS (no groups) differs."""
    params, grads = _adafactor_case()
    tx = optax.adafactor(1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                        tx.init(jp), jp)
    opt, state, tp, tg, names = _port_adafactor(params, grads, range(4))
    got = opt.update(tg, state, tp)
    for n, (k, g) in names.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[k][g]),
                                   rtol=1e-5, atol=1e-9, err_msg=n)
    opt.groups = {}
    lone = opt.update(tg, opt.init(tp), tp)
    assert not np.allclose(lone["layer_0.w"].numpy(),
                           np.asarray(want["w"][0]), rtol=1e-2)


def test_adafactor_group_sum_joins_two_stages_slices():
    """Two stages' optimizers, each holding half the layers, whose
    ``group_sum`` adds the other stage's statistics, update as the one
    optimizer holding every layer."""
    params, grads = _adafactor_case(seed=1)
    whole, state, tp, tg, _ = _port_adafactor(params, grads, range(4))
    want = whole.update(tg, state, tp)
    seen = {}
    other, ostate, op, og, _ = _port_adafactor(
        params, grads, range(2, 4),
        group_sum=lambda t: seen.setdefault("late", t.clone()))
    other.update(og, ostate, op)
    first, fstate, fp, fg, _ = _port_adafactor(
        params, grads, range(2), group_sum=lambda t: t.add_(seen["late"]))
    got = first.update(fg, fstate, fp)
    for n, t in got.items():
        torch.testing.assert_close(t, want[n], rtol=1e-6, atol=1e-9)
