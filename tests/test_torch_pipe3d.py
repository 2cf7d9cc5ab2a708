"""PyTorch port: ``pipelined_lm`` with a model axis, a seq axis and
``--param-partition zero1``, against the JAX package on the CPU.

JAX runs on its 8-device CPU mesh, the port on ``stacked_pipe(S, M, S')``
(every stage, model rank and ring position in one process) and over
gloo; a data split does not change a global-batch mean. The tiny setup
is JAX's tests' (4 layers, max_len 16, f32, vocab 64, 16 rows, 4
microbatches, SGD as JAX's parity tests: an update is lr x grad).

- pipe x model: the port's 1F1B (recompute, stash, V 2) and GPipe on
  pipe 2 x model 2 equal JAX's ``make_1f1b_train_step`` on data 2 x pipe
  2 x model 2 (JAX's ``test_1f1b_composes_with_tp`` mesh): loss rtol
  1e-5, grad norm 1e-4, params atol 5e-6 / rtol 1e-4.
- pipe x seq: the pipelined forward on pipe 2 x seq 2 (RoPE) equals
  JAX's non-pipelined ``CausalLM`` (``test_pipelined_modern``'s atol 2e-5
  / rtol 2e-4); 1F1B and V 2 on it equal JAX's 1F1B on data 2 x pipe 2 x
  seq 2 and pipe 2 x seq 2 x V 2 (RoPE and tying).
- zero1: a gloo data 2 x pipe 2 run under ``--param-partition zero1``
  equals the replicated one (JAX's ``test_fsdp`` bounds), with JAX's
  rule's leaves cut.
- One gloo world of 4 processes trains each combination through
  ``train()`` (pipe 2 x model 2 with a save, and with 4 experts cut over
  the model axis; pipe 2 x seq 2; data 2 x pipe 2 under zero1 and
  replicated): the losses and params equal the stacked transport's, and
  the pipe x model save restores into it.
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
from tensorflow_distributed_tpu.models.transformer import (
    CausalLM as JaxCausalLM)
from tensorflow_distributed_tpu.models.transformer import (
    tiny_config as jax_tiny)
from tensorflow_distributed_tpu.parallel.mesh import make_mesh
from tensorflow_distributed_tpu.parallel.sharding import (
    param_sharding as jax_param_sharding)
from tensorflow_distributed_tpu.parallel.sharding import shard_batch
from tensorflow_distributed_tpu.train.pipeline_step import (
    make_1f1b_train_step as jax_1f1b)
from tensorflow_distributed_tpu.train.state import (
    create_train_state as jax_state)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import MeshConfig, TrainConfig
from tensorflow_distributed_tpu_torch.data.prefetch import to_device
from tensorflow_distributed_tpu_torch.models.pipelined import pipelined_lm
from tensorflow_distributed_tpu_torch.parallel.mesh import stacked_pipe
from tensorflow_distributed_tpu_torch.parallel.sharding import data_blocked
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.train.checkpoint import whole_state
from tensorflow_distributed_tpu_torch.train.optim import Optimizer
from tensorflow_distributed_tpu_torch.train.pipeline_step import (
    make_1f1b_train_step)
from tensorflow_distributed_tpu_torch.train.state import create_train_state
from tensorflow_distributed_tpu_torch.train.step import make_train_step
from tensorflow_distributed_tpu_torch.train.tasks import make_pipelined_loss
from torch_ring_workers import pipe_runs, spawn_ranks
from torch_threads import _one_thread  # noqa: F401

TINY = dict(n_layers=4, max_len=16)
MODERN = dict(pos_emb="rope", tie_embeddings=True)
CPU = torch.device("cpu")
LR = 1e-2
ZERO_MIN = 2 ** 12  # the partition rule's threshold in the zero1 runs
PIPE = dict(model="pipelined_lm", model_size="tiny", seq_len=16,
            batch_size=16, train_steps=3, eval_every=0, log_every=1,
            eval_batch_size=16, compute_dtype="float32", dropout_rate=0.0,
            learning_rate=3e-3, seed=0, pipeline_microbatches=4)


def _batch():
    return synthetic_clm(n=32, seq_len=16, vocab_size=64).batch(
        np.arange(16))


def _torch_batch(host):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_step(mesh_axes, V=1, **kw):
    """JAX's pipelined model on ``mesh_axes`` (the first devices of the
    8), its host params and one 1F1B step on the batch: (tree, updated
    params, metrics)."""
    devices = jax.devices()[:int(np.prod(list(mesh_axes.values())))]
    mesh = make_mesh(JaxMesh(**mesh_axes), devices)
    model = jax_pipelined_lm(mesh, num_microbatches=4, virtual_stages=V,
                             dropout_rate=0.0, compute_dtype=jnp.float32,
                             use_flash=False, **TINY, **kw)
    state = jax_state(model, optax.sgd(LR), np.zeros((2, 16), np.int32),
                      mesh)
    tree = nn.meta.unbox(jax.device_get(state.params))
    st, met = jax_1f1b(model, mesh, donate=False, grad_norm_metric=True)(
        state, shard_batch(mesh, _batch(), seq_axis=1))
    return (tree, _flat(nn.meta.unbox(jax.device_get(st.params))),
            {k: float(v) for k, v in met.items()})


def _port(tree, V=1, model=1, seq=1, **kw):
    """The port's model on stacked_pipe(2, model, seq) with JAX's params,
    its SGD state and the mesh."""
    mesh = stacked_pipe(2, model, seq)
    m = pipelined_lm("tiny", pipe=mesh.pp, num_microbatches=4,
                     virtual_stages=V, ring=mesh.ring, tp=mesh.tp,
                     dropout_rate=0.0, compute_dtype=torch.float32,
                     **TINY, **kw)
    state = create_train_state(m, Optimizer("sgd", lambda c: LR), 0,
                               interop.shards_from_flax(tree, m))
    return m, mesh, state


def _flat_specs(tree):
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))}


def _check(state, met, want_params, want_met):
    np.testing.assert_allclose(float(met["loss"]), want_met["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               want_met["grad_norm"], rtol=1e-4)
    with whole_state(state) as whole:
        got = _flat(interop.params_to_flax(whole.params, whole.model))
    assert set(got) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got[k], v, atol=5e-6, rtol=1e-4,
                                   err_msg=k)


# --- pipe x model --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tp():
    return {V: _jax_step(dict(data=2, pipe=2, model=2), V) for V in (1, 2)}


@pytest.mark.parametrize("schedule", ["recompute", "stash", "gpipe", "v2"])
def test_pipe_x_model_matches_jaxs_1f1b_on_data_pipe_model(jax_tp,
                                                           schedule):
    V = 2 if schedule == "v2" else 1
    tree, want, jmet = jax_tp[V]
    model, mesh, state = _port(tree, V, model=2)
    # The blocks are Megatron blocks (the M parts stacked), the shell
    # whole on every model rank.
    assert state.params["layer_0.attn.qkv.weight"].shape[0] == 2
    whole = model.whole("meta")
    for name in ("tok_emb.weight", "lm_head.weight", "ln_f.weight"):
        assert state.params[name].shape == whole.get_parameter(name).shape
    if schedule == "gpipe":
        step = make_train_step(make_pipelined_loss(), CPU, mesh=mesh,
                               grad_norm_metric=True)
    else:
        step = make_1f1b_train_step(
            model, CPU, mesh, grad_norm_metric=True,
            backward="stash" if schedule == "stash" else "recompute")
    state, met = step(state, _torch_batch(_batch()))
    _check(state, met, want, jmet)


# --- pipe x seq ----------------------------------------------------------

def test_pipe_x_seq_forward_matches_jaxs_causal_lm():
    """test_pipelined_modern's ring case: the pipelined forward over the
    seq ring equals the non-pipelined CausalLM with the same weights."""
    cfg = jax_tiny(causal=True, tp_partitioning=False, n_layers=4,
                   max_len=16, dropout_rate=0.0, compute_dtype=jnp.float32,
                   use_flash=False, pos_emb="rope")
    tokens = np.arange(8 * 16, dtype=np.int32).reshape(8, 16) % 64
    jmodel = JaxCausalLM(cfg, None)
    variables = jmodel.init(jax.random.key(0), tokens)
    want = jmodel.apply(variables, tokens)
    mesh = stacked_pipe(2, seq=2)
    model = pipelined_lm("tiny", pipe=mesh.pp, ring=mesh.ring,
                         num_microbatches=4, dropout_rate=0.0,
                         compute_dtype=torch.float32, pos_emb="rope",
                         **TINY)
    full = interop.params_from_flax(
        nn.meta.unbox(jax.device_get(variables["params"])))
    model.load_state_dict(full)
    got = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-4)


@pytest.fixture(scope="module")
def jax_seq():
    return {1: _jax_step(dict(data=2, pipe=2, seq=2), 1, **MODERN),
            2: _jax_step(dict(pipe=2, seq=2), 2, **MODERN)}


@pytest.mark.parametrize("schedule", ["recompute", "stash", "v2"])
def test_pipe_x_seq_matches_jaxs_1f1b(jax_seq, schedule):
    V = 2 if schedule == "v2" else 1
    tree, want, jmet = jax_seq[V]
    model, mesh, state = _port(tree, V, seq=2, **MODERN)
    step = make_1f1b_train_step(
        model, CPU, mesh, grad_norm_metric=True,
        backward="stash" if schedule == "stash" else "recompute")
    state, met = step(state, _torch_batch(_batch()))
    _check(state, met, want, jmet)


# --- zero1 ---------------------------------------------------------------

def test_zero1_cuts_jaxs_stacked_leaves():
    """JAX's rule (``param_sharding(fsdp=True)``) on its boxed stacked
    [S, lps, ...] leaves (pipe on dim 0, the TP names taken) cuts the
    leaves the port cuts (none of the tiny model at 2^14); under pipe x
    model the same set, also at a lower threshold (the kernels)."""
    mesh = make_mesh(JaxMesh(data=2, pipe=2), jax.devices()[:4])
    jmodel = jax_pipelined_lm(mesh, num_microbatches=4,
                              compute_dtype=jnp.float32, **TINY)
    boxed = jmodel.init(jax.random.key(0), np.zeros((2, 16), np.int32))
    specs = jax_param_sharding(mesh, boxed["params"], fsdp=True)
    cut = {path for path, s in _flat_specs(specs).items()
           if "data" in s.spec}
    port = stacked_pipe(2)
    model = pipelined_lm("tiny", pipe=port.pp, compute_dtype=torch.float32,
                         **TINY)
    blocked = data_blocked(model, 2)
    mapped = set()
    for name in blocked:
        path = interop.flax_layout(model, name)[0]
        mapped.add("blocks/" + "/".join(path[1:])
                   if name.startswith("layer_") else "shell/"
                   + "/".join(path))
    assert mapped == cut
    tp = stacked_pipe(2, model=2)
    tmodel = pipelined_lm("tiny", pipe=tp.pp, tp=tp.tp,
                          compute_dtype=torch.float32, **TINY)
    assert data_blocked(tmodel, 2) == blocked
    # At the tests' threshold (ZERO_MIN) the kernels of every layer.
    low = data_blocked(model, 2, ZERO_MIN)
    assert {n for n in low if n.startswith("layer_0.")} == {
        "layer_0.attn.qkv.weight", "layer_0.attn.out.weight",
        "layer_0.mlp.up.weight", "layer_0.mlp.down.weight"}
    assert data_blocked(tmodel, 2, ZERO_MIN) == low


# --- gloo ----------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """One world of 4 gloo processes: pipe 2 x model 2 (saving at its
    last step), pipe 2 x seq 2, and data 2 x pipe 2 under zero1 and
    replicated, each 3 steps through train() from the stacked
    transport's init."""
    d = tmp_path_factory.mktemp("pipe3d")
    inits = {}
    for name, fields in (("learned", {}), ("rope", {"pos_emb": "rope"}),
                         ("moe", {"moe_experts": 4})):
        cfg = TrainConfig(**dict(PIPE, **fields), device="cpu",
                          mesh=MeshConfig(pipe=2))
        _, state, _ = tloop.build_stacked(cfg, CPU)
        inits[name] = {n: p.detach().clone()
                       for n, p in state.params.items()}
        torch.save(inits[name], d / f"{name}.pt")
    ck = str(d / "ck")
    spawn_ranks(pipe_runs, 4, d, [
        ("train", "tp", dict(PIPE, checkpoint_dir=ck, checkpoint_every=3),
         {"pipe": 2, "model": 2}, d / "learned.pt"),
        ("train", "seq", dict(PIPE, pos_emb="rope"), {"pipe": 2, "seq": 2},
         d / "rope.pt"),
        ("train", "tp_moe", dict(PIPE, moe_experts=4),
         {"pipe": 2, "model": 2}, d / "moe.pt"),
        ("train", "zero1", dict(PIPE, param_partition="zero1"),
         {"data": 2, "pipe": 2}, d / "learned.pt", ZERO_MIN),
        ("train", "replicated", PIPE, {"data": 2, "pipe": 2},
         d / "learned.pt")], d)
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(4)]
    return {"ranks": ranks, "inits": inits, "ck": ck}


def _stacked(init, mesh, **fields):
    cfg = TrainConfig(**dict(PIPE, **fields), device="cpu",
                      mesh=MeshConfig(**mesh))
    task, state, step = tloop.build_stacked(cfg, CPU, init_params=init)
    stream = task.train_stream(0)
    losses = []
    for _ in range(cfg.train_steps):
        state, metrics = step(state, to_device(next(stream), CPU))
        losses.append(float(metrics["loss"]))
    with whole_state(state) as whole:
        params = {n: p.detach().clone() for n, p in whole.params.items()}
    return losses, params


@pytest.mark.parametrize("run,mesh,fields,init", [
    ("tp", {"pipe": 2, "model": 2}, {}, "learned"),
    ("seq", {"pipe": 2, "seq": 2}, {"pos_emb": "rope"}, "rope"),
    ("tp_moe", {"pipe": 2, "model": 2}, {"moe_experts": 4}, "moe")])
def test_gloo_ranks_equal_the_stacked_transport(gloo, run, mesh, fields,
                                                init):
    losses, params = _stacked(gloo["inits"][init], mesh, **fields)
    for rank in gloo["ranks"]:
        got = rank[run]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
        for name, p in params.items():
            torch.testing.assert_close(got["params"][name], p, rtol=1e-4,
                                       atol=5e-6)
    if run == "tp":
        # Each process holds its stage's blocks, its model rank's part.
        local = [set(r["tp"]["local"]) for r in gloo["ranks"]]
        assert local[0] == local[1] and local[2] == local[3]
        assert "layer_0.attn.qkv.weight" in local[0]
        assert "layer_2.attn.qkv.weight" in local[2]
        # The save of pipe x model restores into the stacked transport.
        cfg = TrainConfig(**PIPE, device="cpu",
                          mesh=MeshConfig(pipe=2, model=2))
        _, state, _ = tloop.build_stacked(cfg, CPU)
        state = ckpt.restore(gloo["ck"], state)
        assert state.step == 3
        with whole_state(state) as whole:
            for name, p in params.items():
                torch.testing.assert_close(whole.params[name].detach(), p,
                                           rtol=1e-4, atol=5e-6)


def test_zero1_equals_replicated_over_gloo(gloo):
    for rank in gloo["ranks"]:
        zero1, repl = rank["zero1"], rank["replicated"]
        stage = {"layer_0", "layer_1"} if rank["zero1"]["local"][
            0].startswith("layer_0") else {"layer_2", "layer_3"}
        assert {n.split(".")[0] for n in zero1["blocked"]} == stage
        np.testing.assert_allclose(zero1["losses"], repl["losses"],
                                   rtol=1e-5)
        for name, p in repl["params"].items():
            torch.testing.assert_close(zero1["params"][name], p, rtol=2e-5,
                                       atol=1e-6)
