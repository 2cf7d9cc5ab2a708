"""PyTorch port: ``--optimizer adafactor`` against ``optax.adafactor`` as
the JAX package builds it (``train/optim.py``), and its state in the
checkpoint format both packages share.

- The factoring decision per leaf equals optax's ``_factored_dims``,
  made on the FLAX leaf's shape: at GPT-2-small's widths ``qkv``, ``q``,
  ``kv`` and ``out`` are not factored (their second largest axis is 64),
  ``mlp/*`` and ``tok_emb`` are.
- 5 optimizer steps on a model whose leaves are factored (d_model 128)
  follow optax's to 1e-4 (losses, params) and keep optax's statistics
  (1e-4 relative); 5-step ``train()`` trajectories follow JAX's to 1e-4.
- A port checkpoint restores bit-exactly in JAX and JAX saves the
  port's bytes again; a JAX checkpoint restores in the port, whose next
  steps follow JAX's to 1e-4.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser
from optax._src import factorized

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.ops.losses import (
    masked_softmax_cross_entropy as jax_masked_ce)
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import checkpoint as jckpt
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.optim import (
    make_optimizer as jax_make_optimizer)
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.ops.losses import (
    masked_softmax_cross_entropy)
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.train.optim import (
    factored_dims, make_optimizer)
from tensorflow_distributed_tpu_torch.train.state import TrainState
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401

LLAMA = dict(pos_emb="rope", n_kv_heads=4, mlp_variant="swiglu",
             norm="rmsnorm", tie_embeddings=True)
TINY = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
            eval_every=0, log_every=1, eval_batch_size=8,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0, optimizer="adafactor")
CHAINS = {"plain": {}, "decay": dict(weight_decay=0.1),
          "clip": dict(grad_clip_norm=0.5),
          "decay_clip": dict(weight_decay=0.1, grad_clip_norm=0.5)}


# --- the factoring decision --------------------------------------------------

@pytest.mark.parametrize("shape", [
    (768, 3, 12, 64), (768, 12, 64), (768, 2, 4, 64), (12, 64, 768),
    (768, 3072), (3072, 768), (50257, 768), (768, 50257), (3072,), (768,),
    (5, 5, 1, 32), (3136, 1024), (128, 127), (127, 128), (128, 128),
    (200, 130, 5), (5, 300, 7, 200), (1,)])
def test_factored_dims_equal_optax(shape):
    assert factored_dims(list(shape)) == factorized._factored_dims(
        shape, True, 128)


def _flax_shapes(**overrides):
    jmodel = jtr.gpt_lm(size="small", **overrides)
    return nn.meta.unbox(jax.eval_shape(lambda k: jmodel.init(
        k, jnp.zeros((1, 8), jnp.int32), train=False),
        jax.random.key(0))["params"])


def _port_state_shapes(model, state):
    """{flax path: (v_row, v_col, v) shapes} of the port's state."""
    return {tuple(interop.flax_layout(model, n)[0]):
            tuple(tuple(state[k][n].shape) for k in ("v_row", "v_col", "v"))
            for n in state["v"]}


@pytest.mark.parametrize("overrides", [{}, LLAMA], ids=["gpt2", "llama"])
def test_gpt2_small_leaves_factor_as_optax_decides(overrides):
    """At GPT-2-small's widths (on the meta device: shapes only) every
    leaf's statistics have the shapes optax.adafactor's init gives the
    flax tree: the attention's DenseGeneral kernels keep a full v, the
    MLP matrices and the embedding a v_row and a v_col."""
    params = _flax_shapes(**overrides)
    want_state = jax.eval_shape(optax.adafactor(1e-3).init, params)[0]
    want = {}
    for path, v in jax.tree_util.tree_flatten_with_path(want_state.v)[0]:
        key = tuple(p.key for p in path)
        node_r, node_c = want_state.v_row, want_state.v_col
        for k in key:
            node_r, node_c = node_r[k], node_c[k]
        want[key] = (tuple(node_r.shape), tuple(node_c.shape),
                     tuple(v.shape))
    with torch.device("meta"):
        model = ttr.gpt_lm("small", **overrides)
    cfg = TrainConfig(model="gpt_lm", optimizer="adafactor")
    tx = make_optimizer(cfg, model)
    got = _port_state_shapes(model, tx.init(dict(model.named_parameters())))
    assert got == want
    one = ((1,), (1,))
    attn = ("qkv",) if not overrides else ("q", "kv")
    for name in attn + ("out",):
        assert got[("layer_0", "attn", name, "kernel")][:2] == one, name
    for name in ("up", "down") + (("gate",) if overrides else ()):
        assert got[("layer_0", "mlp", name, "kernel")][2] == (1,), name
    assert got[("tok_emb", "embedding")] == ((768,), (50257,), (1,))


# --- optimizer steps against optax -------------------------------------------

WIDE = dict(d_model=128, n_heads=4, d_ff=256, vocab_size=256, max_len=32)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_five_steps_on_factored_leaves_follow_optax(chain):
    """A tiny model wide enough to factor (d_model 128, d_ff 256, vocab
    256): 5 steps of loss, grads and the update in both packages from
    the same init, the JAX side through the JAX package's
    make_optimizer."""
    fields = dict(optimizer="adafactor", learning_rate=1e-2,
                  **CHAINS[chain])
    jmodel = jtr.gpt_lm(size="tiny", compute_dtype=jnp.float32,
                        dropout_rate=0.0, **WIDE, **LLAMA)
    tokens = jnp.zeros((1, 8), jnp.int32)
    params = nn.meta.unbox(jmodel.init(jax.random.key(0), tokens)["params"])
    model = ttr.gpt_lm("tiny", compute_dtype=torch.float32,
                       dropout_rate=0.0, **WIDE, **LLAMA)
    model.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    jtx = jax_make_optimizer(JaxConfig(model="gpt_lm", **fields))
    jstate = jtx.init(params)
    tx = make_optimizer(TrainConfig(model="gpt_lm", **fields), model)
    tparams = dict(model.named_parameters())
    tstate = tx.init(tparams)
    assert sum(v.numel() == 1 for v in tstate["v"].values()) >= 4

    def jloss(p, batch):
        logits = jmodel.apply({"params": p}, batch[0])
        return jax_masked_ce(logits, batch[1], batch[2])

    jgrad = jax.jit(jax.value_and_grad(jloss))
    rng = np.random.default_rng(0)
    for step in range(5):
        batch = (rng.integers(0, 256, (2, 32)).astype(np.int32),
                 rng.integers(0, 256, (2, 32)).astype(np.int32),
                 (rng.random((2, 32)) < 0.9).astype(np.float32))
        jl, grads = jgrad(params, batch)
        updates, jstate = jtx.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        loss = masked_softmax_cross_entropy(
            model(torch.from_numpy(batch[0])), torch.from_numpy(batch[1]),
            torch.from_numpy(batch[2]))
        loss.backward()
        with torch.no_grad():
            up = tx.update({n: p.grad for n, p in tparams.items()}, tstate,
                           tparams)
            for n, p in tparams.items():
                p.add_(up[n])
        model.zero_grad(set_to_none=True)
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   atol=1e-4, err_msg=f"step {step}")
    want = interop.params_from_flax(jax.device_get(params))
    for n, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-4, err_msg=n)
    core = jax.device_get(jstate[1][0] if CHAINS[chain].get("grad_clip_norm")
                          else jstate[0])
    assert int(core.count) == tstate["count"] == 5
    for key in ("v_row", "v_col", "v"):
        got = interop._stats_to_flax(tstate[key], model)
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-4,
                                                    atol=1e-12),
            got, getattr(core, key))


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _jax_state(**fields):
    jcfg = JaxConfig(**{**TINY, **fields})
    mesh = make_mesh(jcfg.mesh)
    return jloop._build_model_and_state(jcfg, mesh,
                                        jax_make_task(jcfg, mesh))[1]


TRAIN = {"plain": {}, "decay_clip": CHAINS["decay_clip"],
         "llama": dict(LLAMA, n_kv_heads=2)}


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_five_step_train_trajectory_matches_jax(case):
    fields = dict(TINY, train_steps=5, **TRAIN[case])
    jres = jloop.train(JaxConfig(**fields),
                       logger=MetricLogger(enabled=False))
    init = interop.params_from_flax(jax.device_get(
        _jax_state(**TRAIN[case]).params))
    tres = tloop.train(TrainConfig(**fields, device="cpu"),
                       logger=MetricLogger(enabled=False), init_params=init)
    assert len(_losses(tres.logger)) == 5
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               atol=1e-4)


# --- checkpoints across the packages -----------------------------------------

def _port_train(tmp, steps, **fields):
    cfg = TrainConfig(**{**TINY, **fields}, train_steps=steps, device="cpu",
                      checkpoint_dir=str(tmp))
    return tloop.train(cfg, logger=MetricLogger(enabled=False))


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    return None if tree is None else (np.shape(tree), np.asarray(tree).dtype)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
        assert np.asarray(got).dtype == np.asarray(want).dtype, path


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_state_to_flax_has_the_jax_templates_keys_and_shapes(chain,
                                                             tmp_path):
    want = _skeleton(fser.to_state_dict(jax.device_get(
        _jax_state(**CHAINS[chain]))))
    res = _port_train(tmp_path, 1, **CHAINS[chain])
    assert _skeleton(interop.state_to_flax(res.state)) == want


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_port_checkpoint_restores_bit_exactly_in_jax(chain, tmp_path):
    fields = CHAINS[chain]
    res = _port_train(tmp_path / "port", 2, **fields)
    jstate = jckpt.restore(str(tmp_path / "port"), _jax_state(**fields))
    restored = fser.to_state_dict(jax.device_get(jstate))
    assert int(restored["step"]) == 2
    _assert_trees_equal(restored, interop.state_to_flax(res.state))
    jckpt.save(str(tmp_path / "jax"), jstate)
    for name in ("state.msgpack", "manifest.json"):
        with open(tmp_path / "port" / "step_00000002" / name, "rb") as f:
            port_bytes = f.read()
        with open(tmp_path / "jax" / "step_00000002" / name, "rb") as f:
            assert f.read() == port_bytes, name


def test_jax_checkpoint_restores_in_the_port_and_training_follows_jax(
        tmp_path):
    d = str(tmp_path / "jax")
    fields = dict(TINY, **CHAINS["decay"])
    jloop.train(JaxConfig(**fields, train_steps=2, checkpoint_dir=d,
                          checkpoint_every=2),
                logger=MetricLogger(enabled=False))
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    (tmp_path / "jax" / "step_00000002").rename(port_dir / "step_00000002")
    jres = jloop.train(JaxConfig(**fields, train_steps=5,
                                 checkpoint_dir=str(port_dir), resume=True),
                       logger=MetricLogger(enabled=False))
    (port_dir / "step_00000005").rename(tmp_path / "jax_step5")
    tres = _port_train(port_dir, 5, resume=True, **CHAINS["decay"])
    assert len(_losses(tres.logger)) == 3
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               atol=1e-4)
    assert tres.state.opt_state["count"] == 5


def test_factored_state_round_trips_through_the_state_dict():
    """A state with factored leaves (d_model 128) -> the JAX state dict ->
    a fresh state: every statistic, the count and the params equal."""
    cfg = TrainConfig(model="gpt_lm", optimizer="adafactor",
                      weight_decay=0.1)

    def state():
        model = ttr.gpt_lm("tiny", compute_dtype=torch.float32, **WIDE)
        model.init_weights(torch.Generator().manual_seed(0))
        tx = make_optimizer(cfg, model)
        return TrainState(model, tx, tx.init(dict(model.named_parameters())))

    src = state()
    params = src.params
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    with torch.no_grad():
        for _ in range(2):
            for n, u in src.tx.update(grads, src.opt_state, params).items():
                params[n].add_(u)
    src.step = 2
    tree = interop.state_to_flax(src)
    assert list(tree["opt_state"]["0"]) == ["count", "v_row", "v_col", "v"]
    dst = interop.state_from_flax(tree, state())
    assert dst.step == 2 and dst.opt_state["count"] == 2
    for key in ("v_row", "v_col", "v"):
        for n, t in src.opt_state[key].items():
            assert torch.equal(dst.opt_state[key][n], t), (key, n)
    for n, p in params.items():
        assert torch.equal(dst.params[n], p), n
