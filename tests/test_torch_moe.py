"""PyTorch port: the mixture-of-experts layer (``models/moe.py``), its
config surface and its optimizer leaves against the JAX package on the
CPU.

- ``MoeMlp`` on the JAX layer's weights: the routing (top-k masks,
  buffer positions, kept slots) equals JAX's exactly, and the output,
  the three aux values and every gradient (of the weights and the
  input) agree to 1e-5 in f32, for dense and scatter dispatch, top-1
  and top-2, with and without capacity drops and with routing groups;
  as a precondition the smallest gap between the k-th and (k+1)-th
  router probability is above 1e-6, so a near-tie cannot flip a pick
  silently. The same holds on ``StackedTP(2)``, two expert ranks in one
  process.
- A tiny ``moe_lm`` on ``StackedTP(2)`` over the model axis (TP
  attention, experts on the model ranks) equals the whole model: the
  loss, the logits and the whole gradient to 1e-5.
- The flags and fields parse with JAX's defaults; the MoE checks raise
  JAX's messages; what the port leaves out names ROADMAP.md.
- The decay mask decays ``gate``, ``wi`` and ``wo`` as JAX's, and
  Adafactor keeps E and factors (D, F) as optax does: 3 steps on a MoE
  model wide enough to factor follow optax to 1e-4.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.config import parse_args as jax_parse_args
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.models.moe import MoeMlp as JaxMoe
from tensorflow_distributed_tpu.models.moe import collect_aux as jax_collect
from tensorflow_distributed_tpu.ops.losses import (
    masked_softmax_cross_entropy as jax_masked_ce)
from tensorflow_distributed_tpu.parallel.mesh import make_mesh
from tensorflow_distributed_tpu.train import optim as joptim
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import (
    MeshConfig, TrainConfig, parse_args)
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.models.moe import (
    AUX_NAMES, MoeMlp, collect_aux, moe_objective)
from tensorflow_distributed_tpu_torch.ops.losses import (
    masked_ce_sums, masked_softmax_cross_entropy)
from tensorflow_distributed_tpu_torch.parallel.mesh import Mesh
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    gather_state_dict)
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    StackedTP, VocabShards)
from tensorflow_distributed_tpu_torch.train import optim as toptim
from torch_threads import _one_thread  # noqa: F401


TOL = dict(atol=1e-5, rtol=1e-5)
# (capacity factor, top-k, dispatch, group_len): no drops, drops, top-1,
# routing groups (of 4 tokens, drops at 0.5).
LAYER_CASES = [(10.0, 2, "dense", 0), (0.5, 2, "dense", 0),
               (0.5, 1, "dense", 0), (10.0, 2, "scatter", 0),
               (0.5, 2, "scatter", 0), (0.5, 1, "scatter", 0),
               (0.5, 2, "dense", 4), (0.5, 2, "scatter", 4)]


def _jax_routing(params, x, E, K, cap, group_len):
    """JAX's routing of x (the JAX layer's formulas on jnp arrays): the
    masks, positions and kept flags, and the smallest gap between the
    k-th and (k+1)-th probability over the tokens and picks."""
    G0, S0, D = x.shape
    if group_len and S0 > group_len:
        x = x.reshape(G0 * (S0 // group_len), group_len, D)
    G, S, _ = x.shape
    C = max(1, int(np.ceil(cap * K * S / E)))
    probs = jax.nn.softmax(jnp.asarray(x) @ params["gate"], axis=-1)
    ranked = -np.sort(-np.asarray(probs), axis=-1)
    gap = float((ranked[..., :K] - ranked[..., 1:K + 1]).min())
    masks, remaining = [], probs
    for _ in range(K):
        mask = jax.nn.one_hot(jnp.argmax(remaining, -1), E)
        masks.append(mask)
        remaining = remaining * (1.0 - mask)
    pos, used = [], jnp.zeros((G, 1, E))
    for mask in masks:
        cum = jnp.cumsum(mask, axis=1) - mask + used
        pos.append(jnp.sum(cum * mask, axis=-1))
        used = used + jnp.sum(mask, axis=1, keepdims=True)
    withins = [(p < C).astype(jnp.float32) for p in pos]
    return ([np.asarray(a) for a in masks], [np.asarray(a) for a in pos],
            [np.asarray(a) for a in withins], gap)


def _port_layer(params, E, K, cap, dispatch, group_len, ep=None):
    layer = MoeMlp(16, 32, E, K, cap, torch.float32, group_len, dispatch, ep)
    with torch.no_grad():
        layer.gate.copy_(torch.from_numpy(np.asarray(params["gate"])))
        for name in ("wi", "wo"):
            w = torch.from_numpy(np.asarray(params[name]))
            if ep is not None:
                w = w.reshape(ep.size, E // ep.size, *w.shape[1:])
            getattr(layer, name).copy_(w)
    return layer


@pytest.mark.parametrize(
    "cap,top_k,dispatch,group_len", LAYER_CASES,
    ids=[f"{d}-k{k}-cap{c}-g{g}" for c, k, d, g in LAYER_CASES])
def test_moe_layer_matches_jax(cap, top_k, dispatch, group_len):
    E = 4
    x = np.random.default_rng(4).normal(size=(2, 16, 16)).astype(np.float32)
    jlayer = JaxMoe(d_model=16, d_ff=32, num_experts=E, top_k=top_k,
                    capacity_factor=cap, compute_dtype=jnp.float32,
                    partitioned=False, dispatch=dispatch,
                    group_len=group_len)
    params = jlayer.init(jax.random.key(0), jnp.asarray(x))["params"]

    def jloss(p, xj):
        y, col = jlayer.apply({"params": p}, xj, mutable=["moe_aux"])
        aux = jax_collect(col["moe_aux"])
        return (jnp.sum(y * y) + aux["load_balance"] + aux["z_loss"],
                (y, aux))

    (_, (jy, jaux)), (jgrads, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    masks, pos, withins, gap = _jax_routing(params, x, E, top_k, cap,
                                            group_len)
    assert gap > 1e-6, f"near-tie in the router's inputs: gap {gap}"
    if cap < 1:
        assert jaux["dropped_fraction"] > 0  # the case drops slots
    for ep in (None, StackedTP(2)):
        layer = _port_layer(params, E, top_k, cap, dispatch, group_len, ep)
        xt = torch.from_numpy(x).requires_grad_()
        xg = xt.reshape(-1, group_len, 16) if group_len else xt
        with torch.no_grad():
            tmasks, tpos, _, twithins, _ = layer.route(xg)
        for a, b in zip(tmasks + tpos + twithins, masks + pos + withins):
            np.testing.assert_array_equal(a.numpy(), b)
        y, aux = layer(xt)
        lb, z, metrics = moe_objective([aux])
        ((y * y).sum() + lb + z).backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
        assert set(metrics) == set(AUX_NAMES)
        for name in AUX_NAMES:
            np.testing.assert_allclose(float(metrics[name]),
                                       float(jaux[name]), **TOL,
                                       err_msg=name)
        np.testing.assert_allclose(float(lb), float(jaux["load_balance"]),
                                   **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
        for name in ("gate", "wi", "wo"):
            got = getattr(layer, name).grad.reshape(params[name].shape)
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(jgrads[name]), **TOL,
                                       err_msg=name)


def test_collect_aux_is_the_mean_over_layers():
    layers = [{"z_loss": torch.tensor(1.0)}, {"z_loss": torch.tensor(3.0)}]
    assert float(collect_aux(layers)["z_loss"]) == 2.0


def test_short_sequences_route_as_one_group_and_checks():
    layer = MoeMlp(16, 32, 4, group_len=8, compute_dtype=torch.float32)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.02)
    y, aux = layer(torch.randn(3, 1, 16))  # a decode step: one token
    assert y.shape == (3, 1, 16) and aux.tokens == 3.0
    assert layer.capacity(1) == 1  # ceil(1.25 * 2 * 1 / 4): no drop
    with pytest.raises(ValueError, match="group_len"):
        layer(torch.randn(1, 12, 16))
    with pytest.raises(ValueError, match="top_k"):
        MoeMlp(16, 32, 2, top_k=3)
    with pytest.raises(ValueError, match="ROADMAP"):
        MoeMlp(16, 32, 3, ep=StackedTP(2))


def test_route_given_picks_routes_as_its_own_choice():
    """``route``'s ``picks`` (expert ids [G, S, K]) stand in for the
    top-k choice: given the router's own ids every output is the same;
    given others, the gates are the picked probabilities normalised over
    the picks, and positions and counts follow the picks."""
    layer = MoeMlp(16, 32, 4, capacity_factor=0.5,
                   compute_dtype=torch.float32)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(1))
    own = layer.route(x)
    ids = torch.stack([m.argmax(-1) for m in own[0]], -1)
    again = layer.route(x, ids)
    for a, b in zip(own[0] + own[1] + own[2] + own[3],
                    again[0] + again[1] + again[2] + again[3]):
        assert torch.equal(a, b)
    assert torch.equal(own[4].counts, again[4].counts)
    assert torch.equal(own[4].kept, again[4].kept)
    other = (ids + 1) % 4
    masks, pos, gks, _, aux = layer.route(x, other)
    probs = torch.softmax(x @ layer.gate, -1)
    picked = torch.gather(probs, -1, other)
    torch.testing.assert_close(torch.stack(gks, -1),
                               picked / picked.sum(-1, keepdim=True))
    assert torch.equal(torch.stack([m.argmax(-1) for m in masks], -1), other)
    assert torch.equal(aux.counts,
                       torch.bincount(other.flatten(), minlength=4).float())
    assert float(pos[1].max()) <= 2 * 8 - 1


@pytest.mark.parametrize("dispatch", ["dense", "scatter"])
def test_experts_on_the_model_axis_equal_the_whole_model(dispatch):
    """moe_lm on StackedTP(2) over the model axis: TP attention and each
    rank's 2 of 4 experts; loss, logits and the gathered gradient equal
    the whole model's to 1e-5."""
    torch.manual_seed(0)
    kw = dict(compute_dtype=torch.float32, dropout_rate=0.0,
              moe_dispatch=dispatch, moe_capacity_factor=1.0)
    model = ttr.moe_lm("tiny", tp=StackedTP(2), **kw)
    assert model.ep is model.tp
    model.init_weights(torch.Generator().manual_seed(0))
    whole = model.whole()
    whole.load_state_dict(gather_state_dict(model.state_dict(), model))
    assert model.layer_0.moe_mlp.wi.shape == (2, 2, 32, 64)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, 64, (4, 16)))
    targets = torch.from_numpy(rng.integers(0, 64, (4, 16)))
    mask = torch.ones(4, 16)

    def run(m):
        auxes = []
        logits = m(tokens, moe_aux=auxes)
        lb, _, metrics = moe_objective(auxes)
        ce, _, n = masked_ce_sums(logits, targets, mask)
        loss = ce / n + 0.01 * lb
        loss.backward()
        if isinstance(logits, VocabShards):
            logits = logits.gathered()
        return float(loss), logits.detach(), metrics

    loss, logits, metrics = run(model)
    ref_loss, ref_logits, ref_metrics = run(whole)
    assert abs(loss - ref_loss) <= 1e-5
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), **TOL)
    for k in AUX_NAMES:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                   **TOL, err_msg=k)
    grads = gather_state_dict({n: p.grad for n, p in
                               model.named_parameters()}, model)
    for n, p in whole.named_parameters():
        np.testing.assert_allclose(grads[n].numpy(), p.grad.numpy(), **TOL,
                                   err_msg=n)


@pytest.mark.parametrize("shape", [dict(data=2, model=2, expert=2),
                                   dict(data=4, expert=2),
                                   dict(data=1, seq=2, model=2, expert=2)])
def test_ranks_sit_where_jax_places_its_devices(shape):
    """Rank r sits at device r's (data, seq, model, expert) coordinate of
    JAX's mesh (expert innermost), and the replica index is its (data,
    seq) place."""
    jm = make_mesh(JaxMesh(**shape))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(ids.size):
        (d, _, s, m, e), = np.argwhere(ids == r)
        mesh = Mesh(rank=r, **{k: shape.get(k, 1) for k in
                               ("data", "seq", "model", "expert")})
        assert (mesh.data_index, mesh.seq_index, mesh.model_index,
                mesh.expert_index) == (d, s, m, e)
        assert mesh.replica_index == d * mesh.seq + s


def test_remat_takes_the_router_sums_from_the_forward():
    """Under ``remat`` (dropout on) every MoE layer reports its sums once
    and the gradients of the objective equal the plain run's."""
    tokens = torch.randint(0, 64, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    grads = []
    for remat in (False, True):
        model = ttr.moe_lm("tiny", remat=remat, dropout_rate=0.1)
        model.init_weights(torch.Generator().manual_seed(0))
        auxes = []
        out = model(tokens, train=True, moe_aux=auxes,
                    generator=torch.Generator().manual_seed(1))
        assert len(auxes) == model.cfg.n_layers
        lb, z, _ = moe_objective(auxes)
        (out.square().mean() + lb + z).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


# --- the config surface -----------------------------------------------------

@pytest.mark.parametrize("argv", [["--moe-top-k", "1"],
                                  ["--moe-capacity-factor", "2"],
                                  ["--mesh.expert", "2"],
                                  ["--model", "moe_lm"],
                                  ["--moe-experts", "4"]])
def test_moe_flags_parse_to_the_jax_values(argv):
    base = ["--model", "gpt_lm", "--device", "cpu"]
    cfg, jcfg = parse_args(base + argv), jax_parse_args(base[:2] + argv)
    for name in ("model", "moe_experts", "moe_top_k", "moe_capacity_factor",
                 "moe_group_len", "moe_dispatch", "moe_aux_weight",
                 "moe_zloss_weight"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.mesh.expert == jcfg.mesh.expert


BAD = [dict(moe_experts=-1), dict(model="moe_lm", moe_top_k=0),
       dict(moe_experts=2, moe_top_k=3),
       dict(model="moe_lm", moe_capacity_factor=0.0),
       dict(model="moe_lm", moe_dispatch="sorted"),
       dict(model="moe_lm", moe_group_len=-1),
       dict(model="moe_lm", seq_len=128, moe_group_len=48),
       dict(model="mnist_cnn", moe_experts=4),
       dict(model="moe_lm", mlp_variant="swiglu"),
       dict(model="moe_lm", moe_aux_weight=-1.0)]


@pytest.mark.parametrize("fields", BAD, ids=[str(i) for i in range(len(BAD))])
def test_moe_checks_raise_the_jax_messages(fields):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**fields).validate()
    with pytest.raises(ValueError) as err:
        TrainConfig(**fields, device="cpu").validate()
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("fields", [
    dict(model="moe_lm", optimizer="adafactor", mesh=MeshConfig(expert=2)),
    dict(model="moe_lm", mode="generate", checkpoint_dir="d", prompt="1",
         mesh=MeshConfig(expert=2)),
    dict(model="mnist_cnn", mesh=MeshConfig(expert=2))])
def test_what_stays_out_names_the_roadmap(fields):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(**fields, device="cpu").validate()


def test_serve_refuses_an_expert_mesh_as_jax():
    with pytest.raises(ValueError, match="pure data") as err:
        TrainConfig(model="moe_lm", mode="serve",
                    mesh=MeshConfig(expert=2)).validate()
    with pytest.raises(ValueError) as jerr:
        JaxConfig(model="moe_lm", mode="serve",
                  mesh=JaxMesh(expert=2)).validate()
    assert str(err.value) == str(jerr.value)


# --- optimizer leaves -------------------------------------------------------

WIDE = dict(d_model=128, n_heads=4, d_ff=256, vocab_size=256, max_len=32,
            moe_experts=2, moe_top_k=1)


def test_decay_mask_decays_the_moe_leaves_as_jax():
    jparams = nn.meta.unbox(jax.eval_shape(
        jtr.gpt_lm(size="tiny", moe_experts=4).init, jax.random.key(0),
        jnp.zeros((1, 8), jnp.int32))["params"])
    jmask = jax.tree_util.tree_map(
        lambda m: np.full((1,), m, np.float32), joptim.decay_mask(jparams))
    want = {n: bool(v[0]) for n, v in interop.params_from_flax(jmask).items()}
    got = toptim.decay_mask(ttr.gpt_lm("tiny", moe_experts=4))
    assert got == want
    assert got["layer_0.moe_mlp.wi"] and got["layer_0.moe_mlp.gate"]


def test_adafactor_keeps_the_expert_dim_as_optax():
    """3 Adafactor steps (weight decay on) on a MoE model whose experts
    factor ([E, 128, 256]: v_row [E, 128], v_col [E, 256]) follow the
    JAX package's optimizer to 1e-4 in loss, params and statistics."""
    fields = dict(optimizer="adafactor", learning_rate=1e-2,
                  weight_decay=0.1)
    jmodel = jtr.gpt_lm(size="tiny", compute_dtype=jnp.float32,
                        dropout_rate=0.0, **WIDE)
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    model = ttr.gpt_lm("tiny", compute_dtype=torch.float32,
                       dropout_rate=0.0, **WIDE)
    model.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    jtx = joptim.make_optimizer(JaxConfig(model="gpt_lm", **fields))
    jstate = jtx.init(params)
    tx = toptim.make_optimizer(TrainConfig(model="gpt_lm", **fields), model)
    tparams = dict(model.named_parameters())
    tstate = tx.init(tparams)
    assert tstate["v_row"]["layer_0.moe_mlp.wi"].shape == (2, 128)
    assert tstate["v_col"]["layer_0.moe_mlp.wi"].shape == (2, 256)

    def jloss(p, batch):
        logits, _ = jmodel.apply({"params": p}, batch[0],
                                 mutable=["moe_aux"])
        return jax_masked_ce(logits, batch[1], batch[2])

    jgrad = jax.jit(jax.value_and_grad(jloss))
    jupdate = jax.jit(jtx.update)
    rng = np.random.default_rng(0)
    for step in range(3):
        batch = (rng.integers(0, 256, (2, 32)).astype(np.int32),
                 rng.integers(0, 256, (2, 32)).astype(np.int32),
                 (rng.random((2, 32)) < 0.9).astype(np.float32))
        jl, grads = jgrad(params, batch)
        updates, jstate = jupdate(grads, jstate, params)
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
    core = jax.device_get(jstate[0])
    for key in ("v_row", "v_col"):
        got = interop._stats_to_flax(tstate[key], model)
        np.testing.assert_allclose(got["layer_0"]["moe_mlp"]["wi"],
                                   getattr(core, key)["layer_0"]["moe_mlp"][
                                       "wi"], rtol=1e-4)
