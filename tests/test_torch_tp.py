"""PyTorch port: Megatron tensor parallelism's modules against the
port's unsharded modules and the flax modules, on the CPU.

``StackedTP(M)`` (all M model ranks in one process) for M 2 and 4, on
the same flax params, in f32 at 1e-5: ``SelfAttention`` (MHA, and GQA
with 4 K/V heads), ``Mlp`` (gelu and swiglu), the ``--shard-vocab``
embedding with tied logits, and the untied head of a vocabulary that M
does not divide (its parts padded in the forward). Outputs and every
gradient, gathered back to the whole parameters, match. The shard and
gather of a state dict round-trip exactly; the model ranks of one
(data, seq) place draw one dropout mask; the ranks of a
(data, seq, model) world sit where JAX's row-major mesh puts them; and
the config refuses what JAX refuses, with JAX's messages.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.ops.losses import (
    masked_softmax_cross_entropy as jax_masked_ce)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import (
    MeshConfig, TrainConfig, parse_args)
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.ops.losses import masked_ce_sums
from tensorflow_distributed_tpu_torch.parallel import sharding
from tensorflow_distributed_tpu_torch.parallel.mesh import Mesh
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    StackedTP, VocabShards)
from tensorflow_distributed_tpu_torch.train.step import step_seed
from torch_ring_workers import mesh_groups, spawn_ranks
from torch_threads import _one_thread  # noqa: F401


TOL = 1e-5
WIDE = dict(d_model=64, n_heads=8, d_ff=128)  # 8 heads: GQA with 4 K/V


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _flax_grads(module, params, x, g):
    """The flax module's output on ``x`` and the gradient of
    sum(out * g) w.r.t. its params."""
    def f(p):
        out = module.apply({"params": p}, x)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
    return np.asarray(out), interop.params_from_flax(jax.device_get(grads))


def _shard_module(full, prefix, tp, model=None):
    """A module's whole state dict cut for ``tp`` by the TP table (its
    names under ``prefix`` in a model)."""
    out = {}
    for name, t in full.items():
        cut = sharding.param_cut(prefix + name, model)
        out[name] = t if cut is None else torch.stack(
            [sharding.cut_part(t, cut, m, tp.size) for m in tp.indices])
    return out


def _gather_module(grads, prefix, model=None):
    out = {}
    for name, t in grads.items():
        cut = sharding.param_cut(prefix + name, model)
        out[name] = t if cut is None else sharding.join_parts(
            list(t.unbind(0)), cut)
    return out


def _run_port(module, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    out = module(xt)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach(), {n: p.grad for n, p in module.named_parameters()}


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("layer,cfg_kw", [
    ("attn", {}), ("attn", dict(n_kv_heads=4)),
    ("mlp", {}), ("mlp", dict(mlp_variant="swiglu"))],
    ids=["attn_mha", "attn_gqa4", "mlp_gelu", "mlp_swiglu"])
def test_sharded_layers_match_flax_and_the_whole_layer(layer, cfg_kw, M):
    """The layer on M stacked ranks against the flax layer and the
    port's whole layer on the same params: the output and every
    parameter's gradient (gathered) at 1e-5."""
    jcfg = jtr.tiny_config(**WIDE, **cfg_kw, causal=True)
    tcfg = ttr.tiny_config(**WIDE, **cfg_kw, causal=True)
    rng = np.random.default_rng(M)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    g = rng.standard_normal((2, 16, 64)).astype(np.float32)
    jmod = jtr.SelfAttention(jcfg) if layer == "attn" else jtr.Mlp(jcfg)
    params = nn.meta.unbox(jmod.init(jax.random.key(M), x)["params"])
    # Non-zero biases, so that a bias added once per rank would show.
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(params))
    want, want_grads = _flax_grads(jmod, params, x, g)
    full = interop.params_from_flax(params)
    make = ttr.SelfAttention if layer == "attn" else ttr.Mlp
    whole = make(tcfg)
    whole.load_state_dict(full)
    tp = StackedTP(M)
    sharded = make(tcfg, tp=tp) if layer == "mlp" else make(tcfg, None, tp)
    prefix = f"layer_0.{layer}."
    sharded.load_state_dict(_shard_module(full, prefix, tp))
    out_w, grads_w = _run_port(whole, x, g)
    out_s, grads_s = _run_port(sharded, x, g)
    _close(out_w, want, "whole")
    _close(out_s, want, "sharded")
    got = _gather_module(grads_s, prefix)
    assert set(got) == set(want_grads)
    for name in want_grads:
        _close(grads_w[name], want_grads[name], f"whole {name}")
        _close(got[name], want_grads[name], f"sharded {name}")


def _jax_lm(vocab, tie, tokens):
    jm = jtr.gpt_lm(size="tiny", vocab_size=vocab, tie_embeddings=tie,
                    compute_dtype=jnp.float32, dropout_rate=0.0)
    params = nn.meta.unbox(jm.init(jax.random.key(1), tokens)["params"])
    return jm, jax.device_get(params)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("case", ["shard_vocab_tied", "padded_untied"])
def test_vocab_sharded_ends_match_flax(case, M):
    """A tiny GPT of 61 ids on M stacked ranks: with ``shard_vocab`` the
    vocab-parallel lookup and the vocab-sharded tied logits (the table
    padded to a multiple of M rows, as JAX pads it); without, the untied
    head cut into M padded parts. The gathered logits, the masked CE
    (label smoothing 0.1) and every gradient equal flax's whole model's
    on the same params (the padding rows' gradients are zero)."""
    tie = case == "shard_vocab_tied"
    V = 61
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, V, (2, 16)).astype(np.int32)
    targets = rng.integers(0, V, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.8).astype(np.float32)
    jm, params = _jax_lm(V, tie, tokens)

    def jloss(p):
        logits = jm.apply({"params": p}, tokens)
        return jax_masked_ce(logits, targets, mask, 0.1), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    want_grads = interop.params_from_flax(jax.device_get(jgrads))
    tp = StackedTP(M)
    model = ttr.gpt_lm("tiny", tp=tp, vocab_size=V, tie_embeddings=tie,
                       shard_vocab=tie, compute_dtype=torch.float32)
    full = interop.params_from_flax(params)
    pad = model.whole("meta").tok_emb.weight.shape[0] - V
    assert pad == (-V) % M if tie else pad == 0
    full["tok_emb.weight"] = torch.nn.functional.pad(
        full["tok_emb.weight"], (0, 0, 0, pad))
    model.load_state_dict(sharding.shard_state_dict(full, model))
    logits = model(torch.from_numpy(tokens))
    assert isinstance(logits, VocabShards) and logits.rows == -(-V // M)
    ce, _, n = masked_ce_sums(logits, torch.from_numpy(targets),
                              torch.from_numpy(mask), 0.1)
    (ce / n).backward()
    _close(logits.gathered().detach(), jlogits, "logits")
    _close(float((ce / n).detach()), float(jl), "loss")
    got = sharding.gather_state_dict(
        {k: p.grad for k, p in model.named_parameters()}, model)
    assert float(got["tok_emb.weight"][V:].abs().sum()) == 0.0
    got["tok_emb.weight"] = got["tok_emb.weight"][:V]
    for name in want_grads:
        _close(got[name], want_grads[name], name)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("overrides", [
    {}, dict(n_kv_heads=2, mlp_variant="swiglu"),
    dict(shard_vocab=True, vocab_size=61),
    dict(shard_vocab=True, tie_embeddings=True, vocab_size=63),
    dict(vocab_size=61)],
    ids=["mha", "gqa_swiglu", "shard_vocab", "shard_vocab_tied", "padded"])
def test_shard_then_gather_round_trips_exactly(overrides, M):
    """A whole (padded) state dict cut for M ranks and joined back is
    itself, bit for bit; the TP model's seeded init is one process's
    draw, its padding rows zero, cut."""
    tp = StackedTP(M)
    model = ttr.bert_tiny_mlm(tp=tp, **overrides)
    model.init_weights(torch.Generator().manual_seed(M))
    plain = ttr.bert_tiny_mlm(**overrides)
    plain.init_weights(torch.Generator().manual_seed(M))
    full = {n: p.detach().clone()
            for n, p in model.whole().named_parameters()}
    for name, t in plain.state_dict().items():
        full[name].zero_()
        full[name][:t.shape[0]] = t
    local = sharding.shard_state_dict(full, model)
    assert {n: tuple(t.shape) for n, t in local.items()} == {
        n: tuple(p.shape) for n, p in model.state_dict().items()}
    for name, t in model.state_dict().items():
        assert torch.equal(t, local[name]), name
    back = sharding.gather_state_dict(local, model)
    assert set(back) == set(full)
    for name, t in full.items():
        assert torch.equal(back[name], t), name


def test_model_ranks_of_a_place_share_the_dropout_stream():
    """Dropout seeds by the (data, seq) place: the M ranks of a place
    share it, places differ; without a model axis it is the rank."""
    meshes = [Mesh(data=2, seq=2, model=2, rank=r) for r in range(8)]
    places = [m.replica_index for m in meshes]
    assert places == [0, 0, 1, 1, 2, 2, 3, 3]
    seeds = [step_seed(0, p, 7) for p in places]
    assert seeds[0] == seeds[1] and seeds[0] != seeds[2]
    assert [Mesh(data=4, rank=r).replica_index for r in range(4)] == [
        0, 1, 2, 3]
    # StackedTP: one replicated stream, one mask for every rank.
    tp = StackedTP(2)
    model = ttr.gpt_lm("tiny", tp=tp, dropout_rate=0.5)
    model.init_weights(torch.Generator().manual_seed(0))
    whole = model.whole()
    whole.load_state_dict(sharding.gather_state_dict(model.state_dict(),
                                                     model))
    tokens = torch.randint(0, 64, (2, 16))
    a = model(tokens, train=True,
              generator=torch.Generator().manual_seed(3)).gathered()
    b = whole(tokens, train=True, generator=torch.Generator().manual_seed(3))
    _close(a.detach(), b.detach())


@pytest.mark.parametrize("data,seq,model", [(1, 2, 2), (2, 1, 2)])
def test_mesh_groups_follow_the_jax_layout_with_a_model_axis(
        data, seq, model, tmp_path):
    """Rank r sits at model r % M, seq (r // M) % S, data r // (S M)
    (JAX's row-major (data, pipe, seq, model, expert)); the model group
    is M contiguous ranks, the replica group the ranks of one model
    index, and a ring's swap stays in its seq group."""
    spawn_ranks(mesh_groups, 4, tmp_path, data, seq, tmp_path, model)
    jmesh = np.arange(4).reshape(data, 1, seq, model, 1)
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        d, _, s, m, _ = (int(i[0]) for i in np.nonzero(jmesh == r))
        assert (got["data_index"], got["seq_index"],
                got["model_index"]) == (d, s, m)
        assert got["tp_sums"]["model"] == float(sum(jmesh[d, 0, s, :, 0]))
        assert got["tp_sums"]["replica"] == float(jmesh[..., m, :].sum())
        assert got["sums"]["seq"] == float(sum(jmesh[d, 0, :, m, 0]))
        assert got["sums"]["data"] == float(sum(jmesh[:, 0, s, m, 0]))
        if seq > 1:
            assert got["swapped"] == float(jmesh[d, 0, s ^ 1, m, 0])


@pytest.mark.parametrize("fields", [
    dict(ce_chunk=8192, ce_impl="kernel", mesh=dict(model=2)),
    dict(ce_chunk=8192, ce_impl="kernel", shard_vocab=True),
    dict(model="mnist_cnn", shard_vocab=True)],
    ids=["kernel_tp", "kernel_shard_vocab", "shard_vocab_vision"])
def test_config_refuses_what_jax_refuses_with_its_message(fields):
    fields = {"model": "gpt_lm", **fields}
    mesh = fields.pop("mesh", {})
    with pytest.raises(ValueError) as want:
        JaxConfig(**fields, mesh=JaxMesh(**mesh)).validate()
    with pytest.raises(ValueError) as got:
        TrainConfig(**fields, mesh=MeshConfig(**mesh),
                    device="cpu").validate()
    assert str(got.value) == str(want.value)


def test_mesh_model_flag_parses_and_refuses_uneven_shards():
    cfg = parse_args(["--model", "gpt_lm", "--mesh.model", "2",
                      "--shard-vocab", "true", "--ce-chunk", "16",
                      "--device", "cpu"])
    assert (cfg.mesh.model, cfg.shard_vocab) == (2, True)
    assert dataclasses.asdict(MeshConfig()) == {"data": -1, "model": 1,
                                                "seq": 1, "pipe": 1,
                                                "expert": 1}
    with pytest.raises(ValueError, match="must be >= 1"):
        MeshConfig(model=0).validate()
    with pytest.raises(ValueError, match="must divide n_heads"):
        ttr.gpt_lm("tiny", tp=StackedTP(3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(model="resnet20", mesh=MeshConfig(model=2),
                    device="cpu").validate()
