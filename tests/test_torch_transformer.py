"""PyTorch port: the GPT model against the flax model on shared weights.

The flax ``gpt_lm`` is initialized, its param tree is carried into the
port with ``interop.params_from_flax``, and both compute logits, the
masked cross-entropy and every gradient on the same numpy tokens.
Tolerances: f32 atol 1e-5; bf16 compute atol 2e-2 (both frameworks
round to bf16, at different places).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.ops.losses import (
    masked_softmax_cross_entropy as jax_masked_ce)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.models import MODEL_NAMES, build_model
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.ops.losses import (
    masked_softmax_cross_entropy)
from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    StackedRing)
from torch_threads import _one_thread  # noqa: F401


DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _run_both(size, dtype_name, batch, seq, **overrides):
    jdt, tdt, atol = DTYPES[dtype_name]
    jmodel = jtr.gpt_lm(size=size, compute_dtype=jdt, dropout_rate=0.0,
                        **overrides)
    tmodel = ttr.gpt_lm(size=size, compute_dtype=tdt, dropout_rate=0.0,
                        **overrides)
    vocab = jmodel.cfg.vocab_size
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)
    targets = rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)
    mask = (rng.random((batch, seq)) < 0.8).astype(np.float32)
    params = nn.meta.unbox(jax.jit(lambda k: jmodel.init(
        k, tokens, train=False))(jax.random.key(0))["params"])

    def jloss(p):
        logits = jmodel.apply({"params": p}, tokens, train=False)
        return jax_masked_ce(logits, targets, mask), logits

    (j_loss, j_logits), j_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)

    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    t_logits = tmodel(torch.from_numpy(tokens))
    t_loss = masked_softmax_cross_entropy(
        t_logits, torch.from_numpy(targets), torch.from_numpy(mask))
    t_loss.backward()
    t_grads = {n: p.grad for n, p in tmodel.named_parameters()}
    want_grads = interop.params_from_flax(jax.device_get(j_grads))
    return (atol, (t_logits.detach(), np.asarray(j_logits, np.float32)),
            (float(t_loss.detach()), float(j_loss)), t_grads, want_grads)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_tiny_gpt_logits_loss_grads_match_flax(dtype_name):
    atol, (t_logits, j_logits), (t_loss, j_loss), grads, want = _run_both(
        "tiny", dtype_name, batch=2, seq=16)
    np.testing.assert_allclose(t_logits.numpy(), j_logits, atol=atol)
    assert abs(t_loss - j_loss) <= atol
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_full_width_one_layer_matches_flax(dtype_name):
    """GPT-2-small widths (vocab 50257, d 768, 12 heads of 64, d_ff
    3072) with one layer and L=64: pins the converter at full-width
    shapes, and (head dim 64, L a tile multiple) runs attention through
    the flash path's plain versions."""
    atol, (t_logits, j_logits), (t_loss, j_loss), grads, want = _run_both(
        "small", dtype_name, batch=2, seq=64, n_layers=1, max_len=64)
    assert t_logits.shape == (2, 64, 50257)
    np.testing.assert_allclose(t_logits.numpy(), j_logits, atol=atol)
    assert abs(t_loss - j_loss) <= atol
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_tied_gpt_from_flax_matches_logits_and_grads(dtype_name):
    """The tied head (logits = x @ tok_emb.T in the compute dtype, no
    lm_head): a flax tree without lm_head loads through params_from_flax
    and the shared table's grad sums both of its uses."""
    atol, (t_logits, j_logits), (t_loss, j_loss), grads, want = _run_both(
        "tiny", dtype_name, batch=2, seq=16, tie_embeddings=True)
    assert not any(n.startswith("lm_head") for n in want)
    assert grads.keys() == want.keys()
    np.testing.assert_allclose(t_logits.numpy(), j_logits, atol=atol)
    assert abs(t_loss - j_loss) <= atol
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("tie", [False, True])
def test_features_only_rebuilds_the_logits(tie):
    """features_only hands out exactly the pieces whose product is the
    dense logits (the port of the JAX features-mode check), and matches
    the flax model's pieces on the same weights."""
    jmodel = jtr.gpt_lm(size="tiny", tie_embeddings=tie,
                        compute_dtype=jnp.float32, dropout_rate=0.0)
    tokens = np.arange(8, dtype=np.int32).reshape(2, 4) % 64
    params = jmodel.init(jax.random.key(0), tokens)
    j_feats, j_w, j_b, v_axis = jmodel.apply(params, tokens,
                                             features_only=True)
    model = ttr.gpt_lm(size="tiny", tie_embeddings=tie, dropout_rate=0.0)
    model.load_state_dict(interop.params_from_flax(
        jax.device_get(nn.meta.unbox(params["params"]))))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
        feats, w, b = model(torch.from_numpy(tokens), features_only=True)
        rebuilt = feats @ w.T + (0.0 if b is None else b)
    assert (b is None) == tie and w.shape == (64, 32)
    np.testing.assert_allclose(rebuilt.numpy(), logits.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(j_feats),
                               atol=1e-5)
    j_w = np.asarray(j_w) if v_axis == 0 else np.asarray(j_w).T
    np.testing.assert_allclose(w.detach().numpy(), j_w, atol=1e-6)


def test_param_names_and_shapes_mirror_flax_tree():
    jmodel = jtr.gpt_lm(size="tiny")
    params = nn.meta.unbox(jax.eval_shape(lambda k: jmodel.init(
        k, jnp.zeros((1, 8), jnp.int32), train=False),
        jax.random.key(0))["params"])
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  params)
    sd = interop.params_from_flax(tree)
    tmodel = ttr.gpt_lm(size="tiny")
    assert {n: tuple(p.shape) for n, p in tmodel.named_parameters()} == {
        n: tuple(t.shape) for n, t in sd.items()}


def test_qkv_and_out_kernel_layouts():
    """DenseGeneral kernels [D,3,H,dh] and [H,dh,D] become Linear's
    [out, in] with the flax contraction order."""
    D, H, dh = 6, 2, 3
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(D, 3, H, dh)).astype(np.float32)
    out = rng.normal(size=(H, dh, D)).astype(np.float32)
    sd = interop.params_from_flax({"attn": {
        "qkv": {"kernel": qkv, "bias": np.zeros((3, H, dh), np.float32)},
        "out": {"kernel": out, "bias": np.zeros((D,), np.float32)}}})
    x = rng.normal(size=(D,)).astype(np.float32)
    np.testing.assert_allclose(
        (sd["attn.qkv.weight"].numpy() @ x).reshape(3, H, dh),
        np.einsum("d,dthe->the", x, qkv), rtol=1e-5)
    y = rng.normal(size=(H, dh)).astype(np.float32)
    np.testing.assert_allclose(sd["attn.out.weight"].numpy() @ y.reshape(-1),
                               np.einsum("he,hed->d", y, out), rtol=1e-5)


def test_init_matches_flax_initializers():
    model = ttr.gpt_lm(size="tiny")
    model.init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert abs(float(sd["tok_emb.weight"].std()) - 0.02) < 0.005
    assert abs(float(sd["layer_0.mlp.up.weight"].std()) - 0.02) < 0.005
    assert torch.all(sd["layer_0.attn.qkv.bias"] == 0)
    assert torch.all(sd["ln_f.weight"] == 1)
    assert torch.all(sd["ln_f.bias"] == 0)
    again = ttr.gpt_lm(size="tiny")
    again.init_weights(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(sd.values(), again.state_dict().values()))


def test_configs_mirror_jax():
    jcfg = jtr.gpt2_small_config()
    tcfg = ttr.gpt2_small_config()
    for field in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
                  "max_len", "causal", "attn_window"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert ttr.GPT2_SIZES == jtr.GPT2_SIZES
    tiny_j, tiny_t = jtr.tiny_config(), ttr.tiny_config()
    for f in dataclasses.fields(tiny_t):
        if f.name != "compute_dtype" and hasattr(tiny_j, f.name):
            assert getattr(tiny_t, f.name) == getattr(tiny_j, f.name), f.name


@pytest.mark.parametrize("override", [
    {"moe_experts": 8, "shard_vocab": True}, {"moe_experts": 4},
    {"kv_cache_quant": "int8", "moe_experts": 2}])
def test_unported_options_raise(override):
    """MoE is ported: each combination builds on one process; with a
    sequence ring (``--mesh.seq``) it is refused naming ROADMAP.md A5."""
    assert ttr.gpt_lm(size="tiny", **override).cfg.moe_experts > 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.gpt_lm(size="tiny", ring=StackedRing(2), **override)


@pytest.mark.parametrize("override", [
    {"pos_emb": "rope"}, {"n_kv_heads": 2}, {"mlp_variant": "swiglu"},
    {"norm": "rmsnorm"}, {"remat": True}])
def test_ported_options_build_the_flax_tree(override):
    """Each option the port once refused builds, and its param names and
    shapes are the flax tree's (rope: no pos_emb table; GQA: q and kv
    instead of qkv; swiglu: mlp/gate; rmsnorm: scale-only norms)."""
    jmodel = jtr.gpt_lm(size="tiny", **override)
    params = nn.meta.unbox(jax.eval_shape(lambda k: jmodel.init(
        k, jnp.zeros((1, 8), jnp.int32), train=False),
        jax.random.key(0))["params"])
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  params)
    want = {n: tuple(t.shape)
            for n, t in interop.params_from_flax(tree).items()}
    tmodel = ttr.gpt_lm(size="tiny", **override)
    assert {n: tuple(p.shape) for n, p in tmodel.named_parameters()} == want


def test_registry():
    assert MODEL_NAMES == ("mnist_cnn", "resnet20", "resnet50", "bert_mlm",
                           "gpt_lm", "moe_lm", "pipelined_lm")
    m = build_model("gpt_lm", size="tiny", compute_dtype=torch.float32)
    assert isinstance(m, ttr.CausalLM) and m.cfg.causal
    cnn = build_model("mnist_cnn", dropout_rate=0.5, init_scheme="reference")
    assert (cnn.dropout_rate, cnn.init_scheme) == (0.5, "reference")
    bert = build_model("bert_mlm", size="tiny")
    assert isinstance(bert, ttr.BertMLM) and not bert.cfg.causal
    moe = build_model("moe_lm", size="tiny")
    assert moe.cfg.moe_experts == ttr.MOE_DEFAULT_EXPERTS and moe.cfg.causal
    piped = build_model("pipelined_lm", size="tiny")
    assert piped.cfg.n_layers == 4 and piped.cfg.causal
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("vit")


def test_dropout_keeps_expected_fraction():
    model = ttr.gpt_lm(size="tiny", dropout_rate=0.5)
    model.init_weights(torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 16), dtype=torch.long)
    a = model(tokens, train=True, generator=torch.Generator().manual_seed(1))
    b = model(tokens, train=True, generator=torch.Generator().manual_seed(1))
    c = model(tokens, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model(tokens, train=True)
