"""PyTorch port: the decode-cache path and ``models/generate.py`` against
the JAX package on shared weights.

The flax ``gpt_lm`` (tiny, f32) is initialized, its params are carried
into the port with ``interop.params_from_flax``, and both packages run
the same numpy-seeded tokens: prefill, then single-token decode steps
at per-row positions (rows at different depths) or at one position for
every row. Logits and cache contents agree within rtol 1e-5 / atol
1e-5 (the cache read back through ``interop.cache_from_flax``); greedy
streams and the top-k / top-p masks are identical. The two packages'
samplers draw from different RNGs, so sampling is held to its support
and to determinism under a fixed generator, as the JAX test holds it.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.models import generate as jgen
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.models import generate as tgen
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from torch_threads import _one_thread  # noqa: F401


TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(window=0, seed=0):
    """The tiny causal LM in both packages, on the same f32 weights."""
    kw = dict(compute_dtype=jnp.float32, dropout_rate=0.0,
              attn_window=window)
    jmodel = jtr.gpt_lm(size="tiny", **kw)
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32,
                        dropout_rate=0.0, attn_window=window)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def _tokens(rng, shape):
    return rng.integers(0, 64, size=shape).astype(np.int32)


def _assert_cache_equal(tcache, jcache):
    want = interop.cache_from_flax(jax.device_get(jcache))
    assert len(want.k) == len(tcache.k)
    for got, ref in zip(tcache.k + tcache.v, want.k + want.v):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_at_per_row_depths_matches_jax(window):
    """Prefill three rows, then decode six steps with the rows at three
    different depths ([B] positions): the row at 7 rewrites columns of
    its prefill that the mask had hidden, the row at 4 more of them."""
    jmodel, params, tmodel = _pair(window)
    rng = np.random.default_rng(0)
    prompt = _tokens(rng, (3, 10))
    jlogits, jcache = jgen.prefill_cache(jmodel, params, jnp.asarray(prompt))
    tlogits, tcache = tgen.prefill_cache(tmodel, torch.from_numpy(prompt))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _assert_cache_equal(tcache, jcache)
    depth = np.asarray([10, 7, 4], np.int32)
    for t in range(6):
        tok = _tokens(rng, (3,))
        jlast, jcache = jgen.decode_token(jmodel, params, jcache,
                                          jnp.asarray(tok),
                                          jnp.asarray(depth + t))
        tlast, tcache = tgen.decode_token(tmodel, tcache,
                                          torch.from_numpy(tok),
                                          torch.from_numpy(depth + t))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   err_msg=f"step {t}", **TOL)
    _assert_cache_equal(tcache, jcache)


def test_one_position_broadcasts_to_every_row_as_in_jax():
    """A [1] position (``generate()``'s lockstep rows) writes every row
    at that depth, exactly as JAX's [1, L] broadcast does."""
    jmodel, params, tmodel = _pair()
    rng = np.random.default_rng(1)
    prompt = _tokens(rng, (2, 6))
    _, jcache = jgen.prefill_cache(jmodel, params, jnp.asarray(prompt))
    _, tcache = tgen.prefill_cache(tmodel, torch.from_numpy(prompt))
    for t in range(3):
        tok = _tokens(rng, (2,))
        jlast, jcache = jgen.decode_token(jmodel, params, jcache,
                                          jnp.asarray(tok),
                                          jnp.asarray([6 + t]))
        tlast, tcache = tgen.decode_token(tmodel, tcache,
                                          torch.from_numpy(tok),
                                          torch.tensor([6 + t]))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _assert_cache_equal(tcache, jcache)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_matches_the_training_forward(window):
    """Teacher-forced decode through the cache reproduces the port's
    ordinary causal forward position by position (JAX's
    test_decode_logits_match_full_forward, on the port)."""
    _, _, model = _pair(window)
    tokens = torch.from_numpy(_tokens(np.random.default_rng(2), (2, 12)))
    with torch.no_grad():
        full = model(tokens)
    logits, cache = tgen.prefill_cache(model, tokens[:, :5])
    torch.testing.assert_close(logits, full[:, :5], atol=1e-5, rtol=1e-5)
    for t in range(5, 12):
        last, cache = tgen.decode_token(model, cache, tokens[:, t],
                                        torch.tensor([t]))
        torch.testing.assert_close(last, full[:, t], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("top_k", [0, 1, 2, 5, 63, 64, 100])
@pytest.mark.parametrize("top_p", [1e-6, 0.3, 0.6, 0.9, 1.0])
def test_filter_logits_masks_equal_jax(top_k, top_p):
    logits = np.random.default_rng(top_k).normal(
        0, 2, size=(4, 64)).astype(np.float32)
    got = tgen._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    want = np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k, top_p))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window,plens", [(0, (1, 7, 33)), (6, (20,))])
def test_greedy_generate_is_token_identical_to_jax(window, plens):
    jmodel, params, tmodel = _pair(window, seed=3)
    rng = np.random.default_rng(3)
    for plen in plens:
        prompt = _tokens(rng, (2, plen))
        want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(prompt),
                                        12))
        got = tgen.generate(tmodel, torch.from_numpy(prompt), 12).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"prompt {plen}")


def test_sampling_support_and_determinism():
    _, _, model = _pair()
    prompt = torch.tensor([[1, 2, 3, 4]])
    greedy = tgen.generate(model, prompt, 8)
    # top_k=1 (or a vanishing nucleus) at any temperature IS greedy.
    for kw in (dict(top_k=1), dict(top_p=1e-6)):
        got = tgen.generate(model, prompt, 8, temperature=1.7,
                            generator=torch.Generator().manual_seed(5), **kw)
        torch.testing.assert_close(got, greedy)
    # A fixed generator repeats its draw.
    runs = [tgen.generate(model, prompt, 8, temperature=1.0, top_k=5,
                          generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1])
    # The first token always lies in the top-k of the prefill's logits.
    logits, _ = tgen.prefill_cache(model, prompt)
    top3 = set(torch.topk(logits[0, -1], 3).indices.tolist())
    for seed in range(20):
        tok = tgen.generate(model, prompt, 1, temperature=2.0, top_k=3,
                            generator=torch.Generator().manual_seed(seed))
        assert int(tok[0, 0]) in top3


@pytest.mark.parametrize("kw,match", [
    (dict(temperature=1.0, top_p=0.0, generator=torch.Generator()), "top_p"),
    (dict(temperature=1.0, top_k=-1, generator=torch.Generator()), "top_k"),
    (dict(temperature=1.0), "Generator"),
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(max_new_tokens=200), "max_len"),
])
def test_generate_argument_checks(kw, match):
    _, _, model = _pair()
    with pytest.raises(ValueError, match=match):
        tgen.generate(model, torch.tensor([[1, 2]]),
                      **{"max_new_tokens": 4, **kw})


def test_decode_refusals():
    _, _, model = _pair()
    tok = torch.tensor([[1]])
    cache = ttr.KVCache.zeros(model.cfg, 1)
    with pytest.raises(ValueError, match="positions"):
        model(tok, decode=True, cache=cache)
    with pytest.raises(ValueError, match="KVCache"):
        model(tok, decode=True, positions=torch.tensor([[0]]))
    with pytest.raises(ValueError, match="decode=True"):
        model(tok, cache=cache)
    # A page table is read only by a paged config's decode branch.
    with pytest.raises(ValueError, match="kv_page_size"):
        model(tok, decode=True, positions=torch.tensor([[0]]), cache=cache,
              page_table=torch.zeros((1, 8), dtype=torch.long))
    # Prefill at an offset is ported: position 3 of a fresh cache.
    logits, offset = tgen.prefill_cache(model, tok,
                                        positions=torch.tensor([[3]]))
    assert bool(offset.k[0][:, 3].abs().sum() > 0)
    assert float(offset.k[0][:, :3].abs().sum()) == 0.0
    bert = ttr.TransformerLM(ttr.tiny_config())
    with pytest.raises(ValueError, match="causal"):
        bert(tok, decode=True, positions=torch.tensor([[0]]), cache=cache)
    # The int8 cache and mixture-of-experts are ported: a MoE model
    # (with either cache) builds and decodes.
    assert ttr.gpt_lm("tiny", kv_cache_quant="int8").cfg.kv_cache_quant == (
        "int8")
    with pytest.raises(ValueError, match="kv_cache_quant"):
        ttr.gpt_lm("tiny", kv_cache_quant="int4")
    for kw in (dict(kv_cache_quant="int8", moe_experts=4),
               dict(moe_experts=4)):
        moe = ttr.gpt_lm("tiny", **kw)
        moe.init_weights(torch.Generator().manual_seed(0))
        assert moe.cfg.moe_experts == 4
        out = tgen.generate(moe, tok, 3)
        assert out.shape == (1, 3)


def test_cast_dense_weights_keeps_the_logits():
    """Holding the dense weights in the compute dtype changes no value
    the model computes with (bf16: the per-call cast and the held copy
    round the same f32 weights)."""
    _, _, ref = _pair()
    model = ttr.gpt_lm("tiny", compute_dtype=torch.bfloat16)
    model.load_state_dict(ref.state_dict())
    tokens = torch.from_numpy(_tokens(np.random.default_rng(4), (2, 9)))
    with torch.no_grad():
        before = model(tokens)
        ttr.cast_dense_weights_(model)
        after = model(tokens)
    assert model.layer_0.attn.qkv.weight.dtype == torch.bfloat16
    assert model.tok_emb.weight.dtype == torch.float32
    assert model.ln_f.weight.dtype == torch.float32
    torch.testing.assert_close(after, before, rtol=0, atol=0)
