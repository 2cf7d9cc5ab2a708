"""PyTorch port: the int8 decode cache and prefill at an offset, against
the JAX package (tiny GPT, f32 compute, weights carried from JAX).

- ``kv_cache_quant="int8"``, MHA and ``n_kv_heads=2``: the prefill and
  teacher-forced decode caches equal JAX's (int8 leaves equal but for a
  step of one at a rounding tie in at most 0.1% of the entries, the
  count reported; the f32 scales within rtol 1e-6), the logits within
  1e-5 of JAX's, and within 5e-2 of the port's own unquantized training
  forward (JAX's tests/test_generate.py bound); ``generate`` and
  ``beam_search`` over the int8 cache give JAX's tokens exactly.
- The int8 dense slot engine under the scheduler gives JAX's streams,
  and its cache costs 2·Dh·2 / (2·Dh + 8) = 1.882x fewer bytes a slot
  than bf16 at head dim 64 (tests/test_serve_slo.py's ratio).
- ``prefill_cache(positions=m + arange(P))`` equals JAX's cache and
  logits within 1e-5, a write clamped back at ``max_len`` included.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.models import generate as jgen
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu.serve.engine import (
    SlotDecodeEngine as JaxEngine)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.models import generate as tgen
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from torch_threads import _one_thread  # noqa: F401


TOL = 1e-5          # port vs JAX, f32
TOL_FULL = 5e-2     # int8 decode vs the unquantized forward (JAX's bound)


def _pair(**kw):
    jmodel = jtr.CausalLM(jtr.tiny_config(causal=True,
                                          compute_dtype=jnp.float32, **kw))
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32, **kw)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def _check_cache(got, want, what):
    """int8 leaves equal but for rounding ties; scales within rtol 1e-6;
    float leaves within TOL."""
    assert len(got.leaves()) == len(want.leaves())
    for t, j in zip(got.leaves(), want.leaves()):
        assert t.shape == j.shape and t.dtype == j.dtype
        if t.dtype == torch.int8:
            diff = (t.int() - j.int()).abs()
            off = int((diff > 0).sum())
            print(f"{what}: {off} of {diff.numel()} int8 entries one step off")
            assert int(diff.max()) <= 1 and off <= 1e-3 * diff.numel()
        elif got.k_scale is not None and t.dim() == 3:
            torch.testing.assert_close(t, j, rtol=1e-6, atol=0)
        else:
            torch.testing.assert_close(t, j, rtol=0, atol=TOL)


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2}], ids=["mha", "gqa"])
def test_int8_decode_equals_jax_and_tracks_the_full_forward(kw):
    jm, params, tm = _pair(kv_cache_quant="int8", **kw)
    assert tm.cfg.kv_cache_quant == "int8"
    tokens = np.random.default_rng(5).integers(0, 64, (2, 10)).astype(
        np.int32)
    with torch.no_grad():
        full = tm(torch.from_numpy(tokens).long())
    jl, jcache = jgen.prefill_cache(jm, params, jnp.asarray(tokens[:, :4]))
    tl, tcache = tgen.prefill_cache(tm, torch.from_numpy(tokens[:, :4]).long())
    assert tcache.k[0].dtype == torch.int8
    assert tcache.k_scale[0].shape == (2, 128, kw.get("n_kv_heads", 4))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _check_cache(tcache, interop.cache_from_flax(jax.device_get(jcache)),
                 "prefill")
    errs = [float((tl[:, -1] - full[:, 3]).abs().max()
                  / full[:, 3].abs().max())]
    for i in range(4, 10):
        tok = tokens[:, i]
        jlast, jcache = jgen.decode_token(jm, params, jcache,
                                          jnp.asarray(tok), jnp.asarray([i]))
        tlast, tcache = tgen.decode_token(tm, tcache,
                                          torch.from_numpy(tok).long(), [i])
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0,
                                   atol=TOL)
        errs.append(float((tlast - full[:, i]).abs().max()
                          / full[:, i].abs().max()))
    _check_cache(tcache, interop.cache_from_flax(jax.device_get(jcache)),
                 "decode")
    assert max(errs) <= TOL_FULL, errs
    assert max(errs) > 0  # the cache really is quantized


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2, "pos_emb": "rope",
                                     "attn_window": 6}],
                         ids=["mha", "gqa_rope_window"])
def test_int8_generate_and_beam_search_equal_jax(kw):
    jm, params, tm = _pair(kv_cache_quant="int8", max_len=32, **kw)
    prompt = np.random.default_rng(2).integers(0, 64, (2, 5)).astype(
        np.int32)
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(prompt), 12))
    got = tgen.generate(tm, torch.from_numpy(prompt).long(), 12)
    np.testing.assert_array_equal(got.numpy(), want)
    jseq, jsc = jgen.beam_search(jm, params, jnp.asarray(prompt), 8,
                                 num_beams=3)
    tseq, tsc = tgen.beam_search(tm, torch.from_numpy(prompt).long(), 8,
                                 num_beams=3)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0,
                               atol=TOL)


def test_int8_engine_equals_jax_and_thins_the_cache():
    jm, params, tm = _pair(kv_cache_quant="int8", max_len=48)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (8, 3, 14, 9)]
    eng = SlotDecodeEngine(tm, 2)
    tdone = {c.rid: c.tokens for c in tsched.Scheduler(eng, 2).run(
        [tsched.Request(rid=i, prompt=p, max_new_tokens=7)
         for i, p in enumerate(prompts)])}
    jeng = JaxEngine(jm, params, 2)
    jdone = {c.rid: c.tokens for c in jsched.Scheduler(jeng, 2).run(
        [jsched.Request(rid=i, prompt=p, max_new_tokens=7)
         for i, p in enumerate(prompts)])}
    assert tdone == jdone
    assert eng.cache_bytes_per_slot() == jeng.cache_bytes_per_slot()
    # Head dim 64: K and V of a token-head are 2 x 64 x 2 B in bf16 and
    # 2 x 64 x 1 B + 2 x 4 B of scales in int8.
    wide = dict(d_model=64, n_heads=1, d_ff=128, max_len=48)
    b16 = ttr.gpt_lm("tiny", compute_dtype=torch.bfloat16, **wide)
    q8 = ttr.gpt_lm("tiny", compute_dtype=torch.bfloat16,
                    kv_cache_quant="int8", **wide)
    ratio = (SlotDecodeEngine(b16, 2).cache_bytes_per_slot()
             / SlotDecodeEngine(q8, 2).cache_bytes_per_slot())
    assert ratio == pytest.approx(2 * 64 * 2 / (2 * 64 + 8))
    assert ratio >= 1.8


def test_q8_rounds_half_to_even_and_clips_like_jax():
    """Rows whose absmax is 127 have scale 1, so x / scale lands on the
    ties: half to even (0.5 -> 0, -2.5 -> -2, 1.5 -> 2); an all-zero row
    takes the 1e-8 floor. The same formula in jnp gives the same."""
    x = np.array([[[[1.0, -2.5, 0.5, 127.0], [0.0, 0.0, 0.0, 0.0],
                    [1.5, 2.5, -0.5, -127.0]]]], np.float32)
    tq, ts = ttr.q8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.shape == (1, 1, 3)
    np.testing.assert_array_equal(tq[0, 0].numpy(), [[1, -2, 0, 127],
                                                     [0, 0, 0, 0],
                                                     [2, 2, 0, -127]])
    scale = jnp.maximum(jnp.max(jnp.abs(x), axis=-1) / 127.0, 1e-8)
    jq = jnp.clip(jnp.round(x / scale[..., None]), -127, 127)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).astype(np.int8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(scale))


@pytest.mark.parametrize("kw,m,P", [({}, 9, 12), ({}, 0, 20),
                                    ({"pos_emb": "rope"}, 50, 20),
                                    ({"pos_emb": "rope", "n_kv_heads": 2,
                                      "kv_cache_quant": "int8"}, 57, 16)],
                         ids=["learned", "learned_zero", "rope_clamped",
                              "gqa_int8_clamped"])
def test_prefill_at_an_offset_equals_jax(kw, m, P):
    """Explicit positions m .. m + P - 1 into a fresh cache of max_len 64;
    where m + P > 64 both packages clamp the write back to 64 - P."""
    jm, params, tm = _pair(max_len=64, **kw)
    tokens = np.random.default_rng(m).integers(0, 64, (2, P)).astype(np.int32)
    pos = m + np.arange(P)[None]
    jl, jcache = jgen.prefill_cache(jm, params, jnp.asarray(tokens),
                                    jnp.asarray(pos))
    tl, tcache = tgen.prefill_cache(tm, torch.from_numpy(tokens).long(),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _check_cache(tcache, interop.cache_from_flax(jax.device_get(jcache)),
                 "offset prefill")
    start = min(m, 64 - P)
    assert bool(tcache.k[0][:, start:start + P].abs().sum() > 0)
    if start:
        assert float(tcache.k[0][:, :start].abs().sum()) == 0.0
