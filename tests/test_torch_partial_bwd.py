"""PyTorch port: the plain partial backward (what the B8 and B9 wrappers
run for CPU tensors) against the JAX package, and the row terms that the
partial and normalized backward kernels now share.

- ``flash_dq_partial_reference`` and ``flash_dkv_partial_reference``
  against the JAX ``_bwd_partial`` called directly in interpret mode
  (blocks of 64) with the same m, f32 dO and dl (m and dl broadcast to
  its ``[BH, L, 8]`` layout): the ring's half-block (L = Lk = 128,
  causal and full) and ragged edges of the kernels' tiles (L 192 / Lk
  128 and L 128 / Lk 320, full).
- The identity the kernels' ``PARTIAL`` flag rests on: the partial
  backward with m = lse, dl = -rowsum(dO * O) and dO in f32 is the
  normalized backward (``flash_dq_reference``, ``flash_dkv_reference``).

Inputs come from numpy seeds; f32, rtol 1e-4 / atol 1e-5 against JAX
(same math, another summation order), atol 1e-5 for the identity. The
kernels themselves run on the card in tests/test_torch_ring_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.ops import flash_attention as jfa
from tensorflow_distributed_tpu_torch.ops import flash_attention as tfa
from torch_threads import _one_thread  # noqa: F401


TOL = dict(rtol=1e-4, atol=1e-5)
BH, D, BLOCK = 4, 64, 64
# name -> (L, Lk, causal)
CASES = {"half_block_causal": (128, 128, True),
         "half_block_full": (128, 128, False),
         "ragged_rows": (192, 128, False),
         "ragged_keys": (128, 320, False)}


def _inputs(L, Lk, seed):
    """q [BH, L, D], k, v [BH, Lk, D], dO [BH, L, D] and dl [BH, L], f32."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(BH, L, D)) * 0.5).astype(np.float32)
    k, v = ((rng.normal(size=(BH, Lk, D)) * 0.5).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(BH, L, D)).astype(np.float32)
    dl = rng.normal(size=(BH, L)).astype(np.float32)
    return q, k, v, do, dl


@pytest.mark.parametrize("name", CASES)
def test_partial_bwd_plain_versions_match_jax_bwd_partial(name):
    L, Lk, causal = CASES[name]
    q, k, v, do, dl = _inputs(L, Lk, sum(map(ord, name)))
    tq, tk, tv, tdo, tdl = (torch.tensor(x) for x in (q, k, v, do, dl))
    # m: the partial forward's row max (the backward takes any m; this
    # one keeps p <= 1, as on the ring's path).
    _, m, _ = tfa.flash_fwd_partial_reference(tq, tk, tv, causal)
    lanes = lambda x: jnp.broadcast_to(jnp.asarray(x)[..., None], x.shape + (8,))
    want = jfa._bwd_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            lanes(m.numpy()), jnp.asarray(do), lanes(dl),
                            causal, BLOCK, BLOCK, True)
    got = (tfa.flash_dq_partial_reference(tq, tk, tv, m, tdo, tdl, causal),
           *tfa.flash_dkv_partial_reference(tq, tk, tv, m, tdo, tdl, causal))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", CASES)
def test_partial_bwd_with_normalized_rows_is_the_normalized_bwd(name):
    """(m, +dl) = (lse, -rowsum(dO * O)) turns the partial backward into
    the normalized one: the row terms B8 and B9 pass where B2 and B3 pass
    (lse, -delta). A sign slip on dl fails here at any |dl|."""
    L, Lk, causal = CASES[name]
    q, k, v, do, _ = (torch.tensor(x) for x in _inputs(L, Lk, 7 + L + Lk))
    out, lse = tfa.flash_attention_reference(q, k, v, causal)
    dl = -(do.float() * out.float()).sum(dim=-1)
    got = (tfa.flash_dq_partial_reference(q, k, v, lse, do.float(), dl,
                                          causal),
           *tfa.flash_dkv_partial_reference(q, k, v, lse, do.float(), dl,
                                            causal))
    want = (tfa.flash_dq_reference(q, k, v, out, lse, do, causal),
            *tfa.flash_dkv_reference(q, k, v, out, lse, do, causal))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
