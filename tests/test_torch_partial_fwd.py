"""PyTorch port: a plain model of the partial forward kernel's arithmetic
(B7, ``flash_fwd_hopper<D, true>`` in ``ops/csrc/flash_attention.cu``)
against the plain version its wrapper runs for CPU tensors
(``flash_fwd_partial_reference``) and against the JAX Pallas kernel
(``_fwd_partial``, interpret mode, blocks of 64).

The model streams the keys in tiles of the kernel's ``hfwd::PARTIAL_BN``
(read from the source), keeps the running max and sum in log2 units with
the scale folded into the exponent (2^(s scale log2e - m2)), masks past
the keys and outside the band to NEG_INF, rounds P to v's dtype before
P.V, and converts m to natural units once, at the end; a row that saw no
key keeps m = NEG_INF exactly. Agreement pins the units of m and that l,
summed in base 2 against the base-2 max, is the plain Σ e^(s scale - m).

Inputs come from numpy seeds; f32, rtol 1e-5 with an atol of 1e-5 of
the output's largest magnitude (the same math in another order: exp2 of
a folded scale against exp, tiled sums against whole rows; o's entries
near 0 carry the rounding of sums ~1e2 times larger). The kernel itself
runs on the card in tests/test_torch_ring_kernels.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.ops import flash_attention as jfa
from tensorflow_distributed_tpu_torch.ops import flash_attention as tfa
from torch_threads import _one_thread  # noqa: F401


RTOL = 1e-5
NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
BH, D = 4, 64
# The cases of tests/test_torch_ring_attention.py's
# test_partial_plain_versions_match_jax_kernels: (causal, L, Lk).
CASES = [(True, 128, 128), (False, 128, 192)]


def _partial_bn() -> int:
    path = os.path.join(os.path.dirname(tfa.__file__), "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        text = f.read()
    ns = text[text.index("namespace hfwd {"):]
    return int(re.search(r"^constexpr int PARTIAL_BN = (\d+);", ns,
                         re.M).group(1))


def kernel_model(q, k, v, causal, keep=None):
    """(o, m, l) of [BH, L, D] q and [BH, Lk, D] k, v as the partial
    forward kernel computes them (the module docstring); ``keep``, an
    optional [L, Lk] bool mask, drops further keys (the tests' fully
    masked row)."""
    _, L, Dh = q.shape
    Lk = k.shape[1]
    bn = _partial_bn()
    f32 = torch.float32
    scale_log2 = torch.tensor(1.0 / Dh ** 0.5, dtype=f32) * torch.tensor(
        LOG2E)
    neg_inf = torch.tensor(NEG_INF)
    m = torch.full(q.shape[:2], NEG_INF)
    l = torch.zeros(q.shape[:2])
    o = torch.zeros(q.shape, dtype=f32)
    rows = torch.arange(L)[:, None]
    for c0 in range(0, Lk, bn):
        cols = torch.arange(c0, c0 + bn)[None, :]
        pad = c0 + bn - min(c0 + bn, Lk)  # keys past Lk read as zeros
        kt, vt = (torch.nn.functional.pad(x[:, c0:c0 + bn].float(),
                                          (0, 0, 0, pad)) for x in (k, v))
        s = torch.einsum("bqd,bkd->bqk", q.float(), kt)  # raw q.k
        drop = (cols >= Lk).expand(L, bn)
        if causal:
            drop = drop | (cols > rows)
        if keep is not None:
            drop = drop | ~torch.nn.functional.pad(
                keep[:, c0:c0 + bn], (0, pad), value=False)
        s = s.masked_fill(drop, NEG_INF)
        mx = s.amax(dim=-1)
        m_new = torch.maximum(m, torch.where(mx == neg_inf, neg_inf,
                                             mx * scale_log2))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(torch.where(s == neg_inf, neg_inf - m_new[..., None],
                                   s * scale_log2 - m_new[..., None]))
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bqk,bkd->bqd", p.to(v.dtype).float(), vt)
        m = m_new
    return o, torch.where(m == neg_inf, neg_inf, m * torch.tensor(LN2)), l


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _inputs(L, Lk, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(BH, L, D)) * 0.5).astype(np.float32)
    k, v = ((rng.normal(size=(BH, Lk, D)) * 0.5).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal,L,Lk", CASES)
def test_kernel_model_matches_plain_version_and_jax(causal, L, Lk):
    q, k, v = _inputs(L, Lk, L + Lk + causal)
    got = kernel_model(*(torch.tensor(x) for x in (q, k, v)), causal)
    plain = tfa.flash_fwd_partial_reference(
        *(torch.tensor(x) for x in (q, k, v)), causal)
    j_o, j_m, j_l = jfa._fwd_partial(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, 64, 64, True)
    for g, p, j in zip(got, plain, (j_o, j_m[..., 0], j_l[..., 0])):
        assert g.dtype == torch.float32 and g.shape == p.shape
        _close(g, p)
        _close(g, j)


def test_kernel_model_keeps_neg_inf_for_a_row_without_keys():
    """A row whose every key is masked writes m = NEG_INF exactly (not
    NEG_INF ln 2), as the ring's merge and the plain version take "no
    key"; the other rows are the plain masked softmax's."""
    L = Lk = 128
    q, k, v = (torch.tensor(x) for x in _inputs(L, Lk, 11))
    keep = tfa.window_keep(torch.arange(L)[:, None], torch.arange(Lk)[None])
    keep[37] = False
    o, m, l = kernel_model(q, k, v, True, keep)
    assert m[:, 37].numpy().tobytes() == np.full(BH, NEG_INF).tobytes()
    s = torch.einsum("bqd,bkd->bqk", q, k) / D ** 0.5
    s = s.masked_fill(~keep, float(NEG_INF))
    want_m = s.amax(dim=-1)
    p = torch.exp(s - want_m[..., None])
    want = (torch.einsum("bqk,bkd->bqd", p, v), want_m, p.sum(dim=-1))
    for g, w in zip((o, m, l), want):
        _close(g, w)
