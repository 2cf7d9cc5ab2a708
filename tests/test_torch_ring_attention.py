"""PyTorch port: ring attention and the partial-attention kernels against
the JAX package.

- The plain versions of the three partial kernels (what the wrappers run
  for CPU tensors) against the JAX Pallas partial kernels run in
  interpret mode, as tests/test_flash_attention.py runs them (blocks of
  64, so the causal block skip is exercised): (m, l, o) and the q, k, v
  grads of a loss on (o, l).
- ``_merge`` and ``causal_bias`` against JAX.
- ``ring_attention`` through ``StackedRing(S)`` (all positions in one
  process) against JAX ``ring_attention`` on the 8-device CPU mesh:
  zigzag and naive, the odd-block fallback, the mask refusal and the
  bad schedule, values and q/k/v grads.
- ``ProcessGroupRing`` in 4 spawned gloo processes against
  ``StackedRing(4)`` and ``full_attention``, values and grads; the ranks
  join under a deadline (tests/torch_ring_workers.py).

Inputs come from numpy seeds; f32, rtol 1e-4 / atol 1e-5 (same math,
different summation order). The kernels themselves run on the card in
tests/test_torch_ring_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig
from tensorflow_distributed_tpu.ops import flash_attention as jfa
from tensorflow_distributed_tpu.parallel import ring_attention as jra
from tensorflow_distributed_tpu.parallel.mesh import make_mesh
from tensorflow_distributed_tpu_torch.ops import flash_attention as tfa
from tensorflow_distributed_tpu_torch.parallel import ring_attention as tra
from torch_ring_workers import ring_cases, spawn_ranks

TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays(shape, n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * scale).astype(np.float32)
            for _ in range(n)]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# ------------------------------------------------------ partial kernels

@pytest.mark.parametrize("causal,L,Lk", [(True, 128, 128), (False, 128, 192)])
def test_partial_plain_versions_match_jax_kernels(causal, L, Lk):
    """(m, l, o) and the grads of sum(o*ct_o) + sum(l*ct_l) (m carries
    none) against the Pallas partial kernels in interpret mode."""
    B, H, D = 2, 2, 64
    q, ct_o = _arrays((B, L, H, D), 2, 1, 0.5)
    k, v = _arrays((B, Lk, H, D), 2, 2, 0.5)
    (ct_l,) = _arrays((B, H, L), 1, 3)

    def jax_loss(q, k, v):
        m, l, o = jfa.flash_attention_partial(
            q, k, v, causal=causal, block_q=64, block_k=64, interpret=True)
        return jnp.sum(o * ct_o) + jnp.sum(l * ct_l), (m, l, o)

    (_, j_out), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_out = tfa.flash_attention_partial(tq, tk, tv, causal=causal)
    loss = (t_out[2] * torch.tensor(ct_o)).sum() + (
        t_out[1] * torch.tensor(ct_l)).sum()
    t_grads = torch.autograd.grad(loss, (tq, tk, tv))
    assert not t_out[0].requires_grad  # m: the stop-gradient stabilizer
    for got, want in zip(t_out, j_out):
        _close(got.detach(), want)
    for got, want in zip(t_grads, j_grads):
        _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_partial_dq_dkv_plain_versions_equal_autograd(causal):
    """The explicit partial backward (m held constant) equals autograd
    through the plain partial forward with m detached."""
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(3, 128, 64, generator=g, dtype=torch.float64)
                   for _ in range(4))
    dl = torch.randn(3, 128, generator=g, dtype=torch.float64)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    s, scale = tfa._scores(q, k, causal, 0)
    m = s.amax(dim=-1).detach()
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    want = torch.autograd.grad((o * do.float()).sum()
                               + (p.sum(-1) * dl.float()).sum(), (q, k, v))
    args = (q.detach(), k.detach(), v.detach(), m, do, dl, causal)
    got = (tfa.flash_dq_partial(*args), *tfa.flash_dkv_partial(*args))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_merge_and_causal_bias_match_jax():
    m1, l1, m2, l2 = _arrays((2, 3, 5), 4, 6)
    o1, o2 = _arrays((2, 5, 3, 4), 2, 7)
    l1, l2 = np.abs(l1), np.abs(l2)
    got = tra._merge(*(torch.tensor(x) for x in (m1, l1, o1, m2, l2, o2)))
    want = jra._merge(m1, l1, o1, m2, l2, o2)
    for a, b in zip(got, want):
        _close(a, b)
    np.testing.assert_array_equal(tra.causal_bias(6, 9).numpy(),
                                  np.asarray(jra.causal_bias(6, 9)))


def test_cpu_partial_wrappers_do_not_count_kernel_launches():
    tfa.reset_launch_counts()
    x = torch.zeros(2, 64, 64)
    o, m, l = tfa.flash_fwd_partial(x, x, x, True)
    tfa.flash_dq_partial(x, x, x, m, o, l, True)
    tfa.flash_dkv_partial(x, x, x, m, o, l, True)
    assert [k.launches for k in tfa.PARTIAL_KERNELS] == [0, 0, 0]


# --------------------------------------------------- ring vs JAX (mesh)

# (JAX mesh, ring size S, (B, L, H, D), schedule, causal)
RING_CASES = {
    "data2_seq4_zigzag": (dict(data=2, seq=4), 4, (2, 32, 4, 8), "zigzag",
                          True),
    "data2_seq4_naive": (dict(data=2, seq=4), 4, (2, 32, 4, 8), "naive",
                         True),
    "data2_seq4_full": (dict(data=2, seq=4), 4, (2, 32, 4, 8), "zigzag",
                        False),
    "data2_seq4_kernel_path": (dict(data=2, seq=4), 4, (2, 512, 2, 64),
                               "zigzag", True),
    "seq2_zigzag": (dict(data=1, seq=2), 2, (2, 32, 4, 8), "zigzag", True),
    "seq8_zigzag": (dict(data=1, seq=8), 8, (1, 64, 2, 8), "zigzag", True),
    "seq8_kernel_path": (dict(data=1, seq=8), 8, (1, 1024, 2, 64),
                         "zigzag", True),
    "seq4_odd_block": (dict(data=1, seq=4), 4, (1, 20, 2, 8), "zigzag", True),
}


def _jax_mesh(devices8, axes):
    n = axes["data"] * axes["seq"]
    return make_mesh(MeshConfig(**axes), devices8[:n])


@pytest.mark.parametrize("name", RING_CASES)
def test_stacked_ring_matches_jax_ring(devices8, monkeypatch, name):
    axes, S, shape, schedule, causal = RING_CASES[name]
    q, k, v, g = _arrays(shape, 4, sum(map(ord, name)))
    mesh = _jax_mesh(devices8, axes)

    def jax_loss(q, k, v):
        out = jra.ring_attention(q, k, v, mesh, causal=causal,
                                 schedule=schedule)
        return jnp.sum(out * g), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)

    calls = []
    real = tfa.flash_fwd_partial
    monkeypatch.setattr(tfa, "flash_fwd_partial",
                        lambda *a: calls.append(1) or real(*a))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_out = tra.ring_attention(tq, tk, tv, tra.StackedRing(S), causal=causal,
                               schedule=schedule)
    t_grads = torch.autograd.grad(t_out, (tq, tk, tv), torch.tensor(g))
    _close(t_out.detach(), j_out)
    for got, want in zip(t_grads, j_grads):
        _close(got, want)
    # The half-block shapes that pass supported() take the partial
    # kernels' plain versions, 2S + 1 times per call (zigzag).
    kernel_path = name.endswith("kernel_path")
    assert len(calls) == (2 * S + 1 if kernel_path else 0)


def test_ring_of_one_is_full_attention():
    q, k, v = (torch.tensor(x) for x in _arrays((2, 16, 2, 8), 3, 8))
    want = tra.full_attention(q, k, v, tra.causal_bias(16, 16))
    got = tra.ring_attention(q, k, v, tra.StackedRing(1), causal=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ring_refuses_mask_and_bad_schedule(devices8):
    q, k, v = (torch.tensor(x) for x in _arrays((2, 32, 2, 8), 3, 9))
    mesh = _jax_mesh(devices8, dict(data=2, seq=4))
    with pytest.raises(NotImplementedError):
        jra.ring_attention(q.numpy(), k.numpy(), v.numpy(), mesh,
                           mask=jnp.zeros((2, 32, 32)))
    with pytest.raises(NotImplementedError):
        tra.ring_attention(q, k, v, tra.StackedRing(4),
                           mask=torch.zeros(2, 32, 32))
    with pytest.raises(ValueError, match="schedule"):
        jra.ring_attention(q.numpy(), k.numpy(), v.numpy(), mesh,
                           causal=True, schedule="spiral")
    with pytest.raises(ValueError, match="schedule"):
        tra.ring_attention(q, k, v, tra.StackedRing(4), causal=True,
                           schedule="spiral")


@pytest.mark.parametrize("S", [2, 4, 8])
def test_zigzag_permutations_match_jax(S):
    """The contiguous -> zigzag routes: the same permutations as the
    JAX schedule's, and together they give position d the half-blocks
    d and 2S-1-d."""
    perm_a, perm_b = tra._zigzag_perms(S)
    owner = {}
    for d in range(S):
        owner[2 * d] = perm_a[d][1]
        owner[2 * d + 1] = perm_b[d][1]
    for h in range(2 * S):
        assert owner[h] == (h if h < S else 2 * S - 1 - h)
    for perm in (perm_a, perm_b):
        assert sorted(dst for _, dst in perm) == list(range(S))


# ------------------------------------------- the multi-process ring

PG_CASES = [dict(shape=(2, 32, 2, 8), causal=True, schedule="zigzag"),
            dict(shape=(1, 512, 2, 64), causal=True, schedule="zigzag"),
            dict(shape=(2, 32, 2, 8), causal=True, schedule="naive"),
            dict(shape=(2, 32, 2, 8), causal=False, schedule="zigzag"),
            dict(shape=(1, 20, 2, 8), causal=True, schedule="zigzag")]


def test_process_group_ring_matches_stacked_and_full(tmp_path):
    """4 spawned gloo ranks, each holding its contiguous block, against
    the stacked ring and full_attention on the global tensors."""
    cases = []
    for i, c in enumerate(PG_CASES):
        q, k, v, g = (torch.tensor(x) for x in _arrays(c["shape"], 4,
                                                       20 + i))
        cases.append(dict(q=q, k=k, v=v, g=g, causal=c["causal"],
                          schedule=c["schedule"]))
    torch.save(cases, tmp_path / "cases.pt")
    spawn_ranks(ring_cases, 4, tmp_path, tmp_path / "cases.pt", tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for i, case in enumerate(cases):
        out = torch.cat([ranks[r][i]["out"] for r in range(4)], dim=1)
        grads = [torch.cat([ranks[r][i]["grads"][j] for r in range(4)],
                           dim=1) for j in range(3)]
        assert out.shape == case["q"].shape
        # StackedRing(1) is full_attention (with the causal bias).
        for ring in (tra.StackedRing(4), tra.StackedRing(1)):
            q, k, v = (case[n].clone().requires_grad_() for n in "qkv")
            want = tra.ring_attention(q, k, v, ring, causal=case["causal"],
                                      schedule=case["schedule"])
            want_g = torch.autograd.grad(want, (q, k, v), case["g"])
            _close(out, want.detach())
            for a, b in zip(grads, want_g):
                _close(a, b)
