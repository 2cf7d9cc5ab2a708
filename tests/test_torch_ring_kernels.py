"""PyTorch port: the partial-attention CUDA kernels and the ring on the
card.

Every test here needs a CUDA GPU and skips without one (the kernels have
no CPU mode; their plain versions and the ring are held to the JAX
package by tests/test_torch_ring_attention.py). This file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_ring_kernels.py -m gpu

Tolerances as chip_smoke.py: o and dQ/dK/dV max abs error / max
|reference| <= 2e-2, m and l max abs error <= 1e-3 (the plain version
runs in f32 from the same bf16 inputs; the kernels round P and dO to
bf16 for the tensor-core products); B7 normalized against B1 (o / l
against out, m + log l against lse) at the same two; the ring against
B1-B3 and the multi-process ring against the stacked one <= 2e-2
relative.
"""

import pytest
import torch

from tensorflow_distributed_tpu_torch.ops import flash_attention as tfa
from tensorflow_distributed_tpu_torch.parallel import ring_attention as tra
from torch_ring_workers import ring_cases, spawn_ranks

TOL_REL = 2e-2
TOL_STATS = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,L,Lk", [
    (True, 256, 256),
    (False, 256, 320),  # the last key tile runs past Lk
    (True, 64, 64),     # one 64-row block
])
def test_partial_kernels_match_plain_versions_on_gpu(cuda, D, causal, L, Lk):
    g = torch.Generator(device=cuda).manual_seed(D + L + Lk)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    q = randn(6, L, D).to(torch.bfloat16)
    k, v = (randn(6, Lk, D).to(torch.bfloat16) for _ in range(2))
    do, dl = randn(6, L, D), randn(6, L)
    tfa.reset_launch_counts()
    o, m, l = tfa.flash_fwd_partial(q, k, v, causal)
    dq = tfa.flash_dq_partial(q, k, v, m, do, dl, causal)
    dk, dv = tfa.flash_dkv_partial(q, k, v, m, do, dl, causal)
    torch.cuda.synchronize()
    assert [kern.launches for kern in tfa.PARTIAL_KERNELS] == [1, 1, 1]
    assert [kern.launches for kern in tfa.KERNELS] == [0, 0, 0]
    f = [t.float() for t in (q, k, v)]
    ref_o, ref_m, ref_l = tfa.flash_fwd_partial_reference(*f, causal)
    assert o.dtype == torch.float32 and o.shape == (6, L, D)
    assert _rel(o, ref_o) <= TOL_REL
    assert float((m - ref_m).abs().max()) <= TOL_STATS
    assert float((l - ref_l).abs().max()) <= TOL_STATS
    refs = (tfa.flash_dq_partial_reference(*f, m, do, dl, causal),
            *tfa.flash_dkv_partial_reference(*f, m, do, dl, causal))
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == torch.bfloat16
        assert _rel(got, ref) <= TOL_REL


def _partial_bwd_inputs(cuda, BH, L, Lk, D, seed, do_scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    q = randn(BH, L, D).to(torch.bfloat16)
    k, v = (randn(BH, Lk, D).to(torch.bfloat16) for _ in range(2))
    return q, k, v, randn(BH, L, D) * do_scale, randn(BH, L)


@pytest.mark.gpu
@pytest.mark.parametrize("BH,L,Lk,D,causal,do_scale", [
    (96, 128, 128, 64, False, 1.0),  # the ring's half-block at S = 4
    (96, 128, 128, 64, True, 1.0),
    (32, 512, 512, 64, False, 1.0),  # L 8192 over S = 8
    (32, 512, 512, 64, True, 1.0),
    (6, 192, 320, 64, False, 1.0),   # ragged edges of the tiles
    (6, 192, 320, 128, False, 1.0),
    (16, 256, 256, 128, True, 1.0),
    (96, 128, 128, 64, False, 1e3),  # dO ~1e3 through the f32 -> bf16 path
])
def test_partial_backward_kernels_match_plain_versions_on_gpu(
        cuda, BH, L, Lk, D, causal, do_scale):
    """B8 and B9 (the PARTIAL Hopper kernels), each launched once,
    against their plain versions, with m from the partial forward."""
    q, k, v, do, dl = _partial_bwd_inputs(cuda, BH, L, Lk, D, BH + L + D,
                                          do_scale)
    _, m, _ = tfa.flash_fwd_partial(q, k, v, causal)
    tfa.reset_launch_counts()
    dq = tfa.flash_dq_partial(q, k, v, m, do, dl, causal)
    dk, dv = tfa.flash_dkv_partial(q, k, v, m, do, dl, causal)
    torch.cuda.synchronize()
    assert [kern.launches for kern in tfa.PARTIAL_KERNELS] == [0, 1, 1]
    assert [kern.launches for kern in tfa.KERNELS] == [0, 0, 0]
    f = [t.float() for t in (q, k, v)]
    refs = (tfa.flash_dq_partial_reference(*f, m, do, dl, causal),
            *tfa.flash_dkv_partial_reference(*f, m, do, dl, causal))
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _rel(got, ref) <= TOL_REL


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_partial_backward_with_normalized_rows_matches_b2_b3_on_gpu(
        cuda, D, causal):
    """B8 with (lse, -rowsum(dO * O), dO in f32) against B2 and B9
    against B3 on the same inputs: the row terms the two forms share."""
    q, k, v, do, _ = _partial_bwd_inputs(cuda, 8, 256, 256, D, D + causal)
    do = do.to(torch.bfloat16)
    out, lse = tfa.flash_fwd(q, k, v, causal)
    dl = -(do.float() * out.float()).sum(dim=-1)
    tfa.reset_launch_counts()
    got = (tfa.flash_dq_partial(q, k, v, lse, do.float(), dl, causal),
           *tfa.flash_dkv_partial(q, k, v, lse, do.float(), dl, causal))
    want = (tfa.flash_dq(q, k, v, out, lse, do, causal),
            *tfa.flash_dkv(q, k, v, out, lse, do, causal))
    torch.cuda.synchronize()
    assert [kern.launches for kern in tfa.PARTIAL_KERNELS] == [0, 1, 1]
    assert [kern.launches for kern in tfa.KERNELS] == [0, 1, 1]
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_REL


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_partial_forward_normalizes_to_b1_on_gpu(cuda, D, causal):
    """B7's (o, m, l) against B1 on the same inputs: o / l is B1's out
    and m + log l its lse, the identity that holds the two forms of
    flash_fwd_hopper together."""
    q, k, v, _, _ = _partial_bwd_inputs(cuda, 8, 256, 256, D, 3 * D + causal)
    tfa.reset_launch_counts()
    o, m, l = tfa.flash_fwd_partial(q, k, v, causal)
    out, lse = tfa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert [kern.launches for kern in tfa.PARTIAL_KERNELS] == [1, 0, 0]
    assert [kern.launches for kern in tfa.KERNELS] == [1, 0, 0]
    assert _rel(o / l[..., None], out) <= TOL_REL
    assert float((m + torch.log(l) - lse).abs().max()) <= TOL_STATS


@pytest.mark.gpu
def test_partial_wrappers_reject_f32_on_gpu(cuda):
    x = torch.zeros(2, 64, 64, device=cuda)
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="not supported"):
        tfa.flash_fwd_partial(x, x, x, True)
    assert [kern.launches for kern in tfa.PARTIAL_KERNELS] == [0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2, 4])
def test_stacked_zigzag_ring_matches_flash_kernels(cuda, S):
    """The causal zigzag ring (B7-B9, 2S+1 launches each per call)
    against one-shot flash attention (B1-B3), values and grads."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (torch.randn(2, 1024, 4, 64, generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    grads = []
    tfa.reset_launch_counts()
    for run in ("ring", "flash"):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        if run == "ring":
            out = tra.ring_attention(*x, tra.StackedRing(S), causal=True)
            torch.autograd.backward(out, do)
            launched = [kern.launches for kern in tfa.PARTIAL_KERNELS]
        else:
            out = tfa.flash_attention(*x, causal=True)
            torch.autograd.backward(out, do)
        grads.append([out.detach()] + [t.grad for t in x])
    torch.cuda.synchronize()
    assert launched == [2 * S + 1] * 3
    for got, ref in zip(*grads):
        assert _rel(got, ref) <= TOL_REL


@pytest.mark.gpu
def test_process_group_ring_over_nccl(cuda, tmp_path):
    """ProcessGroupRing over NCCL, one card per rank (needs two or more
    cards), against the stacked ring on one card; the ranks join under
    a deadline."""
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs two or more CUDA GPUs")
    g = torch.Generator().manual_seed(0)
    cases = []
    for schedule in ("zigzag", "naive"):
        q, k, v, do = (torch.randn(2, 128 * world, 2, 64, generator=g)
                       .to(torch.bfloat16) for _ in range(4))
        cases.append(dict(q=q, k=k, v=v, g=do, causal=True,
                          schedule=schedule))
    torch.save(cases, tmp_path / "cases.pt")
    spawn_ranks(ring_cases, world, tmp_path, tmp_path / "cases.pt",
                tmp_path, "cuda", backend="nccl")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    for i, case in enumerate(cases):
        x = [case[n].to(cuda).requires_grad_() for n in "qkv"]
        want = tra.ring_attention(*x, tra.StackedRing(world), causal=True,
                                  schedule=case["schedule"])
        want_g = torch.autograd.grad(want, x, case["g"].to(cuda))
        got = torch.cat([r[i]["out"] for r in ranks], dim=1)
        assert _rel(got, want.detach().cpu()) <= TOL_REL
        for j in range(3):
            got_g = torch.cat([r[i]["grads"][j] for r in ranks], dim=1)
            assert _rel(got_g, want_g[j].cpu()) <= TOL_REL
