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
bf16 for the tensor-core products); the ring against B1-B3 and the
multi-process ring against the stacked one <= 2e-2 relative.
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
@pytest.mark.parametrize("causal,L,Lk", [(True, 256, 256), (False, 256, 320)])
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
