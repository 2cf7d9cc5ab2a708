"""PyTorch port: the fused-CE CUDA kernels against their plain versions,
on the card.

Every test here needs a CUDA GPU and skips without one (the kernels have
no CPU mode; their plain versions are held to the JAX package by
tests/test_torch_fused_ce.py). This file imports no JAX, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_fused_ce_kernels.py -m gpu

The cases are chip_smoke.py's: GPT-2-small's head (T 8192, D 768,
V 50257) with bias at eps 0 and 0.1 and without bias (the tied head),
GPT-2-medium's width (D 1024, T 2048), and a ragged case (T 1000,
V 179), plus odd shapes: T 40, D 200, V 70; D 1000 and D 1600 (not
multiples of the 64-column chunk or the 384-column slice of dx and
dW); T 1; V 2001 with T 300 (ragged dW vocab and token tiles); V 300
and 400 (the forward's vocab tail in either consumer's half); and
first-max ties across the forward's consumers and tiles.
Tolerances as chip_smoke.py (the plain version runs in f32 from the same bf16
inputs): ce and lse max abs error <= 1e-3; ``correct``
identical wherever the top-2 logit gap exceeds 1e-2; dx and dW max abs
error / max |reference| <= 2e-2 (dlogits is rounded to bf16 before the
products); db <= 1e-3 relative.
"""

import pytest
import torch

from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fk

CASES = [dict(T=8192, D=768, V=50257, bias=True, eps=0.0),
         dict(T=8192, D=768, V=50257, bias=True, eps=0.1),
         dict(T=8192, D=768, V=50257, bias=False, eps=0.0),
         dict(T=2048, D=1024, V=50257, bias=True, eps=0.0),
         dict(T=1000, D=768, V=179, bias=True, eps=0.1),
         # beyond the smoke: D not a multiple of the 32-column chunk,
         # fewer tokens and vocab columns than one tile
         dict(T=40, D=200, V=70, bias=True, eps=0.1),
         # dx's 64-column chunks and 256-column slices: D 1000 and 1600
         # end inside a chunk and a slice; one token fills 1 of 128 rows
         dict(T=300, D=1000, V=1000, bias=True, eps=0.0),
         dict(T=256, D=1600, V=2000, bias=True, eps=0.1),
         dict(T=1, D=768, V=50257, bias=True, eps=0.0),
         # dW's 64-row vocab tiles and 128-token tiles: V 2001 leaves 17
         # rows in the last vocab tile, T 300 44 tokens in the last token
         # tile, D 1600 ends inside a 64-column chunk and a 384-column slice
         dict(T=300, D=1600, V=2001, bias=True, eps=0.1),
         # the forward's 256-column vocab tiles, 128 columns a consumer
         # warpgroup: V 300 ends inside the first warpgroup's half of the
         # second tile, V 400 inside the second's
         dict(T=200, D=512, V=300, bias=True, eps=0.1),
         dict(T=200, D=512, V=400, bias=False, eps=0.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(T, D, V, bias, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(T, D, generator=g, device=device).to(torch.bfloat16)
    w = (0.05 * torch.randn(V, D, generator=g, device=device)).to(
        torch.bfloat16)
    b = 0.1 * torch.randn(V, generator=g, device=device) if bias else None
    t = torch.randint(0, V, (T,), generator=g, device=device,
                      dtype=torch.int32)
    coef = torch.rand(T, generator=g, device=device)
    return x, w, b, t, coef


def _rel(a, ref):
    return float((a.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES,
                         ids=[f"T{c['T']}_D{c['D']}_V{c['V']}_b{c['bias']:d}"
                              f"_eps{c['eps']}" for c in CASES])
def test_kernels_match_plain_versions_on_gpu(cuda, case):
    T, D, V, eps = case["T"], case["D"], case["V"], case["eps"]
    x, w, b, t, coef = _inputs(T, D, V, case["bias"], T + D, cuda)
    fk.reset_launch_counts()
    ce, correct, lse = fk.fused_ce_fwd(x, w, b, t, V, eps)
    dx = fk.fused_ce_dx(x, w, b, t, lse, coef, V, eps)
    dw, db = fk.fused_ce_dw(x, w, b, t, lse, coef, V, eps)
    torch.cuda.synchronize()
    assert [kern.launches for kern in fk.KERNELS] == [1, 1, 1]
    ref_ce, ref_correct, ref_lse = fk.fused_ce_fwd_reference(x, w, b, t, V,
                                                             eps)
    assert float((ce - ref_ce).abs().max()) <= 1e-3
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    top2 = fk._logits(x, w, b).topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-2
    assert torch.equal(correct[decided], ref_correct[decided])
    ref_dx = fk.fused_ce_dx_reference(x, w, b, t, lse, coef, V, eps)
    assert dx.dtype == torch.bfloat16 and _rel(dx, ref_dx) <= 2e-2
    ref_dw, ref_db = fk.fused_ce_dw_reference(x, w, b, t, lse, coef, V, eps)
    assert dw.dtype == torch.float32 and _rel(dw, ref_dw) <= 2e-2
    if b is None:
        assert db is None
    else:
        assert _rel(db, ref_db) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [(5, 137, 600), (137, 261, 999)],
                         ids=["half0_half1_tile2", "half1_tile1_tail"])
def test_first_max_argmax_ties_on_gpu(cuda, cols):
    """Equal maxima at one column of each consumer warpgroup's half of a
    vocab tile and in later tiles (V 1000, not a multiple of the 256-
    column tile): the first column wins, as in
    tests/test_torch_fused_ce.py's CPU tie and the JAX kernel."""
    T, D, V = 64, 64, 1000
    x = torch.full((T, D), 1.0 / D, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((V, D), device=cuda, dtype=torch.bfloat16)
    w[list(cols)] = 3.0
    for target in cols:
        t = torch.full((T,), target, device=cuda, dtype=torch.int32)
        _, correct, _ = fk.fused_ce_fwd(x, w, None, t, V)
        _, ref_correct, _ = fk.fused_ce_fwd_reference(x, w, None, t, V)
        want = 1.0 if target == cols[0] else 0.0
        assert torch.equal(correct, torch.full_like(correct, want)), target
        assert torch.equal(correct, ref_correct)


@pytest.mark.gpu
def test_cuda_wrappers_reject_unsupported_inputs(cuda):
    x = torch.zeros(64, 128, device=cuda)  # f32: the kernels take bf16
    w = torch.zeros(179, 128, device=cuda, dtype=torch.bfloat16)
    t = torch.zeros(64, device=cuda, dtype=torch.int32)
    fk.reset_launch_counts()
    with pytest.raises(ValueError, match="not supported"):
        fk.fused_ce_fwd(x, w, None, t, 179)
    with pytest.raises(ValueError, match="not supported"):  # D % 8 != 0
        fk.fused_ce_fwd(x[:, :100].to(torch.bfloat16).contiguous(),
                        w[:, :100].contiguous(), None, t, 179)
    with pytest.raises(ValueError, match="int32"):
        fk.fused_ce_fwd(x.to(torch.bfloat16), w, None, t.long(), 179)
    assert [kern.launches for kern in fk.KERNELS] == [0, 0, 0]


@pytest.mark.gpu
def test_sums_on_cuda_go_through_the_kernels(cuda):
    """fused_ce_sums_kernel on the card launches each kernel once per
    forward+backward and gives the f32 head's grads (f32 params, bf16
    features, the model's call)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 64, 256, generator=g, device=cuda).to(torch.bfloat16)
    w = (0.05 * torch.randn(179, 256, generator=g, device=cuda))
    b = torch.zeros(179, device=cuda)
    x.requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    t = torch.randint(0, 179, (2, 64), generator=g, device=cuda)
    m = torch.ones(2, 64, device=cuda)
    fk.reset_launch_counts()
    ce, _, n = fk.fused_ce_sums_kernel(x, w, b, t, m, 179)
    (ce / n).backward()
    torch.cuda.synchronize()
    assert [kern.launches for kern in fk.KERNELS] == [1, 1, 1]
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert all(bool(torch.isfinite(p.grad).all()) for p in (x, w, b))
