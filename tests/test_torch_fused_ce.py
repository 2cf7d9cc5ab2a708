"""PyTorch port: the fused linear+cross-entropy against the JAX package.

Inputs are made with numpy from a seed at the JAX tests' sizes (B 2,
L 64, D 128, V 179 prime, so vocab padding is exercised; and 96 tokens,
a ragged tile for the port's 64-token kernels). On the CPU the port's kernel wrappers run their plain versions;
they are held, kernel by kernel and through ``FusedCETokens``, to the
JAX Pallas kernels run in interpret mode (``bv`` 128, so the TPU
kernels walk two vocab blocks), values and grads w.r.t. x, W and b, at
rtol 1e-4 / atol 1e-5 in f32. The scan formulation is held to the JAX
scan at chunks 32, 64 and 256 (V 179 is never chunk-aligned).
"""

import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.ops import fused_ce as jfc
from tensorflow_distributed_tpu.ops import fused_ce_kernel as jfk
from tensorflow_distributed_tpu_torch.ops import fused_ce as tfc
from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as tfk
from torch_threads import _one_thread  # noqa: F401


D, V = 128, 179
BT, BV = 32, 128       # JAX kernel blocks: several token and vocab blocks
SHAPES = {"T128": (2, 64), "T96": (2, 48)}
TOL = dict(rtol=1e-4, atol=1e-5)


def _mk(seed, lead, bias=True):
    rng = np.random.RandomState(seed)
    x = (0.3 * rng.randn(*lead, D)).astype(np.float32)
    w = (0.1 * rng.randn(V, D)).astype(np.float32)
    b = (0.1 * rng.randn(V)).astype(np.float32) if bias else None
    t = rng.randint(0, V, size=lead).astype(np.int32)
    m = (rng.rand(*lead) < 0.7).astype(np.float32)
    coef = rng.rand(int(np.prod(lead))).astype(np.float32)
    return x, w, b, t, m, coef


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jax_sums_and_grads(x, w, b, t, m, eps, fn):
    """JAX (ce_sum, correct, mask_sum) and d(ce_sum / n) w.r.t. x, w, b
    (b as zeros when there is none: its grad is then discarded)."""
    bb = np.zeros(V, np.float32) if b is None else b

    def loss(x, w, bb):
        ce, corr, n = fn(x, w, None if b is None else bb, t, m, eps)
        return ce / n, (ce, corr, n)

    (_, sums), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x, w, bb)
    return [float(s) for s in sums], [np.asarray(g) for g in grads]


def _port_sums_and_grads(x, w, b, t, m, fn):
    xt, wt, bt = (None if a is None else _t(a).requires_grad_()
                  for a in (x, w, b))
    ce, corr, n = fn(xt, wt, bt, _t(t), _t(m))
    (ce / n).backward()
    return ([float(s.detach()) for s in (ce, corr, n)],
            [None if a is None else a.grad.numpy() for a in (xt, wt, bt)])


def _assert_match(port, want):
    (p_sums, p_grads), (j_sums, j_grads) = port, want
    np.testing.assert_allclose(p_sums, j_sums, **TOL)
    for name, g, e in zip(("dx", "dw", "db"), p_grads, j_grads):
        if g is not None:
            np.testing.assert_allclose(g, e, err_msg=name, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_plain_versions_match_jax_kernels(shape, bias, eps):
    """Each plain version against its Pallas kernel (interpret mode) on
    the same inputs: fwd (ce, correct, lse) per token, dx, and dW/db."""
    x, w, b, t, _, coef = _mk(0, SHAPES[shape], bias)
    T = x.size // D
    x2, t1 = x.reshape(T, D), t.reshape(T)
    bb = np.zeros(V, np.float32) if b is None else b
    jce, jcorr, jlse = jfk._fwd(x2, w, bb, t1, V, BT, BV, eps, 0, True)
    ce, corr, lse = tfk.fused_ce_fwd_reference(_t(x2), _t(w), _t(b),
                                               _t(t1), V, eps)
    np.testing.assert_allclose(ce.numpy(), jce, **TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, **TOL)
    np.testing.assert_array_equal(corr.numpy(), np.asarray(jcorr))

    res = (x2, w, bb, t1, np.ones(T, np.float32), jlse)
    jdx, jdw, jdb, _, _ = jfk._fused_ce_tokens_bwd(
        V, BT, BV, eps, 0, True, res, (coef, None))
    args = (_t(x2), _t(w), _t(b), _t(t1), _t(jlse), _t(coef), V, eps)
    np.testing.assert_allclose(tfk.fused_ce_dx_reference(*args).numpy(),
                               jdx, **TOL)
    dw, db = tfk.fused_ce_dw_reference(*args)
    np.testing.assert_allclose(dw.numpy(), jdw, **TOL)
    if bias:
        np.testing.assert_allclose(db.numpy(), jdb, **TOL)
    else:
        assert db is None


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_kernel_sums_match_jax_kernel_sums(shape, bias, eps):
    """fused_ce_sums_kernel (FusedCETokens over the plain versions on the
    CPU) against the JAX kernel triple: values and grads."""
    x, w, b, t, m, _ = _mk(1, SHAPES[shape], bias)
    want = _jax_sums_and_grads(
        x, w, b, t, m, eps,
        lambda x, w, b, t, m, eps: jfk.fused_ce_sums_kernel(
            x, w, b, t, m, V, bt=BT, bv=BV, label_smoothing=eps,
            interpret=True))
    tfk.reset_launch_counts()
    port = _port_sums_and_grads(
        x, w, b, t, m,
        lambda x, w, b, t, m: tfk.fused_ce_sums_kernel(
            x, w, b, t, m, V, label_smoothing=eps))
    _assert_match(port, want)
    # CPU tensors take the plain versions: no kernel was launched.
    assert [k.launches for k in tfk.KERNELS] == [0, 0, 0]


@pytest.mark.parametrize("chunk", [32, 64, 256])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_scan_matches_jax_scan(chunk, eps):
    x, w, b, t, m, _ = _mk(2, SHAPES["T128"])
    want = _jax_sums_and_grads(
        x, w, b, t, m, eps,
        lambda x, w, b, t, m, eps: jfc.fused_ce_sums(
            x, w, b, t, m, V, chunk, eps, 0))
    port = _port_sums_and_grads(
        x, w, b, t, m,
        lambda x, w, b, t, m: tfc.fused_ce_sums(x, w, b, t, m, V, chunk,
                                                eps))
    _assert_match(port, want)


def test_scan_without_bias_matches_jax_scan():
    x, w, _, t, m, _ = _mk(3, SHAPES["T96"], bias=False)
    want = _jax_sums_and_grads(
        x, w, None, t, m, 0.1,
        lambda x, w, b, t, m, eps: jfc.fused_ce_sums(
            x, w, b, t, m, V, 64, eps, 0))
    port = _port_sums_and_grads(
        x, w, None, t, m,
        lambda x, w, b, t, m: tfc.fused_ce_sums(x, w, b, t, m, V, 64, 0.1))
    _assert_match(port, want)


def test_first_max_argmax_across_tiles():
    """Duplicated max columns in different vocab blocks (chunks): the
    earlier column wins, as jnp.argmax and the JAX kernel decide (the
    tie of tests/test_fused_ce_kernel.py)."""
    x = np.ones((1, 8, D), np.float32) / D
    w = np.zeros((V, D), np.float32)
    w[1] = w[BV + 9] = 3.0
    m = np.ones((1, 8), np.float32)
    for target, want in ((1, 8.0), (BV + 9, 0.0)):
        t = np.full((1, 8), target, np.int32)
        _, jcorr, _ = jfk.fused_ce_sums_kernel(
            x, w, None, t, m, V, bt=8, bv=BV, interpret=True)
        assert float(jcorr) == want
        _, corr, _ = tfk.fused_ce_sums_kernel(_t(x), _t(w), None, _t(t),
                                              _t(m), V)
        assert float(corr) == want
        _, corr, _ = tfc.fused_ce_sums(_t(x), _t(w), None, _t(t), _t(m), V,
                                       64)
        assert float(corr) == want


def test_kernel_supported_accepts_what_jax_accepts():
    for T in (1, 7, 8, 96, 100, 128, 250, 256, 512, 1000, 8192):
        for d in (8, 24, 32, 100, 128, 768, 1600):
            if jfk.kernel_supported(T, d):
                assert tfk.kernel_supported(T, d), (T, d)
            assert tfk.kernel_supported(T, d) == (d % 8 == 0), (T, d)
    # Ragged token counts the JAX gate refuses: the port masks them.
    assert not jfk.kernel_supported(1000, 768)
    assert tfk.kernel_supported(1000, 768)
    assert not tfk.kernel_supported(0, 768)


def test_dispatcher_matches_jax_and_rejects_what_it_must():
    x, w, b, t, m, _ = _mk(4, SHAPES["T128"])
    want = jfc.fused_masked_cross_entropy(
        x, w, b, t, m, vocab_size=V, chunk=64, label_smoothing=0.1)
    for impl in tfc.IMPLS:
        got = tfc.fused_masked_cross_entropy(
            _t(x), _t(w), _t(b), _t(t), _t(m), vocab_size=V, chunk=64,
            label_smoothing=0.1, impl=impl)
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in want], **TOL)
    args = (_t(x), _t(w), _t(b), _t(t), _t(m))
    with pytest.raises(ValueError, match="impl"):
        tfc.fused_masked_cross_entropy(*args, vocab_size=V, chunk=64,
                                       impl="dense")
    with pytest.raises(ValueError, match="impl"):
        jfc.fused_masked_cross_entropy(x, w, b, t, m, vocab_size=V,
                                       chunk=64, impl="dense")
    with pytest.raises(ValueError, match="chunk"):
        tfc.fused_masked_cross_entropy(*args, vocab_size=V, chunk=0)
    # A feature width the kernels refuse raises instead of falling back.
    xo = np.zeros((2, 64, 100), np.float32)
    wo = np.zeros((V, 100), np.float32)
    with pytest.raises(ValueError, match="unsupported"):
        jfc.fused_masked_cross_entropy(xo, wo, b, t, m, vocab_size=V,
                                       chunk=64, impl="kernel")
    with pytest.raises(ValueError, match="unsupported"):
        tfc.fused_masked_cross_entropy(_t(xo), _t(wo), _t(b), _t(t), _t(m),
                                       vocab_size=V, chunk=64,
                                       impl="kernel")


def test_tokens_function_keeps_the_cast_head_and_f32_grads():
    """FusedCETokens casts W to the features' dtype once and returns
    dW/db in the params' dtype; correct carries no gradient."""
    x, w, b, t, _, _ = _mk(5, (96,))
    xt = _t(x).to(torch.bfloat16).requires_grad_()
    wt, bt = _t(w).requires_grad_(), _t(b).requires_grad_()
    ce, corr = tfk.FusedCETokens.apply(xt, wt, bt, _t(t), V, 0.0)
    assert ce.dtype == corr.dtype == torch.float32 and ce.shape == (96,)
    assert not corr.requires_grad
    ce.sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == bt.grad.dtype == torch.float32
    # The bf16 plain path against the f32 one on the same bf16 values.
    ref, _ = tfk.FusedCETokens.apply(xt.detach().float(),
                                     wt.detach().to(torch.bfloat16).float(),
                                     bt.detach(), _t(t), V, 0.0)
    np.testing.assert_allclose(ce.detach().numpy(), ref.numpy(), **TOL)


def test_plain_dx_rounds_dlogits_to_the_features_dtype():
    """dlogits is rounded to x's dtype before the dx and dW products,
    as the JAX scan rounds it (and the kernels do)."""
    x, w, b, t, _, coef = _mk(6, (64,))
    xb, wb = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    _, _, lse = tfk.fused_ce_fwd_reference(xb, wb, _t(b), _t(t), V)
    args = (xb, wb, _t(b), _t(t), lse, _t(coef), V, 0.0)
    d = tfk._dlogits(*args)
    want_dx = (d.to(torch.bfloat16).float() @ wb.float()).to(torch.bfloat16)
    assert torch.equal(tfk.fused_ce_dx_reference(*args), want_dx)
    dw, db = tfk.fused_ce_dw_reference(*args)
    assert torch.equal(dw, d.to(torch.bfloat16).float().T @ xb.float())
    assert torch.equal(db, d.sum(dim=0))
