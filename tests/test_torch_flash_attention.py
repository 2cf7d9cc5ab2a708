"""PyTorch port: flash attention against the JAX package.

The port's plain versions of the three kernels (what the wrappers run for
CPU tensors) are held against the JAX Pallas kernels run in interpret
mode, the way tests/test_flash_attention.py runs them, with blocks 32/64
so the multi-block causal and window skips are exercised. Inputs come
from numpy so both frameworks see identical values. f32 tolerance:
atol 1e-5 (same math, different summation order). The kernels
themselves are tested on the card by tests/test_torch_flash_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.ops import flash_attention as jfa
from tensorflow_distributed_tpu.parallel.ring_attention import (
    full_attention as jax_full_attention)
from tensorflow_distributed_tpu_torch.ops import flash_attention as tfa
from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    full_attention)

B, L, H, D = 2, 128, 2, 64
ATOL = 1e-5
CASES = [(False, 0), (True, 0), (True, 48)]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, L, H, D)) * 0.5).astype(np.float32)
            for _ in range(4)]  # q, k, v, cotangent


@pytest.mark.parametrize("causal,window", CASES)
def test_forward_and_grads_match_jax_kernel(causal, window):
    q, k, v, ct = _inputs(1 + window)

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=32, block_k=64, interpret=True)
        return jnp.sum(out * ct), out

    (_, j_out), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    t_grads = torch.autograd.grad(t_out, (tq, tk, tv), torch.tensor(ct))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=ATOL)
    for tg, jg in zip(t_grads, j_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)


@pytest.mark.parametrize("causal,window", CASES)
def test_lse_matches_jax_kernel(causal, window):
    """The forward's second output (flat [BH, L] here, lane-replicated
    [BH, L, 8] in the Pallas kernel)."""
    q, k, v, _ = _inputs(7)

    def pack(x):
        return np.ascontiguousarray(
            x.transpose(0, 2, 1, 3).reshape(B * H, L, D))

    _, j_lse = jfa._fwd(*(jnp.asarray(pack(x)) for x in (q, k, v)),
                        causal, 32, 64, True, window)
    _, t_lse = tfa.flash_fwd(*(torch.tensor(pack(x)) for x in (q, k, v)),
                             causal, window)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=ATOL)


@pytest.mark.parametrize("causal,window", CASES)
def test_dq_dkv_plain_versions_equal_autograd(causal, window):
    """The explicit backward formulas (the plain versions of the dQ and
    dK/dV kernels) equal autograd through the plain forward."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(B * H, L, D, generator=g, dtype=torch.float64)
                   for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_reference(q, k, v, causal, window)
    want = torch.autograd.grad(out, (q, k, v), do)
    out, lse, q, k, v = (x.detach() for x in (out, lse, q, k, v))
    dq = tfa.flash_dq(q, k, v, out, lse, do, causal, window)
    dk, dv = tfa.flash_dkv(q, k, v, out, lse, do, causal, window)
    for got, ref in zip((dq, dk, dv), want):
        # The plain versions compute in f32 whatever the input dtype.
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_full_attention_matches_jax():
    q, k, v, _ = _inputs(11)
    mask = np.asarray(jfa.window_bias(jnp.arange(L)[:, None],
                                      jnp.arange(L)[None, :], 16))
    got = full_attention(*(torch.tensor(x) for x in (q, k, v)),
                         torch.tensor(mask))
    want = jax_full_attention(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("window", [0, 5])
def test_window_keep_and_bias_match_jax(window):
    rows, cols = np.arange(40)[:, None], np.arange(40)[None, :]
    np.testing.assert_array_equal(
        tfa.window_keep(torch.tensor(rows), torch.tensor(cols),
                        window).numpy(),
        np.asarray(jfa.window_keep(rows, cols, window)))
    np.testing.assert_array_equal(
        tfa.window_bias(torch.tensor(rows), torch.tensor(cols),
                        window).numpy(),
        np.asarray(jfa.window_bias(rows, cols, window)))


def test_supported_gate():
    assert tfa.supported(1024, 1024, 64)
    assert tfa.supported(128, 256, 128)
    assert not tfa.supported(96, 128, 64)       # L not a tile multiple
    assert not tfa.supported(128, 128, 32)      # head dim
    assert not tfa.supported(0, 128, 64)         # empty sequence


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 8)])
def test_attention_dispatch_unsupported_shape_takes_plain_path(causal,
                                                               window):
    """Head dim 8 fails the kernel gate: attention() must fall to the
    plain path with the causal/window bias and agree with JAX."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 32, 2, 8)).astype(np.float32)
               for _ in range(3))
    got = tfa.attention(*(torch.tensor(x) for x in (q, k, v)),
                        causal=causal, window=window)
    want = jfa.attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_window_requires_causal():
    x = torch.zeros(1, 64, 1, 64)
    with pytest.raises(ValueError, match="causal"):
        tfa.attention(x, x, x, window=4)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(x, x, x, window=4)


def test_cpu_wrappers_do_not_count_kernel_launches():
    tfa.reset_launch_counts()
    x = torch.zeros(2, 64, 64)
    tfa.flash_fwd(x, x, x, True, 0)
    assert [k.launches for k in tfa.KERNELS] == [0, 0, 0]
