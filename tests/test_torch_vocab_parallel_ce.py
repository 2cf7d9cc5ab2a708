"""PyTorch port: the Megatron vocab-parallel fused CE
(``ops/fused_ce.vocab_parallel_ce_sums``) against the JAX package's
``_tp_dispatch`` (``fused_masked_cross_entropy`` on a mesh with a model
axis) on the 8-device CPU mesh.

``StackedTP(M)`` holds the M model ranks' head rows in one process. For
M 2 and 4, the mean loss, the accuracy and the gradients of x, W and b
equal JAX's at 1e-5, with a vocabulary M does not divide (its padding
rows masked and zero-grad), label smoothing, and no bias. The cases of
the JAX package's own tests carry over: a first-max tie across ranks
goes to the smallest id, and a rank whose every row is padding
contributes no NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.ops.fused_ce import (
    fused_masked_cross_entropy as jax_fused_ce)
from tensorflow_distributed_tpu.parallel.mesh import make_mesh
from tensorflow_distributed_tpu_torch.ops.fused_ce import (
    fused_masked_cross_entropy, vocab_parallel_ce_sums)
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    StackedTP, VocabShards)
from torch_threads import _one_thread  # noqa: F401


B, L, D = 4, 16, 24  # B: the data axis (8 / M devices) must divide it
TOL = 1e-5


def _data(seed, vocab, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, D).astype(np.float32)
    w = (0.1 * rng.randn(vocab, D)).astype(np.float32)
    b = (0.1 * rng.randn(vocab)).astype(np.float32) if bias else None
    t = rng.randint(0, vocab, size=(B, L)).astype(np.int32)
    m = (rng.rand(B, L) < 0.7).astype(np.float32)
    return x, w, b, t, m


def _jax(x, w, b, t, m, vocab, chunk, smoothing, model):
    mesh = make_mesh(JaxMesh(data=8 // model, model=model))

    def loss(x, w, b):
        out, acc = jax_fused_ce(x, w, b, t, m, vocab_size=vocab, chunk=chunk,
                                label_smoothing=smoothing, w_vocab_axis=0,
                                mesh=mesh)
        return out, acc

    args = (jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b))
    argnums = (0, 1) if b is None else (0, 1, 2)
    with mesh:
        value, acc = jax.jit(loss)(*args)
        grads = jax.jit(jax.grad(lambda *a: loss(*a)[0],
                                 argnums=argnums))(*args)
    return float(value), float(acc), [np.asarray(g) for g in grads]


def _head(w, b, M, vocab):
    """W (and b) padded to M equal parts, as the TP model holds them."""
    rows = -(-vocab // M)
    wt = torch.nn.functional.pad(torch.from_numpy(w),
                                 (0, 0, 0, rows * M - vocab))
    w_parts = torch.stack(wt.chunk(M)).requires_grad_()
    b_parts = None
    if b is not None:
        bt = torch.nn.functional.pad(torch.from_numpy(b),
                                     (0, rows * M - vocab))
        b_parts = torch.stack(bt.chunk(M)).requires_grad_()
    tp = StackedTP(M)
    head = VocabShards(tp.split(w_parts), rows, vocab, tp,
                       None if b is None else tp.split(b_parts))
    return head, w_parts, b_parts


def _port(x, w, b, t, m, vocab, chunk, smoothing, M):
    head, w_parts, b_parts = _head(w, b, M, vocab)
    xt = torch.from_numpy(x).requires_grad_()
    loss, acc = fused_masked_cross_entropy(
        xt, head, None, torch.from_numpy(t), torch.from_numpy(m),
        vocab_size=vocab, chunk=chunk, label_smoothing=smoothing)
    loss.backward()
    grads = [xt.grad, w_parts.grad.reshape(-1, D)[:vocab]]
    if b is not None:
        grads.append(b_parts.grad.reshape(-1)[:vocab])
    pad_grad = float(w_parts.grad.reshape(-1, D)[vocab:].abs().sum())
    return float(loss.detach()), float(acc), grads, pad_grad


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("vocab,chunk,smoothing,bias", [
    (51, 16, 0.1, True), (48, 8, 0.0, True), (53, 7, 0.0, False)],
    ids=["prime_smoothed", "even", "no_bias"])
def test_vocab_parallel_matches_jax_tp_dispatch(vocab, chunk, smoothing,
                                                bias, M):
    x, w, b, t, m = _data(6, vocab, bias)
    want = _jax(x, w, b, t, m, vocab, chunk, smoothing, M)
    got = _port(x, w, b, t, m, vocab, chunk, smoothing, M)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)
    assert got[1] == pytest.approx(want[1], abs=1e-7)
    for g, e in zip(got[2], want[2]):
        np.testing.assert_allclose(g.numpy(), e, rtol=TOL, atol=TOL)
    assert got[3] == 0.0


@pytest.mark.parametrize("M", [2, 4])
def test_first_max_tie_across_ranks_goes_to_the_smallest_id(M):
    """Two identical max columns on different ranks (ids 3 and 30 of
    48): a target at 3 is correct, one at 30 is not, as in JAX."""
    vocab = 48
    x = np.ones((4, 4, D), np.float32)
    w = np.zeros((vocab, D), np.float32)
    w[3] = w[30] = 2.0
    mask = np.ones((4, 4), np.float32)
    for target, acc in ((3, 1.0), (30, 0.0)):
        t = np.full((4, 4), target, np.int32)
        head, _, _ = _head(w, None, M, vocab)
        _, correct, n = vocab_parallel_ce_sums(
            torch.from_numpy(x), head, torch.from_numpy(t),
            torch.from_numpy(mask), chunk=8)
        assert float(correct / n) == acc
        jx = jnp.asarray(x)
        mesh = make_mesh(JaxMesh(data=8 // M, model=M))
        with mesh:
            _, jacc = jax_fused_ce(jx, jnp.asarray(w), None, jnp.asarray(t),
                                   jnp.asarray(mask), vocab_size=vocab,
                                   chunk=8, mesh=mesh)
        assert float(jacc) == acc


def test_all_padding_rank_gives_no_nan():
    """Vocabulary 3 over model 4: rank 3 holds only a padding row, and
    its (NEG_INF, 0) stats weigh nothing. Values and grads equal JAX's
    and are finite."""
    vocab = 3
    x, w, b, t, m = _data(7, vocab)
    want = _jax(x, w, b, t, m, vocab, 8, 0.0, 4)
    got = _port(x, w, b, t, m, vocab, 8, 0.0, 4)
    assert np.isfinite(got[0])
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)
    for g, e in zip(got[2], want[2]):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), e, rtol=TOL, atol=TOL)


def test_kernel_impl_is_refused_on_a_sharded_head():
    x, w, b, t, m = _data(0, 16)
    head, _, _ = _head(w, b, 2, 16)
    with pytest.raises(ValueError, match="requires mesh.model == 1"):
        fused_masked_cross_entropy(
            torch.from_numpy(x), head, None, torch.from_numpy(t),
            torch.from_numpy(m), vocab_size=16, chunk=8, impl="kernel")
