"""PyTorch port: the reference's MNIST CNN against the JAX package's.

The flax ``MnistCNN`` and the port's ``MnistCNN`` run on the same params
(``interop.params_from_flax``) and the same inputs, made from a seed
with numpy: the logits, the input gradients and every parameter
gradient agree at rtol 1e-5 (f32, dropout off), for both input shapes.
The flatten order is pinned on its own (the JAX model flattens NHWC),
and the two init schemes by their statistics.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflow_distributed_tpu.models.cnn import MnistCNN as JaxCNN
from tensorflow_distributed_tpu.ops import losses as jlosses
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.models.cnn import (
    TRUNCATED_STD, MnistCNN)
from tensorflow_distributed_tpu_torch.ops import losses as tlosses
from torch_threads import _one_thread  # noqa: F401


RTOL, ATOL = 1e-5, 1e-6


def _jax_params(seed=0):
    model = JaxCNN(compute_dtype=jnp.float32, dropout_rate=0.0)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 28, 28, 1)))
    return model, fnn.meta.unbox(params["params"])


def _port(params):
    model = MnistCNN(compute_dtype=torch.float32, dropout_rate=0.0)
    model.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return model


@pytest.mark.parametrize("shape", [(4, 784), (4, 28, 28, 1)],
                         ids=["flat", "nhwc"])
def test_forward_and_grads_match_flax(shape):
    jmodel, params = _jax_params()
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    labels = rng.integers(0, 10, size=shape[0]).astype(np.int32)

    def jloss(p, xx):
        logits = jmodel.apply({"params": p}, xx)
        return jlosses.softmax_cross_entropy(logits, labels), logits

    (j_loss, j_logits), (j_pgrad, j_xgrad) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, x)

    model = _port(params)
    xt = torch.tensor(x, requires_grad=True)
    logits = model(xt)
    assert logits.dtype == torch.float32 and logits.shape == (shape[0], 10)
    loss = tlosses.softmax_cross_entropy(logits, torch.tensor(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_xgrad),
                               rtol=RTOL, atol=ATOL)
    want = interop.params_from_flax(jax.device_get(j_pgrad))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classification_losses_match_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    logits[0, [2, 7]] = 5.0  # a tie: both take the first max
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    t_logits, t_labels = torch.tensor(logits), torch.tensor(labels)
    np.testing.assert_allclose(
        float(tlosses.softmax_cross_entropy(t_logits, t_labels, smoothing)),
        float(jlosses.softmax_cross_entropy(logits, labels, smoothing)),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.accuracy(t_logits, t_labels)),
        float(jlosses.accuracy(logits, labels)), rtol=1e-6)


def test_fc1_reads_features_in_nhwc_order():
    """fc1 row h*448 + w*64 + c reads the pooled conv2 feature (h, w, c),
    as the JAX model's NHWC flatten does (an NCHW flatten would read
    row c*49 + h*7 + w)."""
    torch.manual_seed(0)
    model = MnistCNN(compute_dtype=torch.float32, dropout_rate=0.0)
    model.init_weights(torch.Generator().manual_seed(1))
    x = torch.rand(3, 28, 28, 1)
    with torch.no_grad():
        model.conv1.bias.fill_(1.0)  # every feature positive: none is
        model.conv2.bias.fill_(10.0)  # lost to the ReLU
        y = F.max_pool2d(F.relu(model.conv1(x.permute(0, 3, 1, 2))), 2, 2)
        y = F.max_pool2d(F.relu(model.conv2(y)), 2, 2)  # [B, 64, 7, 7]
        assert bool((y > 0).all())
        model.fc1.weight.zero_()
        model.fc1.bias.zero_()
        model.out.weight.zero_()
        model.out.bias.zero_()
        for unit, (h, w, c) in enumerate([(1, 2, 3), (6, 0, 63), (3, 5, 0)]):
            model.fc1.weight[unit, h * 448 + w * 64 + c] = 1.0
            model.out.weight[unit, unit] = 1.0
        logits = model(x)
    for unit, (h, w, c) in enumerate([(1, 2, 3), (6, 0, 63), (3, 5, 0)]):
        torch.testing.assert_close(logits[:, unit], y[:, c, h, w])
        assert not torch.allclose(y[:, c, h, w], y.reshape(3, -1)[
            :, h * 448 + w * 64 + c])


def test_improved_init_is_flax_he_normal():
    model = MnistCNN()
    model.init_weights(torch.Generator().manual_seed(0))
    for layer in (model.conv1, model.conv2, model.fc1, model.out):
        w = layer.weight.detach().double()
        fan_in = w[0].numel()
        target = math.sqrt(2.0 / fan_in)
        assert abs(float(w.std()) / target - 1.0) < 0.05, (fan_in, w.std())
        assert float(w.abs().max()) <= 2.0 * target / TRUNCATED_STD * (
            1 + 1e-6)
        assert float(w.abs().max()) > 1.5 * target  # the tails are there
        assert torch.count_nonzero(layer.bias) == 0


def test_reference_init_is_unit_normal():
    model = MnistCNN(init_scheme="reference")
    model.init_weights(torch.Generator().manual_seed(0))
    for layer in (model.conv1, model.conv2, model.fc1, model.out):
        assert abs(float(layer.weight.detach().std()) - 1.0) < 0.05
    biases = torch.cat([p.detach().reshape(-1) for n, p in
                        model.named_parameters() if n.endswith("bias")])
    assert abs(float(biases.std()) - 1.0) < 0.05
    assert abs(float(biases.mean())) < 0.1


def test_init_draws_from_the_generator_only():
    """Same generator seed, same params; the global RNG is untouched."""
    a, b = MnistCNN(), MnistCNN()
    state = torch.random.get_rng_state()
    a.init_weights(torch.Generator().manual_seed(5))
    b.init_weights(torch.Generator().manual_seed(5))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name


def test_dropout_draws_from_the_step_generator():
    model = MnistCNN(compute_dtype=torch.float32, dropout_rate=0.5)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.rand(8, 784)
    a = model(x, train=True, generator=torch.Generator().manual_seed(1))
    b = model(x, train=True, generator=torch.Generator().manual_seed(1))
    c = model(x, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
