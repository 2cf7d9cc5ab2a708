"""PyTorch port: ResNet-20/50 with flax BatchNorm semantics and sync BN,
against the JAX package on the CPU.

The forwards (train and eval mode, and the batch statistics a training
forward produces) match the flax models at 1e-5 in f32 on the same
weights (``interop.params_from_flax``); XLA's SAME padding is held
where it is asymmetric (a stride-2 3x3 conv and the 7x7/2 stem on even
inputs, the 3x3/2 max pool) against flax's own layers. ``train()``
trajectories of resnet20 on the synthetic CIFAR-10 set follow JAX's to
1e-4 (losses and ``batch_stats``), with gradient accumulation
too, and so do resnet50's on the synthetic ImageNet set at 32 x 32; a skipped step keeps the statistics; checkpoints carry
``batch_stats`` both ways, byte for byte; and four gloo ranks under
``--mesh.data 4`` (sync BN) give one process's losses and statistics.
"""


import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import resnet as jresnet
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import (
    MUTABLE_EXTRA_MODELS, build_model)
from tensorflow_distributed_tpu_torch.models import resnet as tresnet
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.train.step import make_train_step
from tensorflow_distributed_tpu_torch.train.tasks import make_vision_loss
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_ring_workers import spawn_ranks, train_run
from torch_threads import _one_thread  # noqa: F401


RESNET = dict(model="resnet20", dataset="cifar10_synthetic", batch_size=16,
              train_steps=5, eval_every=0, log_every=1, eval_batch_size=200,
              compute_dtype="float32", learning_rate=1e-3, seed=0)
TOL = 1e-5


def _perturbed(tree, seed=1, scale=0.1):
    """The params with noise on every leaf, so the zero-init BN scales
    do not hide the residual branches."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), tree)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _pair(name, shape, seed=0):
    """A flax model of ``name`` with perturbed params and its port (same
    weights, f32), and an input batch."""
    jm = getattr(jresnet, name)(compute_dtype=jnp.float32)
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    v = jax.device_get(jm.init(jax.random.key(seed), x, train=False))
    params = _perturbed(v["params"])
    tm = getattr(tresnet, name)(compute_dtype=torch.float32)
    missing, unexpected = tm.load_state_dict(
        interop.params_from_flax(params), strict=False)
    assert not unexpected
    assert all(k.endswith((".mean", ".var")) for k in missing)
    return jm, {"params": params, "batch_stats": v["batch_stats"]}, tm, x


@pytest.mark.parametrize("name,shape,stats_tol", [
    ("resnet20", (4, 32, 32, 3), TOL), ("resnet50", (2, 64, 64, 3), 1e-4)])
def test_forward_and_batch_stats_match_flax(name, shape, stats_tol):
    """Eval mode (the running averages) and train mode (batch statistics)
    logits match the flax model at 1e-5, and so do the moving averages a
    training forward leaves, at 1e-5 for ResNet-20 and 1e-4 for
    ResNet-50, whose last stages' E[x^2] - E[x]^2 in f32 differ by up to
    1.5e-5 relative after 50 layers of another summation order."""
    jm, variables, tm, x = _pair(name, shape)
    want_eval = jm.apply(variables, x, train=False)
    want_train, mut = jm.apply(variables, x, train=True,
                               mutable=["batch_stats"])
    xt = torch.tensor(x)
    with torch.no_grad():
        got_eval = tm(xt, train=False)
        got_train = tm(xt, train=True)
    assert _rel(got_eval, want_eval) < TOL
    assert _rel(got_train, want_train) < TOL
    # Nothing is written until the step commits.
    assert float(tm.bn_stem.var.sum()) == tm.bn_stem.var.numel()
    tm.commit_batch_stats()
    _assert_stats_equal(tm, mut, stats_tol)


def test_grads_match_flax():
    """The training forward's gradients (through the batch statistics)
    match JAX's at 1e-4 of the largest (the deepest convs' differ by
    ~1e-5: summation order through twenty layers)."""
    jm, variables, tm, x = _pair("resnet20", (4, 32, 32, 3))
    labels = np.array([1, 3, 5, 7])

    def jloss(p):
        logits, _ = jm.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             x, train=True, mutable=["batch_stats"])
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(4), labels])

    want = interop.params_from_flax(jax.device_get(
        jax.grad(jloss)(variables["params"])))
    F.cross_entropy(tm(torch.tensor(x), train=True),
                    torch.tensor(labels)).backward()
    for name, p in tm.named_parameters():
        assert _rel(p.grad, want[name]) < 1e-4, name


@pytest.mark.parametrize("case", ["conv3x3_s2", "stem7x7_s2", "maxpool",
                                  "bottleneck_s2"])
def test_same_padding_is_xla_s_on_even_inputs(case):
    """XLA's SAME padding is asymmetric under stride 2 on an even input;
    the port pads as flax does: a 3x3/2 conv on 32, the 7x7/2 stem on
    224, the 3x3/2 max pool on 112, and a stride-2 bottleneck block."""
    rng = np.random.default_rng(0)
    assert tresnet.same_pads(32, 3, 2) == (0, 1)
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(112, 3, 2) == (0, 1)
    if case == "maxpool":
        x = rng.standard_normal((1, 112, 112, 4)).astype(np.float32)
        want = np.asarray(nn.max_pool(x, (3, 3), strides=(2, 2),
                                      padding="SAME"))
        xt = torch.tensor(x).permute(0, 3, 1, 2)
        got = F.max_pool2d(tresnet.pad_same(xt, 3, 2, -float("inf")), 3, 2)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
        return
    if case == "bottleneck_s2":
        jm = jresnet.BottleneckBlock(filters=4, strides=(2, 2),
                                     compute_dtype=jnp.float32)
        tm = tresnet.BottleneckBlock(8, 4, 2, torch.float32)
        x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    else:
        k, n = (3, 32) if case == "conv3x3_s2" else (7, 224)
        jm = nn.Conv(4, (k, k), (2, 2), use_bias=False, dtype=jnp.float32)
        tm = tresnet._conv(3, 4, k)
        x = rng.standard_normal((1, n, n, 3)).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.key(0), x))
    params = _perturbed(v["params"])
    if case == "bottleneck_s2":
        tm.load_state_dict(interop.params_from_flax(params), strict=False)
        want = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        x, train=False)
        with torch.no_grad():
            got = tm(torch.tensor(x).permute(0, 3, 1, 2), False)
    else:
        tm.weight.data = interop.params_from_flax(
            {"conv": params})["conv.weight"]
        want = jm.apply({"params": params}, x)
        net = tresnet._Net()
        net.compute_dtype = torch.float32
        with torch.no_grad():
            got = net.conv(tm, torch.tensor(x).permute(0, 3, 1, 2), 2)
    assert got.shape[2:] == tuple(np.asarray(want).shape[1:3])
    assert _rel(got.permute(0, 2, 3, 1), want) < TOL


def test_registry_and_init():
    """build_model dispatches the ResNets; the init is flax's: zero-gamma
    on each branch's last BN, running mean 0 / variance 1, and the param
    count of the JAX model."""
    assert MUTABLE_EXTRA_MODELS == ("resnet20", "resnet50")
    m = build_model("resnet20", compute_dtype=torch.float32, size="tiny")
    m.init_weights(torch.Generator().manual_seed(0))
    assert float(m.stage0_block0.bn2.weight.detach().abs().sum()) == 0.0
    assert float(m.stage0_block0.bn1.weight.detach().sum()) == 16.0
    assert float(m.bn_stem.mean.abs().sum()) == 0.0
    jm = jresnet.resnet20(compute_dtype=jnp.float32)
    v = jm.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32))
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        v["params"]))
    assert sum(p.numel() for p in m.parameters()) == n
    assert sum(b.numel() for b in m.buffers()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            v["batch_stats"]))


# --- train() against JAX -------------------------------------------------------

def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _jax_run(fields):
    """The JAX train() of ``fields`` and its init as a port state dict."""
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    return jres, interop.params_from_flax(jax.device_get(jstate.params))


def _port_run(fields, init=None):
    return tloop.train(TrainConfig(**fields, device="cpu"),
                       logger=MetricLogger(enabled=False), init_params=init)


def _flat(tree):
    return {"/".join(path): leaf for path, leaf in interop._walk(tree)}


def _assert_stats_equal(model, jax_extra, tol):
    """The model's BN buffers against a JAX ``extra`` (or mutated
    collections): the same paths, values within ``tol``."""
    got = _flat(interop.extra_to_flax(model)["batch_stats"])
    want = _flat(jax.device_get(jax_extra["batch_stats"]))
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


def test_a_skipped_step_keeps_the_batch_stats():
    """A non-finite step under skip_batch keeps the running averages
    (JAX's skip keeps the whole state); a finite one writes them."""
    cfg = TrainConfig(**RESNET, device="cpu")
    model, state = tloop._build_model_and_state(cfg, torch.device("cpu"))
    step = make_train_step(make_vision_loss(), torch.device("cpu"),
                           skip_nonfinite=True)
    rng = np.random.default_rng(0)
    images = torch.tensor(rng.random((8, 32, 32, 3), dtype=np.float32))
    labels = torch.tensor(rng.integers(0, 10, 8))
    before = {k: v.clone() for k, v in state.extra.items()}
    state, m = step(state, (images * float("nan"), labels))
    assert float(m["skipped_nonfinite"]) == 1.0
    for k, v in state.extra.items():
        assert torch.equal(v, before[k]), k
    assert all(bn.pending is None for bn in model.modules()
               if isinstance(bn, tresnet.BatchNorm))
    state, m = step(state, (images, labels))
    assert float(m["skipped_nonfinite"]) == 0.0
    assert not torch.equal(state.extra["bn_stem.mean"],
                           before["bn_stem.mean"])


# --- checkpoints ---------------------------------------------------------------


# --- sync BN over gloo ranks ----------------------------------------------------

def test_sync_bn_over_four_ranks_equals_one_process(tmp_path):
    """--mesh.data 4 in four gloo ranks, each drawing its quarter of every
    global batch: each BN all-reduces its sums over the data group, so the
    losses and the batch_stats are one process's on the global batch
    (1e-5), on every rank alike."""
    fields = dict(RESNET, train_steps=3)
    spawn_ranks(train_run, 4, tmp_path, fields, None, tmp_path, {"data": 4})
    one = _port_run(fields)
    stats = one.state.extra
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], _losses(one.logger),
                                   rtol=1e-5)
        for name, value in stats.items():
            np.testing.assert_allclose(rank["params"][name].numpy(),
                                       value.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            assert torch.equal(rank["params"][name], ranks[0]["params"][name])
