"""PyTorch port: optimizer and schedules against optax.

The JAX ``make_optimizer`` (optax) and the port's ``make_optimizer`` run
5 updates over the tiny GPT's parameters (carried across with
``interop.params_from_flax``) and the same numpy gradients; every update
agrees to 1e-6. Schedules agree to 1e-6 relative at every count.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.train import optim as joptim
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.train import optim as toptim

STEPS = 5


def _cfgs(**fields):
    base = dict(model="gpt_lm", learning_rate=3e-3, train_steps=10)
    base.update(fields)
    return JaxConfig(**base), TrainConfig(**base)


def _tiny_params(**overrides):
    jmodel = jtr.gpt_lm(size="tiny", **overrides)
    params = nn.meta.unbox(jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 8), jnp.int32), train=False))(
        jax.random.key(0))["params"])
    return jax.device_get(params)


@pytest.mark.parametrize("fields", [
    dict(optimizer="adam"),
    dict(optimizer="adam", weight_decay=0.1),
    dict(optimizer="adam", grad_clip_norm=1.0),
    dict(optimizer="adam", weight_decay=0.1, grad_clip_norm=1.0,
         lr_schedule="warmup_cosine", warmup_steps=2),
    dict(optimizer="adam", lr_schedule="cosine"),
    dict(optimizer="sgd", lr_schedule="cosine"),
], ids=["adam", "adamw", "adam_clip", "adamw_clip_warmup_cosine",
        "adam_cosine", "sgd_cosine"])
def test_updates_match_optax(fields):
    jcfg, tcfg = _cfgs(**fields)
    jparams = _tiny_params()
    tx = joptim.make_optimizer(jcfg)
    jstate = tx.init(jparams)

    model = ttr.gpt_lm(size="tiny")
    model.load_state_dict(interop.params_from_flax(jparams))
    params = dict(model.named_parameters())
    opt = toptim.make_optimizer(tcfg, model)
    ostate = opt.init(params)

    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        jgrads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 0.1).astype(np.float32),
            jparams)
        jupd, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        with torch.no_grad():
            upd = opt.update(interop.params_from_flax(jgrads), ostate, params)
            for n, u in upd.items():
                params[n].add_(u)
        want = interop.params_from_flax(jax.device_get(jupd))
        for n, u in upd.items():
            np.testing.assert_allclose(u.numpy(), want[n].numpy(), atol=1e-6,
                                       err_msg=n)
    for n, p in interop.params_from_flax(jax.device_get(jparams)).items():
        np.testing.assert_allclose(params[n].detach().numpy(), p.numpy(),
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("fields", [
    dict(lr_schedule="constant"),
    dict(lr_schedule="cosine"),
    dict(lr_schedule="warmup_cosine", warmup_steps=3),
    dict(lr_schedule="warmup_cosine", warmup_steps=0),
])
def test_schedules_match_optax(fields):
    jcfg, tcfg = _cfgs(**fields)
    jsched, tsched = joptim.make_schedule(jcfg), toptim.make_schedule(tcfg)
    for count in range(14):
        np.testing.assert_allclose(tsched(count), float(jsched(count)),
                                   rtol=1e-6, atol=1e-9, err_msg=str(count))


def test_decay_mask_matches_jax_leaf_names():
    """Linear/Embedding weights decay (flax kernel/embedding leaves);
    biases and LayerNorm never do."""
    jparams = _tiny_params()
    jmask = jax.tree_util.tree_map(
        lambda m: np.full((1,), m, np.float32), joptim.decay_mask(jparams))
    want = {n: bool(v[0]) for n, v in interop.params_from_flax(jmask).items()}
    got = toptim.decay_mask(ttr.gpt_lm(size="tiny"))
    assert got == want
    assert any(got.values()) and not all(got.values())


def test_tied_table_decays_once():
    """With tied embeddings the shared table is one parameter (no
    lm_head): it decays once, as the flax ``embedding`` leaf does, and
    the adamw updates match optax's."""
    jcfg, tcfg = _cfgs(optimizer="adam", weight_decay=0.1)
    jparams = _tiny_params(tie_embeddings=True)
    model = ttr.gpt_lm(size="tiny", tie_embeddings=True)
    model.load_state_dict(interop.params_from_flax(jparams))
    mask = toptim.decay_mask(model)
    assert mask["tok_emb.weight"] and not any(
        n.startswith("lm_head") for n in mask)
    assert list(mask) == [n for n, _ in model.named_parameters()]
    tx = joptim.make_optimizer(jcfg)
    jstate = tx.init(jparams)
    params = dict(model.named_parameters())
    opt = toptim.make_optimizer(tcfg, model)
    ostate = opt.init(params)
    rng = np.random.default_rng(3)
    for _ in range(2):
        jgrads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 0.1).astype(np.float32),
            jparams)
        jupd, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        with torch.no_grad():
            upd = opt.update(interop.params_from_flax(jgrads), ostate, params)
            for n, u in upd.items():
                params[n].add_(u)
        want = interop.params_from_flax(jax.device_get(jupd))
        assert upd.keys() == want.keys()
        for n, u in upd.items():
            np.testing.assert_allclose(u.numpy(), want[n].numpy(), atol=1e-6,
                                       err_msg=n)


def test_global_norm_matches_optax():
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    np.testing.assert_allclose(
        float(toptim.global_norm([torch.tensor(x) for x in xs])),
        float(optax.global_norm(xs)), rtol=1e-6)
