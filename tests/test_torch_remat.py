"""PyTorch port: ``--remat full|dots`` (``torch.utils.checkpoint`` around
each block) against the port without remat and against JAX's
``nn.remat``.

- With dropout 0.25 and ``--grad-accum-steps 2`` the losses and the
  parameters after 5 steps equal the run without remat within 1e-6
  (the recompute replays each block's dropout masks from the
  generator's state at the block's entry; drawing from the live
  generator instead changes the gradients, which a test here shows).
- With dropout 0 the 5-step trajectories follow JAX's remat runs within
  1e-4.
- ``dots`` saves exactly the matmuls (``aten.addmm`` / ``bmm`` outputs)
  and recomputes everything else.
"""

import collections

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

LLAMA = dict(pos_emb="rope", n_kv_heads=2, mlp_variant="swiglu",
             norm="rmsnorm")
TINY = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
            train_steps=5, eval_every=0, log_every=1, eval_batch_size=8,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0, **LLAMA)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _port_run(**fields):
    res = tloop.train(TrainConfig(**{**TINY, **fields}, device="cpu"),
                      logger=MetricLogger(enabled=False))
    return _losses(res.logger), {n: p.detach().clone()
                                 for n, p in res.state.params.items()}


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_no_remat_with_dropout_and_accumulation(remat):
    fields = dict(dropout_rate=0.25, grad_accum_steps=2)
    want_losses, want = _port_run(**fields)
    losses, params = _port_run(remat=remat, **fields)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-6)
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def _model(**overrides):
    model = ttr.gpt_lm("tiny", compute_dtype=torch.float32,
                       dropout_rate=0.25, **{**LLAMA, **overrides})
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _grads_and_generator(model, tokens):
    gen = torch.Generator().manual_seed(7)
    model(tokens, train=True, generator=gen).square().mean().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return grads, gen.get_state()


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_recompute_replays_the_masks_and_leaves_the_generator(policy):
    """One forward and backward with dropout: the grads equal the
    un-rematted model's, and the live generator ends where the forward
    left it (the recompute drew from a copy)."""
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64,
                                                                (2, 16)))
    want, want_gen = _grads_and_generator(_model(), tokens)
    got, got_gen = _grads_and_generator(
        _model(remat=True, remat_policy=policy), tokens)
    assert torch.equal(got_gen, want_gen)
    for name, g in got.items():
        torch.testing.assert_close(g, want[name], rtol=0, atol=1e-6,
                                   msg=name)


def test_recompute_from_the_live_generator_would_change_the_grads(
        monkeypatch):
    """The trouble spot: ``checkpoint``'s preserve_rng_state restores the
    default generators only. A recompute that draws from the dropout
    generator as it stands after the forward draws other masks, and the
    grads change without an error."""
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64,
                                                                (2, 16)))
    want, _ = _grads_and_generator(_model(), tokens)

    def naive(block, x, train, generator, positions, rope):
        return checkpoint(block, x, train, generator, positions, None, rope,
                          use_reentrant=False)

    monkeypatch.setattr(ttr, "_remat_block", naive)
    got, _ = _grads_and_generator(_model(remat=True), tokens)
    assert max(float((got[n] - want[n]).abs().max()) for n in got) > 1e-3


def test_dots_saves_the_matmuls_and_nothing_else(monkeypatch):
    """Under ``dots`` the selective-checkpoint policy sees every op of the
    block's forward and saves only the matmuls: on the CPU, per layer,
    six ``addmm`` (q, kv, out, gate, up, down) and the plain attention's
    two ``bmm``. On a card the attention is the hand kernels' ctypes
    launches, which no dispatch mode sees: B1 is recomputed, as JAX
    recomputes a pallas_call under dots_saveable."""
    seen = collections.Counter()
    policy = ttr._save_dots

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen[(str(op), decision.name)] += 1
        return decision

    monkeypatch.setattr(ttr, "_save_dots", spy)
    model = _model(remat=True, remat_policy="dots", d_model=128, n_heads=2,
                   n_kv_heads=1, max_len=64)
    tokens = torch.zeros((2, 64), dtype=torch.long)
    model(tokens, train=True,
          generator=torch.Generator().manual_seed(0)).sum().backward()
    saved = {op: n for (op, decision), n in seen.items()
             if decision == "MUST_SAVE"}
    assert saved == {"aten.addmm.default": 12, "aten.bmm.default": 4}
    assert sum(seen.values()) > sum(saved.values())


def _jax_init(jcfg):
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             jax_make_task(jcfg, mesh))
    return interop.params_from_flax(jax.device_get(jstate.params))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("accum", [1, 2])
def test_remat_trajectory_matches_jax_remat(remat, accum):
    fields = dict(TINY, remat=remat, grad_accum_steps=accum)
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=MetricLogger(enabled=False))
    tres = tloop.train(TrainConfig(**fields, device="cpu"),
                       logger=MetricLogger(enabled=False),
                       init_params=_jax_init(jcfg))
    assert len(_losses(tres.logger)) == 5
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               atol=1e-4)
    np.testing.assert_allclose(tres.final_metrics["loss"],
                               jres.final_metrics["loss"], atol=1e-4)


def test_remat_builds_from_the_cli_flag_as_in_jax():
    """``--remat full|dots`` maps to remat=True and remat_policy, as the
    JAX _build_model_and_state maps it; ``none`` leaves remat off."""
    for flag, want in (("none", (False, "full")), ("full", (True, "full")),
                       ("dots", (True, "dots"))):
        cfg = TrainConfig(**{**TINY, "remat": flag}, device="cpu")
        model = tloop.build_model_for(cfg, torch.device("cpu"))
        assert (model.cfg.remat, model.cfg.remat_policy) == want
