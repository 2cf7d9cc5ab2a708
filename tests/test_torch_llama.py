"""PyTorch port: the Llama-style GPT options (RoPE, GQA, SwiGLU, RMSNorm,
the sliding window) against the JAX ``gpt_lm``.

The flax model is initialized, its params are carried into the port with
``interop.params_from_flax``, and both packages run the same numpy
tokens. Tolerances: ``rope_rotate`` atol 1e-6 at positions up to 8191;
forward logits and grads atol 1e-5 (f32); 5-step ``train()``
trajectories atol 1e-4, as PR 2's; decode logits and caches rtol/atol
1e-5 with the port's cache read from JAX's narrow one; ``generate()``,
``beam_search`` and the slot engine token-identical to JAX's.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import generate as jgen
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.ops.losses import (
    masked_softmax_cross_entropy as jax_masked_ce)
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu.serve.engine import (
    SlotDecodeEngine as JaxEngine)
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import generate as tgen
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.ops.losses import (
    masked_softmax_cross_entropy)
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_ring_workers import spawn_ranks, train_run

TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA = dict(pos_emb="rope", n_kv_heads=2, mlp_variant="swiglu",
             norm="rmsnorm")
TINY = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
            train_steps=5, eval_every=0, log_every=1, eval_batch_size=8,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models run hundreds of small ops a step: one intra-op
    thread keeps them fast when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- rope_rotate -----------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 5e5])
@pytest.mark.parametrize("head_dim", [8, 64])
def test_rope_rotate_matches_jax_to_position_8191(theta, head_dim):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8192, 2, head_dim)).astype(np.float32)
    pos = np.stack([np.arange(8192), rng.permutation(8192)]).astype(np.int32)
    want = np.asarray(jtr.rope_rotate(jnp.asarray(x), jnp.asarray(pos),
                                      theta))
    got = ttr.rope_rotate(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_rope_rotate_keeps_the_dtype_and_refuses_an_odd_head_dim():
    x = torch.randn((1, 4, 2, 8), dtype=torch.bfloat16)
    assert ttr.rope_rotate(x, torch.arange(4)[None]).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="even head dim"):
        ttr.rope_rotate(torch.zeros((1, 4, 2, 7)), torch.arange(4)[None])
    with pytest.raises(ValueError, match="even head dim"):
        ttr.gpt_lm("tiny", d_model=36, n_heads=4, pos_emb="rope")


def test_rope_scores_depend_only_on_relative_position():
    """The defining property (JAX's tests/test_rope.py): q.k after the
    rotation depends on the positions only through their difference."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 1, 1, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 1, 16)).astype(
        np.float32))

    def score(i, j):
        return float((ttr.rope_rotate(q, torch.tensor([[i]]))
                      * ttr.rope_rotate(k, torch.tensor([[j]]))).sum())

    assert abs(score(5, 2) - score(105, 102)) < 1e-4
    assert abs(score(5, 2) - score(2, 5)) > 1e-3


# --- the model against flax -----------------------------------------------

def _pair(seed=0, **overrides):
    """The tiny causal LM in both packages on the same f32 weights."""
    kw = dict(compute_dtype=jnp.float32, dropout_rate=0.0, **overrides)
    jmodel = jtr.gpt_lm(size="tiny", **kw)
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32,
                        dropout_rate=0.0, **overrides)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


FORWARD = {"rope": dict(pos_emb="rope"),
           "rope_theta": dict(pos_emb="rope", rope_theta=5e5),
           "gqa": dict(n_kv_heads=2), "mqa": dict(n_kv_heads=1),
           "swiglu": dict(mlp_variant="swiglu"),
           "rmsnorm": dict(norm="rmsnorm"),
           "window": dict(attn_window=5),
           "llama": dict(LLAMA, tie_embeddings=True),
           "llama_untied": dict(LLAMA),
           "llama_window": dict(LLAMA, attn_window=5)}


@pytest.mark.parametrize("case", FORWARD)
def test_forward_logits_and_grads_match_flax(case):
    jmodel, params, tmodel = _pair(**FORWARD[case])
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, (2, 16)).astype(np.int32)
    targets = rng.integers(0, 64, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.8).astype(np.float32)

    def jloss(p):
        logits = jmodel.apply({"params": p}, tokens, train=False)
        return jax_masked_ce(logits, targets, mask), logits

    (_, j_logits), j_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    t_logits = tmodel(torch.from_numpy(tokens))
    masked_softmax_cross_entropy(t_logits, torch.from_numpy(targets),
                                 torch.from_numpy(mask)).backward()
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), **TOL)
    want = interop.params_from_flax(jax.device_get(j_grads))
    assert {n for n, _ in tmodel.named_parameters()} == set(want)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_gqa_widen_interleaves_and_tiling_would_fail(monkeypatch):
    """K/V head j serves query heads j*g .. j*g + g - 1 (jnp.repeat's
    order). Tiling (``.repeat``) pairs query heads with the wrong K/V
    head: the same check then fails."""
    jmodel, params, tmodel = _pair(n_kv_heads=2)
    tokens = np.random.default_rng(3).integers(0, 64, (2, 16)).astype(
        np.int32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, tokens))
    with torch.no_grad():
        np.testing.assert_allclose(tmodel(torch.from_numpy(tokens)).numpy(),
                                   want, **TOL)

        def tiled(t, g, dim):
            return t.repeat(*[g if d == dim else 1 for d in range(t.ndim)])

        monkeypatch.setattr(torch.Tensor, "repeat_interleave", tiled)
        wrong = tmodel(torch.from_numpy(tokens)).numpy()
    assert np.abs(wrong - want).max() > 1e-3


def test_interop_round_trips_the_llama_tree():
    """params_to_flax inverts params_from_flax on the q/kv kernels, the
    gate, the scale-only norms and a tree without pos_emb."""
    _, params, tmodel = _pair(**LLAMA, tie_embeddings=True)
    host = jax.device_get(params)
    back = interop.params_to_flax(dict(tmodel.named_parameters()), tmodel)
    assert "pos_emb" not in back and "lm_head" not in back
    attn = back["layer_0"]["attn"]
    assert attn["q"]["kernel"].shape == (32, 4, 8)
    assert attn["kv"]["kernel"].shape == (32, 2, 2, 8)
    assert attn["kv"]["bias"].shape == (2, 2, 8)
    assert set(back["layer_0"]["ln1"]) == {"scale"}
    assert set(back["layer_0"]["mlp"]) == {"down", "gate", "up"}
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           {k: host[k] for k in sorted(host)})


# --- train() against JAX's train() ------------------------------------------

def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _jax_init(jcfg):
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             jax_make_task(jcfg, mesh))
    return interop.params_from_flax(jax.device_get(jstate.params))


TRAIN = {"rope": dict(pos_emb="rope"),
         "gqa": dict(n_kv_heads=2),
         "swiglu": dict(mlp_variant="swiglu"),
         "rmsnorm": dict(norm="rmsnorm"),
         "window": dict(attn_window=8),
         "llama_dense": dict(LLAMA),
         "llama_fused_scan": dict(LLAMA, ce_chunk=32, ce_impl="scan"),
         "llama_tied_fused_kernel": dict(LLAMA, tie_embeddings=True,
                                         ce_chunk=32, ce_impl="kernel")}


@pytest.mark.parametrize("case", TRAIN)
def test_five_step_trajectory_matches_jax_train(case):
    fields = dict(TINY, **TRAIN[case])
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


@pytest.mark.parametrize("remat", ["none", "full"])
def test_seq2_composition_matches_jax_seq_mesh(remat, tmp_path):
    """3 steps of the Llama composition (tied) under --mesh.seq 2 in two
    spawned gloo ranks (the zigzag ring with RoPE at each block's global
    offset and GQA widened before the ring; under --remat full each
    rank recomputes its blocks, the ring's permutes included) against
    JAX on a (data 4, seq 2) mesh of the 8 CPU devices."""
    fields = dict(TINY, train_steps=3, tie_embeddings=True, remat=remat,
                  **LLAMA)
    jcfg = JaxConfig(**fields, mesh=JaxMesh(data=4, seq=2))
    jres = jloop.train(jcfg, logger=MetricLogger(enabled=False))
    torch.save(_jax_init(jcfg), tmp_path / "init.pt")
    spawn_ranks(train_run, 2, tmp_path, fields, tmp_path / "init.pt",
                tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], _losses(jres.logger),
                                   atol=1e-4)
        np.testing.assert_allclose(rank["final"]["loss"],
                                   jres.final_metrics["loss"], atol=1e-4)
        for name, value in rank["params"].items():
            assert torch.equal(value, ranks[0]["params"][name]), name


def test_cli_trains_the_llama_options_on_cpu(capsys):
    from tensorflow_distributed_tpu_torch import cli

    argv = ["--device", "cpu", "--model", "gpt_lm", "--model-size", "tiny",
            "--seq-len", "64", "--batch-size", "8", "--train-steps", "3",
            "--eval-batch-size", "8", "--eval-every", "0", "--log-every",
            "1", "--pos-emb", "rope", "--n-kv-heads", "2", "--mlp-variant",
            "swiglu", "--norm", "rmsnorm", "--tie-embeddings", "true",
            "--attn-window", "16", "--remat", "dots", "--optimizer",
            "adafactor"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"event": "done"' in out and out.count("[step") == 3


@pytest.mark.parametrize("jax_fields,argv", [
    (dict(pos_emb="alibi"), ["--pos-emb", "alibi"]),
    (dict(rope_theta=5e5), ["--rope-theta", "5e5"]),
    (dict(pos_emb="rope", rope_theta=0.0), ["--pos-emb", "rope",
                                            "--rope-theta", "0"]),
    (dict(n_kv_heads=-1), ["--n-kv-heads", "-1"]),
    (dict(attn_window=-1), ["--attn-window", "-1"]),
    (dict(attn_window=8, mesh=JaxMesh(data=1, seq=2)),
     ["--attn-window", "8", "--mesh.seq", "2"]),
    (dict(model="mnist_cnn", attn_window=8),
     ["--model", "mnist_cnn", "--attn-window", "8"]),
    (dict(mlp_variant="geglu"), ["--mlp-variant", "geglu"]),
    (dict(norm="batchnorm"), ["--norm", "batchnorm"]),
    (dict(remat="some"), ["--remat", "some"]),
], ids=["pos_emb", "theta_without_rope", "theta_zero", "kv_heads",
        "window_negative", "window_ring", "window_cnn", "mlp", "norm",
        "remat"])
def test_config_rejects_what_jax_rejects(jax_fields, argv):
    with pytest.raises(ValueError):
        JaxConfig(**dict(dict(model="gpt_lm"), **jax_fields)).validate()
    with pytest.raises(ValueError):
        _parse(argv)


def _parse(argv):
    from tensorflow_distributed_tpu_torch.config import parse_args

    return parse_args(["--model", "gpt_lm", "--device", "cpu"] + argv)


def test_kv_heads_must_divide_the_heads_as_in_jax():
    jmodel = jtr.gpt_lm(size="tiny", n_kv_heads=3)
    with pytest.raises(ValueError, match="not divisible by n_kv_heads 3"):
        jmodel.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(ValueError, match="not divisible by n_kv_heads 3"):
        ttr.gpt_lm("tiny", n_kv_heads=3)


def test_new_fields_have_the_jax_spellings_and_defaults():
    from tensorflow_distributed_tpu_torch.config import OPTIMIZERS

    cfg = _parse(["--pos-emb", "rope", "--rope-theta", "500000",
                  "--n-kv-heads", "4", "--attn-window", "512",
                  "--mlp-variant", "swiglu", "--norm", "rmsnorm",
                  "--remat", "full", "--optimizer", "adafactor"])
    assert (cfg.pos_emb, cfg.rope_theta, cfg.n_kv_heads, cfg.attn_window,
            cfg.mlp_variant, cfg.norm, cfg.remat, cfg.optimizer) == (
        "rope", 5e5, 4, 512, "swiglu", "rmsnorm", "full", "adafactor")
    for name in ("pos_emb", "rope_theta", "n_kv_heads", "attn_window",
                 "mlp_variant", "norm", "remat", "kv_cache_quant",
                 "moe_experts", "shard_vocab"):
        assert getattr(TrainConfig(), name) == getattr(JaxConfig(), name)
    assert OPTIMIZERS == ("adam", "sgd", "adafactor")


# --- decode: the narrow cache ---------------------------------------------

DECODE = {"rope_gqa": dict(pos_emb="rope", n_kv_heads=2),
          "rope_gqa_window": dict(pos_emb="rope", n_kv_heads=2,
                                  attn_window=5),
          "llama_mqa": dict(LLAMA, n_kv_heads=1, tie_embeddings=True),
          "rope_mha": dict(pos_emb="rope")}


@pytest.mark.parametrize("case", DECODE)
def test_decode_with_the_narrow_cache_matches_jax(case):
    """Prefill three rows, then six steps with the rows at three depths:
    logits within 1e-5 of JAX's, the port's cache equal to JAX's narrow
    one ([B, max_len, nk, Dh]) and, pinned to it, the next step's
    logits too."""
    jmodel, params, tmodel = _pair(**DECODE[case])
    nk = tmodel.cfg.n_kv_heads or tmodel.cfg.n_heads
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 64, (3, 10)).astype(np.int32)
    jlogits, jcache = jgen.prefill_cache(jmodel, params, jnp.asarray(prompt))
    tlogits, tcache = tgen.prefill_cache(tmodel, torch.from_numpy(prompt))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    depth = np.asarray([10, 7, 4], np.int32)
    for t in range(6):
        tok = rng.integers(0, 64, (3,)).astype(np.int32)
        jlast, jcache = jgen.decode_token(jmodel, params, jcache,
                                          jnp.asarray(tok),
                                          jnp.asarray(depth + t))
        pinned = interop.cache_from_flax(jax.device_get(jcache))
        tlast, tcache = tgen.decode_token(tmodel, tcache,
                                          torch.from_numpy(tok),
                                          torch.from_numpy(depth + t))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   err_msg=f"step {t}", **TOL)
        for got, ref in zip(tcache.k + tcache.v, pinned.k + pinned.v):
            assert got.shape == ref.shape == (3, 128, nk, 8)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
        tcache = pinned
    tok = rng.integers(0, 64, (3,)).astype(np.int32)
    jlast, _ = jgen.decode_token(jmodel, params, jcache, jnp.asarray(tok),
                                 jnp.asarray(depth + 6))
    tlast, _ = tgen.decode_token(tmodel, tcache, torch.from_numpy(tok),
                                 torch.from_numpy(depth + 6))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)


@pytest.mark.parametrize("case", ["rope_gqa", "rope_gqa_window"])
def test_decode_matches_the_training_forward(case):
    _, _, model = _pair(**DECODE[case])
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (2, 12)))
    with torch.no_grad():
        full = model(tokens)
    logits, cache = tgen.prefill_cache(model, tokens[:, :5])
    torch.testing.assert_close(logits, full[:, :5], **TOL)
    for t in range(5, 12):
        last, cache = tgen.decode_token(model, cache, tokens[:, t],
                                        torch.tensor([t]))
        torch.testing.assert_close(last, full[:, t], **TOL)


@pytest.mark.parametrize("nk", [1, 2, 4])
def test_cache_is_nk_over_h_of_the_mha_cache(nk):
    cfg = ttr.tiny_config(causal=True, n_kv_heads=nk)
    cache = ttr.KVCache.zeros(cfg, 3)
    mha = ttr.KVCache.zeros(ttr.tiny_config(causal=True), 3)
    assert cache.k[0].shape == (3, cfg.max_len, nk, 8)
    assert cache.nbytes() * cfg.n_heads == mha.nbytes() * nk


@pytest.mark.parametrize("case", ["rope_gqa", "rope_gqa_window"])
def test_generate_and_beam_search_are_token_identical_to_jax(case):
    jmodel, params, tmodel = _pair(seed=3, **DECODE[case])
    rng = np.random.default_rng(3)
    for plen in (1, 7, 20):
        prompt = rng.integers(0, 64, (2, plen)).astype(np.int32)
        want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(prompt),
                                        10))
        got = tgen.generate(tmodel, torch.from_numpy(prompt), 10).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"prompt {plen}")
    prompt = rng.integers(0, 64, (2, 6)).astype(np.int32)
    jseq, jscore = jgen.beam_search(jmodel, params, jnp.asarray(prompt), 8,
                                    num_beams=3)
    tseq, tscore = tgen.beam_search(tmodel, torch.from_numpy(prompt), 8,
                                    num_beams=3)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), **TOL)


def test_engine_with_the_narrow_cache_is_token_identical_to_jax():
    """Six requests through three slots (reused) with RoPE + GQA 2: every
    stream equals generate() and JAX's engine under JAX's scheduler, and
    a slot's cache holds nk / H of the MHA engine's bytes, as JAX's."""
    jmodel, params, tmodel = _pair(**LLAMA)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, size=n).astype(np.int32)
               for n in (3, 9, 17, 30, 5, 12)]
    engine = SlotDecodeEngine(tmodel, num_slots=3)
    engine.warmup()
    tdone = {c.rid: c for c in tsched.Scheduler(engine, decode_priority=3).run(
        [tsched.Request(rid=i, prompt=p, max_new_tokens=10)
         for i, p in enumerate(prompts)])}
    jeng = JaxEngine(jmodel, params, num_slots=3)
    jdone = {c.rid: c for c in jsched.Scheduler(jeng, decode_priority=3).run(
        [jsched.Request(rid=i, prompt=p, max_new_tokens=10)
         for i, p in enumerate(prompts)])}
    for i, p in enumerate(prompts):
        ref = tgen.generate(tmodel, torch.from_numpy(p)[None].long(), 10)[0]
        assert tdone[i].tokens == ref.tolist(), f"request {i} vs generate()"
        assert tdone[i].tokens == jdone[i].tokens, f"request {i} vs JAX"
    assert engine.cache_bytes_per_slot() == jeng.cache_bytes_per_slot()
    mha = SlotDecodeEngine(ttr.gpt_lm("tiny", compute_dtype=torch.float32),
                           num_slots=3)
    assert engine.cache_bytes_per_slot() * 2 == mha.cache_bytes_per_slot()
