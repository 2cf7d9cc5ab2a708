"""PyTorch port: tensor-parallel serving (``--serve.mesh-model N``)
against the JAX package's one-device engines on the CPU.

JAX's contract is that a TP replica is token-identical to one device
(its ``config.py``'s ``serve.mesh_model`` comment); its own TP engine
needs a slow two-device compile, so the oracle here is its one-device
``SlotDecodeEngine`` / ``PagedSlotEngine`` on the same weights (a tiny
``gpt_lm`` of 4 heads, and the Llama-style tiny GPT: RoPE, 2 K/V
heads), f32:

- the TP decode branch on ``StackedTP(2)``: prefill and decode logits
  within 1e-5 of JAX's;
- the ``Scheduler``'s streams over the TP engines equal JAX's exactly:
  dense, paged in sessions with radix hits, int8, k-gram at k 4, on the
  requests of ``tests/test_serve_tp.py``;
- ``cache_bytes_per_slot`` x 2 equals the one-device engine's (JAX's
  ``tests/test_serve_tp.py`` contract), and ``page_bytes_estimate(cfg,
  p, tp)`` equals JAX's for tp 1, 2, 4 (bf16 and int8);
- one leg through the spawned-worker path over gloo: the CLI serving a
  checkpoint of the same weights at ``--serve.mesh-model 2`` journals
  JAX's streams;
- the ``mesh_model`` refusals carry JAX's messages; MoE and a
  multi-process ``--mesh.*`` (a fleet replica's too) stay refused naming
  ROADMAP.md A6.
"""

import json
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import ServeConfig as JaxServe
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import generate as jgen
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.serve import engine as jeng
from tensorflow_distributed_tpu.serve import run as jrun
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu.serve import speculate as jspec
from tensorflow_distributed_tpu.serve.paging import engine as jpe
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig, parse_args
from tensorflow_distributed_tpu_torch.models import generate as tgen
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    shard_state_dict)
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    StackedTP)
from tensorflow_distributed_tpu_torch.serve import journal as journal_mod
from tensorflow_distributed_tpu_torch.serve import run as trun
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from tensorflow_distributed_tpu_torch.serve import speculate as tspec
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from tensorflow_distributed_tpu_torch.serve.paging import engine as tpe
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"mha": {}, "gqa": dict(n_kv_heads=2, pos_emb="rope")}
MAX_LEN = 64


def _models(kind: str, **extra):
    """(JAX model, its params, the port's TP model on StackedTP(2), the
    port's whole model) on the same tiny weights."""
    kw = dict(MODELS[kind], **extra)
    jmodel = jtr.CausalLM(jtr.tiny_config(
        causal=True, compute_dtype=jnp.float32, max_len=MAX_LEN, **kw))
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    whole = ttr.gpt_lm("tiny", compute_dtype=torch.float32, max_len=MAX_LEN,
                       **kw)
    whole.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    tp = ttr.gpt_lm("tiny", tp=StackedTP(2), compute_dtype=torch.float32,
                    max_len=MAX_LEN, **kw)
    tp.load_state_dict(shard_state_dict(whole.state_dict(), tp))
    return jmodel, params, tp.eval(), whole.eval()


def _requests(mod, n=3, max_new=8):
    """tests/test_serve_tp.py's requests."""
    return [mod.Request(rid=i, prompt=np.random.default_rng(i).integers(
        0, 64, size=L).astype(np.int32), max_new_tokens=max_new)
        for i, L in enumerate([3, 9, 5][:n])]


def _session_requests(mod):
    """Two conversations of three turns, each turn extending the last
    (radix and session hits), as tests/test_torch_paging.py's."""
    rng = np.random.default_rng(11)
    base = [rng.integers(0, 64, n).astype(np.int32)
            for n in (9, 5, 4, 12, 3, 6)]
    prompts, sessions = [], []
    for g in (0, 3):
        for j in range(g, g + 3):
            prompts.append(base[j] if j == g
                           else np.concatenate([prompts[-1], base[j]]))
            sessions.append(f"s{g // 3}")
    return [mod.Request(rid=i, prompt=p, max_new_tokens=6,
                        session=sessions[i]) for i, p in enumerate(prompts)]


LEGS = ("dense", "paged", "int8", "kgram")


def _engine(leg, mod, model, params=None):
    """``leg``'s engine of package ``mod`` (jeng/jpe or the port) and its
    speculator."""
    jax_side = params is not None
    args = (model, params) if jax_side else (model,)
    if leg == "paged":
        cls = jpe.PagedSlotEngine if jax_side else tpe.PagedSlotEngine
        return cls(*args, 2, page_size=8), None
    cls = jeng.SlotDecodeEngine if jax_side else SlotDecodeEngine
    if leg == "kgram":
        spec = (jspec if jax_side else tspec).SelfDraft(2, 4)
        return cls(*args, 2, spec_tokens=4), spec
    return cls(*args, 2), None


def _streams(leg, mod, model, params=None):
    engine, spec = _engine(leg, mod, model, params)
    reqs = (_session_requests(mod) if leg == "paged" else _requests(mod))
    done = mod.Scheduler(engine, decode_priority=2,
                         speculator=spec).run(reqs)
    return {c.rid: list(c.tokens) for c in done}, engine


@pytest.fixture(scope="module")
def pairs():
    """Each model kind's JAX model and port models, and JAX's streams
    for each leg (computed once)."""
    out = {}
    for kind in MODELS:
        for quant in ("none", "int8"):
            extra = {"kv_cache_quant": quant} if quant != "none" else {}
            out[kind, quant] = _models(kind, **extra)
    return out


@pytest.fixture(scope="module")
def jax_streams(pairs):
    cache = {}

    def get(kind, leg):
        if (kind, leg) not in cache:
            jm, params, _, _ = pairs[kind, "int8" if leg == "int8"
                                     else "none"]
            cache[kind, leg] = _streams(leg, jsched, jm, params)
        return cache[kind, leg]

    return get


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_tp_prefill_and_decode_logits_equal_jax(kind, quant, pairs):
    """Prefill of a 9-token prompt, then 6 decode steps fed JAX's greedy
    tokens: the TP model's logits within 1e-5 of JAX's at every step."""
    jm, params, tp, _ = pairs[kind, quant]
    prompt = np.random.default_rng(5).integers(0, 64, (2, 9))
    jl, jc = jgen.prefill_cache(jm, params, jnp.asarray(prompt, jnp.int32))
    tl, tc = tgen.prefill_cache(tp, torch.from_numpy(prompt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    jlast = np.asarray(jl)[:, -1]
    for i in range(6):
        tok = jlast.argmax(-1)
        jlast, jc = jgen.decode_token(jm, params, jc,
                                      jnp.asarray(tok, jnp.int32),
                                      jnp.asarray([9 + i]))
        tlast, tc = tgen.decode_token(tp, tc, torch.from_numpy(tok),
                                      torch.tensor([9 + i]))
        jlast = np.asarray(jlast)
        np.testing.assert_allclose(tlast.numpy(), jlast, atol=1e-5, rtol=0)


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_tp_scheduler_streams_equal_jax(kind, leg, pairs, jax_streams):
    """The Scheduler over the TP engine serves JAX's one-device streams,
    token for token (the paged leg with radix and session hits)."""
    want, jengine = jax_streams(kind, leg)
    _, _, tp, _ = pairs[kind, "int8" if leg == "int8" else "none"]
    got, engine = _streams(leg, tsched, tp)
    assert got == want
    assert engine.tp_width == 2 and jengine.tp_width == 1
    if leg == "paged":
        assert engine.prefix_hits == jengine.prefix_hits > 0
    if leg == "kgram":
        assert engine.verify_steps == jengine.verify_steps > 0


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_cache_bytes_per_slot_is_per_device(kind, quant, pairs):
    """JAX's tests/test_serve_tp.py contract: the one-device engine
    reports 2x a width-2 engine's bytes a slot (per device), and the
    same of a page."""
    jm, params, tp, whole = pairs[kind, quant]
    one = jeng.SlotDecodeEngine(jm, params, num_slots=2)
    eng = SlotDecodeEngine(tp, 2)
    assert eng.tp_width == 2
    assert one.cache_bytes_per_slot() == 2 * eng.cache_bytes_per_slot()
    assert SlotDecodeEngine(whole, 2).cache_bytes_per_slot() == (
        one.cache_bytes_per_slot())
    paged = tpe.PagedSlotEngine(tp, 2, page_size=8)
    assert 2 * paged.page_bytes() == tpe.PagedSlotEngine(
        whole, 2, page_size=8).page_bytes()
    assert paged.page_bytes() == tpe.page_bytes_estimate(tp.cfg, 8, 2)


@pytest.mark.parametrize("opts", [
    dict(compute_dtype=torch.float32),
    dict(compute_dtype=torch.bfloat16),
    dict(compute_dtype=torch.bfloat16, kv_cache_quant="int8"),
    dict(compute_dtype=torch.bfloat16, n_kv_heads=2),
    dict(compute_dtype=torch.bfloat16, kv_cache_quant="int8", n_kv_heads=2)])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_page_bytes_estimate_with_tp_equals_jax(opts, tp):
    tm = ttr.gpt_lm("tiny", max_len=MAX_LEN, **opts)
    jdtype = {torch.float32: jnp.float32,
              torch.bfloat16: jnp.bfloat16}[opts["compute_dtype"]]
    jcfg = jtr.tiny_config(causal=True, max_len=MAX_LEN,
                           **dict(opts, compute_dtype=jdtype))
    for ps in (4, 8, 16):
        assert (tpe.page_bytes_estimate(tm.cfg, ps, tp)
                == jpe.page_bytes_estimate(jcfg, ps, tp))


def _err(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


SERVE = ["--mode", "serve", "--model", "gpt_lm", "--compute-dtype",
         "float32", "--device", "cpu", "--serve.num-requests", "2",
         "--serve.max-new-tokens", "4"]


def _jax_serve(**fields):
    return jrun.serve_run(JaxConfig(mode="serve", model="gpt_lm",
                                    compute_dtype="float32",
                                    **fields))


@pytest.mark.parametrize("case", ["below_one", "not_serving"])
def test_mesh_model_config_refusals_equal_jax(case):
    from tensorflow_distributed_tpu_torch.config import ServeConfig

    if case == "below_one":
        fields = dict(mode="serve", model="gpt_lm")
        serve = dict(mesh_model=0)
    else:
        fields = dict(mode="train", model="gpt_lm")
        serve = dict(mesh_model=2)
    want = _err(lambda: JaxConfig(serve=JaxServe(**serve),
                                  **fields).validate())
    got = _err(lambda: TrainConfig(serve=ServeConfig(**serve), device="cpu",
                                   **fields).validate())
    assert got == want


@pytest.mark.parametrize("case", ["heads", "vocab"])
def test_mesh_model_serve_refusals_equal_jax(case):
    """JAX's serve/run.py checks, where the model facts are known: N
    dividing n_heads (tiny's 4 heads over 3), and N dividing the vocab
    (GPT-2-small's 50257 over 2, without --shard-vocab)."""
    size, width = ("tiny", 3) if case == "heads" else ("small", 2)
    want = _err(lambda: _jax_serve(
        model_size=size, serve=JaxServe(mesh_model=width,
                                                num_requests=2,
                                                max_new_tokens=4)))
    got = _err(lambda: trun.serve_setup(parse_args(SERVE + [
        "--model-size", size, "--serve.mesh-model", str(width)])))
    assert got == want


def test_too_few_cards_fail_with_jax_message(monkeypatch):
    """--serve.mesh-model N with fewer than N cards fails before any
    process starts, with JAX's message (JAX's 8 CPU devices, 16
    asked); no worker falls back to the CPU."""
    want = _err(lambda: _jax_serve(
        model_size="tiny", serve=JaxServe(mesh_model=16,
                                                  num_requests=2)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cfg = parse_args(SERVE + ["--model-size", "tiny",
                              "--serve.mesh-model", "16"])
    model_cfg = tloop.build_model_for(cfg, "meta").cfg
    got = _err(lambda: trun.check_tp_serving(cfg, model_cfg,
                                             torch.device("cuda")))
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--model", "moe_lm", "--serve.mesh-model", "2"],
    # A fleet replica over a multi-process mesh.
    ["--serve.inbox", "inbox.jsonl", "--serve.journal", "j.jsonl",
     "--seq-len", "64", "--mesh.seq", "2"],
    ["--mesh.data", "2"]], ids=["moe", "inbox", "multi_process"])
def test_what_stays_out_names_a6(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        parse_args(["--mode", "serve", "--model", "gpt_lm", "--device",
                    "cpu"] + argv)


def test_gloo_replica_through_the_cli_serves_jax_streams(tmp_path, pairs,
                                                         jax_streams):
    """The spawned-worker path: the CLI at --serve.mesh-model 2 over
    gloo, serving a checkpoint of the JAX weights, journals the JAX
    one-device engine's streams; its summary reports width 2 and half a
    card's cache bytes."""
    jm, params, _, whole = pairs["mha", "none"]
    cfg = TrainConfig(model="gpt_lm", model_size="tiny", seq_len=MAX_LEN,
                      compute_dtype="float32", device="cpu")
    _, state = tloop._build_model_and_state(
        cfg, torch.device("cpu"), init_params=whole.state_dict())
    ckpt.save(str(tmp_path / "ck"), state)
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps(
        {"prompt": [int(t) for t in r.prompt], "max_new_tokens": 8}) + "\n"
        for r in _requests(jsched)))
    journal = tmp_path / "j.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "tensorflow_distributed_tpu_torch.cli",
         "--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
         "--seq-len", str(MAX_LEN), "--compute-dtype", "float32",
         "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
         "--serve.requests", str(reqs), "--serve.num-slots", "2",
         "--serve.decode-priority", "2", "--serve.mesh-model", "2",
         "--serve.journal", str(journal)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "[serve] tensor-parallel replica: model=2" in out.stdout
    summary = json.loads(next(line for line in out.stdout.splitlines()
                              if '"serve_summary"' in line))
    one = jeng.SlotDecodeEngine(jm, params, num_slots=2)
    assert summary["tp_width"] == 2
    assert 2 * summary["per_device_cache_bytes"] == (
        one.cache_bytes_per_slot() * 2)
    played = journal_mod.replay(str(journal))
    want, _ = jax_streams("mha", "dense")
    assert {r: e["tokens"] for r, e in played.items()} == want
