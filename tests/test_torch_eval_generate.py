"""PyTorch port: ``--mode eval``, ``--mode generate`` (greedy, sampled,
``beam_search``) and ``--mode serve --checkpoint-dir`` against the JAX
package, and the two repairs that serve them (the decode-cache write at
the cache end, the window edge of the flash dispatcher).

The checkpoint is the JAX package's own: its ``train()`` writes it (2
steps of the tiny GPT with an EMA), and the port's CLI reads it. The
port's eval record equals JAX's ``evaluate_only`` to 1e-5, its greedy
tokens equal JAX's ``generate_only``'s, and ``beam_search`` equals
JAX's (sequences exact, scores to 1e-5) on shared weights for 1, 3 and
4 beams, with and without eos, at length penalty 0 and 1. Sampling is
held to determinism per seed and to its filtered support; serving a
checkpoint streams what ``generate()`` makes of the restored weights.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.config import parse_args as jax_parse_args
from tensorflow_distributed_tpu.models import generate as jgen
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.ops import flash_attention as jfa
from tensorflow_distributed_tpu.serve import run as jserve
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu_torch import cli, interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import generate as tgen
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.ops import flash_attention as tfa
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401

TINY = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
            eval_every=0, log_every=1, eval_batch_size=8,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0, ema_decay=0.9)
ARGV = ["--model", "gpt_lm", "--model-size", "tiny", "--seq-len", "32",
        "--batch-size", "8", "--eval-batch-size", "8", "--compute-dtype",
        "float32", "--ema-decay", "0.9", "--device", "cpu"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A checkpoint written by the JAX package: 2 steps, EMA on."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jloop.train(JaxConfig(**TINY, train_steps=2, checkpoint_dir=d,
                          checkpoint_every=2),
                logger=MetricLogger(enabled=False))
    assert ckpt.available_steps(d) == [2]
    return d


def _record(out: str, event: str) -> dict:
    return next(json.loads(line) for line in out.splitlines()
                if line.startswith(f'{{"event": "{event}"'))


def _restored_model(d):
    """The port's model with the checkpoint's EMA weights, as
    generate_only and serve load it."""
    cfg = TrainConfig(**TINY, device="cpu")
    model, state = tloop._build_model_and_state(cfg, torch.device("cpu"))
    state = ckpt.restore(d, state)
    model.load_state_dict(state.ema)
    return model


# --- --mode eval and --mode generate through the CLI ------------------------

def test_cli_eval_equals_jax_evaluate_only(jax_ckpt, capsys):
    assert cli.main(ARGV + ["--mode", "eval", "--checkpoint-dir",
                            jax_ckpt]) == 0
    got = _record(capsys.readouterr().out, "eval")
    want = jloop.evaluate_only(JaxConfig(**TINY, mode="eval",
                                         checkpoint_dir=jax_ckpt),
                               logger=MetricLogger(enabled=False))
    assert got["step"] == 2 and got["eval_seconds"] >= 0
    for k, v in want.items():
        assert abs(got[f"val_{k}"] - v) <= 1e-5 + 5e-6, k  # 5 decimals


def test_cli_greedy_generate_equals_jax_generate_only(jax_ckpt, capsys):
    assert cli.main(ARGV + ["--mode", "generate", "--checkpoint-dir",
                            jax_ckpt, "--prompt", "5,9,1,33",
                            "--max-new-tokens", "10"]) == 0
    got = _record(capsys.readouterr().out, "generate")
    want = jloop.generate_only(
        JaxConfig(**TINY, mode="generate", checkpoint_dir=jax_ckpt,
                  prompt="5,9,1,33", max_new_tokens=10),
        logger=MetricLogger(enabled=False))
    assert got == {k: want[k] for k in ("event", "step", "prompt",
                                        "new_tokens")}
    assert len(got["new_tokens"]) == 10


def test_cli_beam_generate_equals_jax_generate_only(jax_ckpt, capsys):
    assert cli.main(ARGV + ["--mode", "generate", "--checkpoint-dir",
                            jax_ckpt, "--prompt", "7,2", "--max-new-tokens",
                            "6", "--num-beams", "3"]) == 0
    got = _record(capsys.readouterr().out, "generate")
    want = jloop.generate_only(
        JaxConfig(**TINY, mode="generate", checkpoint_dir=jax_ckpt,
                  prompt="7,2", max_new_tokens=6, num_beams=3),
        logger=MetricLogger(enabled=False))
    assert got["new_tokens"] == want["new_tokens"]
    assert abs(got["beam_score"] - want["beam_score"]) <= 1e-5


@pytest.mark.parametrize("beams", [1, 3])
def test_cli_int8_generate_equals_jax_generate_only(jax_ckpt, beams, capsys):
    """--kv-cache-quant int8 in generate mode: the port decodes the
    checkpoint over the int8 cache to JAX's tokens (and beam score)."""
    extra = ["--prompt", "5,9,1,33", "--max-new-tokens", "8",
             "--num-beams", str(beams)]
    assert cli.main(ARGV + ["--mode", "generate", "--checkpoint-dir",
                            jax_ckpt, "--kv-cache-quant", "int8"]
                    + extra) == 0
    got = _record(capsys.readouterr().out, "generate")
    want = jloop.generate_only(
        JaxConfig(**TINY, mode="generate", checkpoint_dir=jax_ckpt,
                  prompt="5,9,1,33", max_new_tokens=8, num_beams=beams,
                  kv_cache_quant="int8"),
        logger=MetricLogger(enabled=False))
    assert got["new_tokens"] == want["new_tokens"]
    if beams > 1:
        assert abs(got["beam_score"] - want["beam_score"]) <= 1e-5


def test_sampling_is_deterministic_per_seed_and_in_its_support(jax_ckpt,
                                                               capsys):
    argv = ARGV + ["--mode", "generate", "--checkpoint-dir", jax_ckpt,
                   "--prompt", "3,4,5", "--max-new-tokens", "8",
                   "--gen-temperature", "1.5", "--gen-top-k", "3"]
    runs = []
    for seed in ("1", "1", "2"):
        assert cli.main(argv + ["--seed", seed]) == 0
        runs.append(_record(capsys.readouterr().out,
                            "generate")["new_tokens"])
    assert runs[0] == runs[1]
    model = _restored_model(jax_ckpt)
    for toks in runs:
        seq = [3, 4, 5]
        for tok in toks:
            logits, _ = tgen.prefill_cache(model, torch.tensor([seq]))
            assert tok in torch.topk(logits[0, -1], 3).indices.tolist()
            seq.append(tok)


def test_generate_refuses_prompt_ids_outside_the_vocab(jax_ckpt):
    cfg = TrainConfig(**TINY, mode="generate", checkpoint_dir=jax_ckpt,
                      prompt="1,64", device="cpu")
    with pytest.raises(ValueError, match="outside the model vocabulary"):
        tloop.generate_only(cfg)
    cfg = TrainConfig(**TINY, mode="generate", checkpoint_dir=jax_ckpt,
                      prompt="hello", device="cpu")
    with pytest.raises(ValueError, match="comma-separated token ids"):
        tloop.generate_only(cfg)


# --- beam_search against JAX --------------------------------------------------

def _pair(seed=0):
    kw = dict(compute_dtype=jnp.float32, dropout_rate=0.0)
    jmodel = jtr.gpt_lm(size="tiny", **kw)
    params = fnn.meta.unbox(jmodel.init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32,
                        dropout_rate=0.0)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def pair():
    return _pair(seed=4)


@pytest.mark.parametrize("num_beams", [1, 3, 4])
@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("length_penalty", [0.0, 1.0])
def test_beam_search_equals_jax(pair, num_beams, eos, length_penalty):
    """Two prompt rows, 7 new tokens. With ``eos`` the eos id is the
    prefill's runner-up token, so a beam freezes at its first step."""
    jmodel, params, tmodel = pair
    prompt = np.random.default_rng(num_beams).integers(
        0, 64, (2, 5)).astype(np.int32)
    eos_id = None
    if eos:
        logits, _ = tgen.prefill_cache(tmodel, torch.from_numpy(prompt))
        eos_id = int(torch.topk(logits[0, -1], 2).indices[-1])
    jseq, jscore = jgen.beam_search(jmodel, params, jnp.asarray(prompt), 7,
                                    num_beams=num_beams,
                                    length_penalty=length_penalty,
                                    eos_id=eos_id)
    tseq, tscore = tgen.beam_search(tmodel, torch.from_numpy(prompt), 7,
                                    num_beams=num_beams,
                                    length_penalty=length_penalty,
                                    eos_id=eos_id)
    assert tuple(tseq.shape) == (2, num_beams, 7)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), **TOL)
    if eos and num_beams > 1:
        assert (tseq == eos_id).any()


def test_one_beam_is_greedy(pair):
    _, _, tmodel = pair
    prompt = torch.tensor([[1, 2, 3], [9, 8, 7]])
    seq, _ = tgen.beam_search(tmodel, prompt, 9, num_beams=1)
    torch.testing.assert_close(seq[:, 0], tgen.generate(tmodel, prompt, 9))


@pytest.mark.parametrize("kw,match", [
    (dict(num_beams=0), "num_beams must be >= 1"),
    (dict(num_beams=65), "first expansion is a top-k"),
    (dict(eos_id=64), "outside vocab"),
    (dict(max_new_tokens=0), "max_new_tokens must be >= 1"),
    (dict(max_new_tokens=200), "max_len"),
])
def test_beam_search_argument_checks_as_jax(pair, kw, match):
    jmodel, params, tmodel = pair
    args = {"max_new_tokens": 4, **kw}
    n = args.pop("max_new_tokens")
    with pytest.raises(ValueError, match=match):
        jgen.beam_search(jmodel, params, jnp.ones((1, 2), jnp.int32), n,
                         **args)
    with pytest.raises(ValueError, match=match):
        tgen.beam_search(tmodel, torch.ones((1, 2), dtype=torch.long), n,
                         **args)


# --- --mode serve --checkpoint-dir ------------------------------------------

def test_serve_from_a_checkpoint_streams_what_generate_makes(jax_ckpt, capsys,
                                                             tmp_path):
    prompts = [[5, 11, 3, 7], [1, 2], [60, 61, 62, 63, 0, 9], [4]]
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps({"prompt": p, "max_new_tokens": 8})
                            + "\n" for p in prompts))
    assert cli.main(ARGV + ["--mode", "serve", "--checkpoint-dir", jax_ckpt,
                            "--serve.requests", str(path),
                            "--serve.num-slots", "2", "--serve.stream",
                            "true"]) == 0
    out = capsys.readouterr().out
    summary = _record(out, "serve_summary")
    assert summary["params"] == "checkpoint"
    assert "checkpoint params" in out
    streams = {}
    for line in out.splitlines():
        if line.startswith("[serve] rid="):
            rid, tok = line.split()[1:3]
            streams.setdefault(int(rid[4:]), []).append(int(tok[4:]))
    model = _restored_model(jax_ckpt)
    for rid, p in enumerate(prompts):
        want = tgen.generate(model, torch.tensor([p]), 8)[0].tolist()
        assert streams[rid] == want, rid


PAGED_RUNS = {
    "paged_int8_sessions": ["--serve.paged", "true", "--serve.page-size", "8",
                            "--serve.session-turns", "2", "--serve.kv-dtype",
                            "int8"],
    # Caps the pool at (budget - the params' 89,344 B) / 4,096 B = 16
    # pages, between the floor of 11 and the 19 the workload would take.
    "paged_budget": ["--serve.paged", "true", "--serve.page-size", "8",
                     "--serve.hbm-budget-gb", "0.0001443"],
    "int8_flag": ["--kv-cache-quant", "int8"],
}


def _streams(out):
    by_rid = {}
    for line in out.splitlines():
        if line.startswith("[serve] rid="):
            rid, tok = line.split()[1:3]
            by_rid.setdefault(int(rid[4:]), []).append(int(tok[4:]))
    return by_rid


@pytest.mark.parametrize("name", sorted(PAGED_RUNS))
def test_cli_paged_and_int8_serving_equal_jax(jax_ckpt, name, capsys):
    """serve_run of both packages on the same checkpoint: the same token
    streams, summary counts, paging fields, pool sizing and paged
    line."""
    argv = [a for a in ARGV if a not in ("--device", "cpu")] + [
        "--mode", "serve", "--checkpoint-dir", jax_ckpt,
        "--serve.num-slots", "3", "--serve.num-requests", "6",
        "--serve.prompt-len-min", "4", "--serve.prompt-len-max", "12",
        "--serve.max-new-tokens", "8", "--serve.stream", "true",
        *PAGED_RUNS[name]]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    summary = _record(out, "serve_summary")
    want = jserve.serve_run(jax_parse_args(argv))
    jout = capsys.readouterr().out
    assert _streams(out) == _streams(jout)
    assert sorted(_streams(out)) == list(range(6))
    keys = ["requests", "total_new_tokens", "decode_steps", "prefills",
            "prefill_compiles", "buckets", "params"]
    if "--serve.paged" in argv:
        keys += ["page_size", "num_pages", "page_bytes", "pages_per_max_len",
                 "pages_in_use", "pages_peak", "pool_occupancy",
                 "prefix_hits", "prefix_hit_tokens", "prompt_tokens",
                 "prefix_hit_rate", "prefill_tokens_computed",
                 "prefill_tokens_dense", "cow_copies", "page_evictions",
                 "slot_pages_peak", "cached_pages", "sessions"]
        for prefix in ("[serve] paged: ", "[serve] paged auto-size: "):
            got = [l for l in out.splitlines() if l.startswith(prefix)]
            assert got and got == [l for l in jout.splitlines()
                                   if l.startswith(prefix)]
    else:
        assert "page_size" not in summary
    for key in keys:
        assert summary[key] == want[key], key
    if name == "paged_int8_sessions":
        assert summary["prefix_hits"] >= 1
    if name == "paged_budget":
        assert summary["num_pages"] == 16 - 1  # the write-off page apart


# --- the repairs: the decode-cache write at the end, the window edge -------

def _small_pair(max_len):
    kw = dict(compute_dtype=jnp.float32, dropout_rate=0.0, max_len=max_len)
    jmodel = jtr.gpt_lm(size="tiny", **kw)
    params = fnn.meta.unbox(jmodel.init(
        jax.random.key(2), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32,
                        dropout_rate=0.0, max_len=max_len)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("form", ["broadcast", "per_row"])
def test_decode_write_past_the_cache_end_clamps_as_jax(form):
    """A 4-token write whose start runs past a 16-column cache lands at
    column 12 in both packages (JAX's ``dynamic_update_slice`` clamps
    the start); the positions themselves stay inside the position
    table. Cache contents and logits agree to 1e-5."""
    jmodel, params, tmodel = _small_pair(16)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 64, (2, 10)).astype(np.int32)
    _, jcache = jgen.prefill_cache(jmodel, params, jnp.asarray(prompt))
    _, tcache = tgen.prefill_cache(tmodel, torch.from_numpy(prompt))
    toks = rng.integers(0, 64, (2, 4)).astype(np.int32)
    past = np.minimum(14 + np.arange(4), 15)               # 14, 15, 15, 15
    if form == "broadcast":
        pos = past[None]                                    # [1, L]
    else:
        pos = np.stack([2 + np.arange(4), past])            # [B, L]
    pos = pos.astype(np.int32)
    jlogits, state = jmodel.apply(
        {"params": params, "cache": jcache}, jnp.asarray(toks), decode=True,
        positions=jnp.asarray(pos), mutable=["cache"])
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(toks), decode=True,
                         positions=torch.from_numpy(pos), cache=tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    want = interop.cache_from_flax(jax.device_get(state["cache"]))
    for got, ref in zip(tcache.k + tcache.v, want.k + want.v):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    # The past-the-end row's 4 new keys sit in the last 4 columns.
    k_new = tcache.k[0][-1, 12:]
    assert not torch.equal(k_new, torch.zeros_like(k_new))


@pytest.mark.parametrize("L,Lk,causal,window,edge", [
    (192, 64, True, 128, True),     # L == Lk + window: the last row
    (256, 64, True, 128, True),
    (192, 64, True, 64, True),
    (128, 64, True, 128, False),    # L < Lk + window
    (192, 64, False, 0, False),     # no window
    (192, 64, True, 0, False),
    (128, 128, True, 64, False),    # L == Lk: every row has a key
])
def test_window_edge_gate(L, Lk, causal, window, edge):
    assert tfa.window_edge(L, Lk, causal, window) is edge
    assert tfa.supported(L, Lk, 64)  # only the edge keeps B1 off


@pytest.mark.parametrize("L,window", [(192, 128), (256, 64)])
def test_window_edge_takes_the_plain_path_and_equals_jax(L, window,
                                                         monkeypatch):
    """At the edge the dispatcher never reaches the kernel path, and its
    plain answer (every row with no key averages V) equals JAX's
    dispatcher off the TPU (the XLA path) to 1e-5; one row short of the
    edge it takes the kernel path."""
    rng = np.random.default_rng(L)
    q = rng.standard_normal((1, L, 2, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 64, 2, 64)).astype(np.float32)
            for _ in range(2))
    calls = []
    real = tfa.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    got = tfa.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=window)
    assert calls == []
    want = jfa.attention(*map(jnp.asarray, (q, k, v)), causal=True,
                         window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tfa.attention(*map(torch.from_numpy, (q[:, :64], k, v)), causal=True,
                  window=window)
    assert len(calls) == 1


# --- the refusals, with JAX's messages --------------------------------------

GEN = dict(mode="generate", checkpoint_dir="/nonexistent", prompt="1,2")


@pytest.mark.parametrize("fields", [
    dict(resume=True),
    dict(mode="eval"),
    dict(mode="generate"),
    dict(mode="generate", checkpoint_dir="/nonexistent"),
    dict(GEN, num_beams=2, gen_temperature=1.0),
    dict(GEN, num_beams=2, gen_top_k=5),
    dict(GEN, num_beams=2, gen_top_p=0.9),
    dict(GEN, mesh_seq=2),
    dict(gen_temperature=-1.0),
    dict(max_new_tokens=0),
    dict(num_beams=0),
    dict(checkpoint_backend="bogus"),
])
def test_validation_refusals_carry_the_jax_message(fields):
    from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
    from tensorflow_distributed_tpu_torch.config import MeshConfig

    fields = dict(fields)
    seq = fields.pop("mesh_seq", 1)
    with pytest.raises(ValueError) as want:
        JaxConfig(model="gpt_lm", mesh=JaxMesh(seq=seq), **fields).validate()
    with pytest.raises(ValueError) as got:
        TrainConfig(model="gpt_lm", mesh=MeshConfig(seq=seq),
                    **fields).validate()
    assert str(got.value) == str(want.value)


def test_generate_needs_a_causal_lm():
    with pytest.raises(ValueError, match="mode=generate needs a causal LM "
                                         "with the decode cache"):
        TrainConfig(model="mnist_cnn", **GEN).validate()


@pytest.mark.parametrize("fields", [dict(checkpoint_backend="orbax"),
                                    dict(checkpoint_async=True)])
def test_orbax_and_async_saves_are_refused_naming_the_roadmap(fields):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(model="gpt_lm", **fields).validate()


def test_float32_is_allowed_on_a_gpu_for_generate_not_eval():
    TrainConfig(**dict(GEN, model="gpt_lm", compute_dtype="float32")
                ).validate()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        TrainConfig(model="gpt_lm", mode="eval", checkpoint_dir="/x",
                    compute_dtype="float32").validate()
