"""PyTorch port: the serving path (``serve/``) against the JAX package.

- The bucket ladder equals JAX's on a grid of inputs, errors included.
- The FIFO scheduler makes JAX's decisions: both schedulers drive
  identical host-only fake engines (a copy of tests/test_serve.py's
  ``_FakeEngine``) on one fake clock, and their completions, ``on_token``
  streams and summary counts are equal across a sweep of slot counts,
  decode priorities, request counts, EOS ids and arrival offsets.
- The real engine (tiny GPT, f32, weights carried from JAX) under the
  scheduler is token-identical to the port's one-shot ``generate()``
  and to JAX's ``SlotDecodeEngine`` plus ``Scheduler``.
- ``cli.main(["--mode", "serve", "--device", "cpu", ...])`` draws JAX's
  synthetic workload exactly (SLO classes and tenants included) and
  serves JAX's token count; the speculation and SLO flags parse and are
  checked as JAX's; every serve flag of a layer not ported yet is
  refused, naming ROADMAP.md (the fire layers' parity is in
  tests/test_torch_serve_fire.py).
"""

import dataclasses
import json
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import parse_args as jax_parse_args
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.serve import buckets as jbuckets
from tensorflow_distributed_tpu.serve import run as jrun
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu.serve.engine import (
    SlotDecodeEngine as JaxEngine)
from tensorflow_distributed_tpu_torch import cli, interop
from tensorflow_distributed_tpu_torch.config import (
    ServeConfig, parse_args)
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.models.generate import generate
from tensorflow_distributed_tpu_torch.serve import buckets as tbuckets
from tensorflow_distributed_tpu_torch.serve import run as trun
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from torch_threads import _one_thread  # noqa: F401


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", ["32,64,128", "8", " 4, 16 ,", "", " , ",
                                  "a,b", "0,4", "16,8", "8,8", "1,2,3"])
def test_parse_buckets_equals_jax(spec):
    assert (_outcome(tbuckets.parse_buckets, spec)
            == _outcome(jbuckets.parse_buckets, spec))


@pytest.mark.parametrize("max_prompt", [0, 1, 16, 17, 100, 128, 129, 1000])
@pytest.mark.parametrize("min_bucket,cap", [(16, None), (16, 128), (1, 100),
                                            (0, None), (32, 32), (8, 1024)])
def test_default_buckets_equals_jax(max_prompt, min_bucket, cap):
    assert (_outcome(tbuckets.default_buckets, max_prompt, min_bucket, cap)
            == _outcome(jbuckets.default_buckets, max_prompt, min_bucket,
                        cap))


@pytest.mark.parametrize("plen", [1, 16, 17, 64, 65, 128, 129])
def test_pick_bucket_equals_jax(plen):
    ladder = (16, 64, 128)
    assert (_outcome(tbuckets.pick_bucket, plen, ladder)
            == _outcome(jbuckets.pick_bucket, plen, ladder))


# --- the FIFO scheduler against JAX's, on fake engines ------------------

class _Clock:
    """A fake clock: reads cost nothing; a decode step advances it by
    STEP_S, a prefill by PREFILL_S, and ``time.sleep`` by its argument
    (at least a nanosecond, so that a sleep rounded to nothing still
    moves time on, as a real one does)."""

    STEP_S, PREFILL_S = 0.01, 0.003

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += max(seconds, 1e-9)


class _FakeEngine:
    """tests/test_serve.py's host-only stand-in (token stream rid*100 +
    step; the rid rides the prompt's head), advancing a fake clock."""

    def __init__(self, clock, num_slots=2, max_len=256):
        self.clock = clock
        self.num_slots = num_slots
        self.max_len = max_len
        self.buckets = (32, 64)
        self.active = np.zeros((num_slots,), bool)
        self.slot_rid = {}
        self.counts = {}
        self.prefills = 0
        self.prefill_compiles = 0
        self.decode_steps = 0

    def fits(self, plen, max_new):
        return plen + max_new <= self.max_len

    def free_slots(self):
        return [s for s in range(self.num_slots) if not self.active[s]]

    def occupancy(self):
        return float(self.active.sum()) / self.num_slots

    def prefill(self, prompt, slot):
        rid = int(prompt[0])
        self.active[slot] = True
        self.slot_rid[slot] = rid
        self.counts[rid] = 0
        self.prefills += 1
        self.clock.t += self.clock.PREFILL_S
        return rid * 100

    def step(self):
        out = np.zeros((self.num_slots,), np.int32)
        for s in range(self.num_slots):
            if self.active[s]:
                rid = self.slot_rid[s]
                self.counts[rid] += 1
                out[s] = rid * 100 + self.counts[rid]
        self.decode_steps += 1
        self.clock.t += self.clock.STEP_S
        return out

    def free(self, slot):
        self.active[slot] = False


def _drive(module, case, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "sleep", clock.sleep)
    eng = _FakeEngine(clock, num_slots=case["slots"])
    reqs = [module.Request(rid=i, prompt=np.asarray([i], np.int32),
                           max_new_tokens=case["max_new"][i],
                           eos_id=case["eos"].get(i, -1),
                           arrival_s=case["arrivals"][i])
            for i in range(case["n"])]
    seen = []
    sched = module.Scheduler(eng, decode_priority=case["dp"], clock=clock,
                             on_token=lambda *a: seen.append(a))
    done = sched.run(reqs)
    return done, seen, sched.summary, eng


def _case(n, slots, dp, max_new=6, eos=None, arrivals=None):
    max_new = max_new if isinstance(max_new, list) else [max_new] * n
    return dict(n=n, slots=slots, dp=dp, max_new=max_new, eos=eos or {},
                arrivals=arrivals or [0.0] * n)


SWEEP = [
    _case(1, 1, 1),
    _case(5, 2, 3),
    _case(7, 2, 3, max_new=9),
    _case(9, 3, 1, max_new=[1, 5, 9, 2, 7, 3, 1, 8, 4]),
    _case(9, 3, 8, eos={0: 2, 3: 300, 5: 504, 8: 99}),
    _case(6, 4, 2, arrivals=[0.0, 0.0, 0.035, 0.035, 0.2, 0.21]),
    _case(5, 1, 4, max_new=[3, 1, 6, 2, 4],
          arrivals=[0.0, 0.5, 0.05, 0.051, 1.3]),
    _case(8, 2, 8, max_new=[12, 3, 3, 3, 12, 2, 2, 6], eos={6: 601},
          arrivals=[0.0, 0.0, 0.02, 0.04, 0.06, 0.08, 0.4, 0.4]),
]


@pytest.mark.parametrize("case", SWEEP, ids=range(len(SWEEP)))
def test_fifo_scheduler_makes_jax_decisions(case, monkeypatch):
    tdone, tseen, tsum, teng = _drive(tsched, case, monkeypatch)
    jdone, jseen, jsum, jeng = _drive(jsched, case, monkeypatch)

    def key(c):
        return (c.rid, list(c.tokens), c.finish, c.queue_steps,
                c.prompt_len)

    assert [key(c) for c in tdone] == [key(c) for c in jdone]
    for t, j in zip(tdone, jdone):
        assert (t.ttft_s, t.decode_s) == pytest.approx((j.ttft_s, j.decode_s))
    assert tseen == jseen
    ints = [k for k, v in tsum.items() if isinstance(v, int)
            and not isinstance(v, bool)]
    assert {"requests", "total_new_tokens", "decoded_tokens",
            "decode_steps", "prefills", "prefill_compiles",
            "num_slots"} <= set(ints)
    assert {k: tsum[k] for k in ints} == {k: jsum[k] for k in ints}
    assert tsum["mean_slot_occupancy"] == jsum["mean_slot_occupancy"]
    assert teng.decode_steps == jeng.decode_steps
    assert max(c.queue_steps for c in tdone) <= case["dp"]


def test_scheduler_refusals():
    eng = _FakeEngine(_Clock())
    # The autopilot is not ported (ROADMAP.md A8); the serve observatory
    # and the fleet intake are (tests/test_torch_serve_observe.py).
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8"):
        tsched.Scheduler(eng, autopilot=object())
    tsched.Scheduler(eng, feed=object(), export_every=1.0, tracer=object(),
                     anomaly_hub=object(), registry=object())
    with pytest.raises(ValueError, match="export_every"):
        tsched.Scheduler(eng, export_every=-1.0)
    # The fire layers are ported (tests/test_torch_serve_fire.py).
    tsched.Scheduler(eng, journal=object(), fault_plan=object(),
                     slot_retries=0, reload_fn=object())
    with pytest.raises(ValueError, match="slot_retries"):
        tsched.Scheduler(eng, slot_retries=-1)
    with pytest.raises(ValueError, match="unknown policy"):
        tsched.Scheduler(eng, policy="lifo")
    with pytest.raises(ValueError, match="tenant_quota"):
        tsched.Scheduler(eng, policy="slo", tenant_quota=-1)
    with pytest.raises(ValueError, match="decode_priority"):
        tsched.Scheduler(eng, decode_priority=0)
    with pytest.raises(ValueError, match="does not fit"):
        tsched.Scheduler(_FakeEngine(_Clock(), max_len=16)).run(
            [tsched.Request(rid=0, prompt=np.zeros(10, np.int32),
                            max_new_tokens=10)])


# --- the real engine, tiny GPT ----------------------------------------

def _tiny_pair():
    jmodel = jtr.CausalLM(jtr.tiny_config(causal=True,
                                          compute_dtype=jnp.float32))
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def test_engine_and_scheduler_are_token_identical_to_generate_and_jax():
    """Six mixed-length requests through three slots (reused): every
    stream equals the port's one-shot greedy ``generate()`` and JAX's
    engine under JAX's scheduler; the prefill shapes stay within the
    ladder and the starvation bound holds."""
    jmodel, params, tmodel = _tiny_pair()
    rng = np.random.default_rng(0)
    lens = [3, 9, 17, 30, 5, 12]
    prompts = [rng.integers(0, 64, size=n).astype(np.int32) for n in lens]

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
        ref = generate(tmodel, torch.from_numpy(p)[None].long(), 10)[0]
        assert tdone[i].tokens == ref.tolist(), f"request {i} vs generate()"
        assert tdone[i].tokens == jdone[i].tokens, f"request {i} vs JAX"
        assert tdone[i].queue_steps == jdone[i].queue_steps
    assert engine.prefills == 6 and engine.num_slots == 3
    assert engine.buckets == jeng.buckets
    assert engine.prefill_compiles == jeng.prefill_compiles
    assert engine.prefill_compiles <= len(engine.buckets)
    assert max(c.queue_steps for c in tdone.values()) <= 3
    assert engine.cache_bytes_per_slot() == jeng.cache_bytes_per_slot()


def test_engine_surface_and_refusals():
    _, _, model = _tiny_pair()
    eng = SlotDecodeEngine(model, num_slots=2, buckets=(8, 32))
    assert eng.fits(32, 96) and not eng.fits(33, 1) and not eng.fits(8, 121)
    assert eng.free_slots() == [0, 1] and eng.occupancy() == 0.0
    first = eng.prefill(np.arange(5), 1)
    assert eng.free_slots() == [0] and eng.occupancy() == 0.5
    assert eng.pos[1] == 5 and eng.tok[1] == first
    with pytest.raises(ValueError, match="occupied"):
        eng.prefill(np.arange(3), 1)
    nxt = eng.step()
    assert eng.pos[1] == 6 and eng.tok[1] == nxt[1]
    eng.free(1)
    assert eng.free_slots() == [0, 1]
    with pytest.raises(ValueError, match="max_len"):
        SlotDecodeEngine(model, num_slots=1, buckets=(8, 256))
    with pytest.raises(ValueError, match="spec_tokens"):
        SlotDecodeEngine(model, num_slots=1, spec_tokens=-1)
    # The fault plan and the watchdog are the engine's (the fire drills'
    # parity is in tests/test_torch_serve_fire.py).
    plan, dog = object(), object()
    armed = SlotDecodeEngine(model, num_slots=1, fault_plan=plan,
                             watchdog=dog)
    assert armed.fault_plan is plan and armed.watchdog is dog
    # Without spec_tokens there is no verify, as in JAX.
    assert not eng.can_verify() and eng.verify_fallback_slots() is None
    with pytest.raises(RuntimeError, match="spec_tokens > 0"):
        eng.verify_step(np.zeros((2, 1)))
    spec = SlotDecodeEngine(model, num_slots=2, buckets=(8, 32),
                            spec_tokens=2)
    assert spec.can_verify() and spec.verify_fallback_slots() == []
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spec.set_spec_k(3)
    with pytest.raises(ValueError, match="out of range"):
        eng.poison_slot(2)
    with pytest.raises(ValueError, match="tree structure"):
        eng.swap_params({})


# --- --mode serve through the CLI -------------------------------------

SERVE_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
              "--compute-dtype", "float32", "--serve.num-slots", "3",
              "--serve.num-requests", "6", "--serve.prompt-len-min", "4",
              "--serve.prompt-len-max", "20", "--serve.max-new-tokens", "8"]


@pytest.mark.parametrize("extra", [
    [], ["--serve.arrival-rate", "40"],
    ["--serve.trace", "poisson", "--serve.arrival-rate", "40"],
    ["--serve.trace", "bursty", "--serve.arrival-rate", "40"],
    ["--serve.trace", "diurnal", "--serve.arrival-rate", "40",
     "--seed", "3", "--synthetic-vocab", "500"],
    "trace_file", "request_file",
    ["--serve.session-turns", "3", "--serve.num-requests", "8"],
    ["--serve.session-turns", "2", "--serve.trace", "bursty",
     "--serve.arrival-rate", "40"],
    ["--serve.policy", "slo", "--serve.slo-mix", "high:0.25,batch:0.25",
     "--serve.tenants", "2"],
    ["--serve.policy", "slo", "--serve.slo-mix", "high:0.5",
     "--serve.tenants", "3", "--serve.trace", "poisson",
     "--serve.arrival-rate", "40", "--seed", "5",
     "--serve.num-requests", "9"],
    ["--serve.spec-tokens", "4", "--serve.tenants", "4"]])
def test_workload_equals_jax(extra, tmp_path):
    if extra == "trace_file":
        path = tmp_path / "t.jsonl"
        path.write_text("".join(json.dumps({"arrival_s": 0.1 * i}) + "\n"
                                for i in range(7)))
        extra = ["--serve.trace", str(path)]
    elif extra == "request_file":
        path = tmp_path / "r.jsonl"
        path.write_text("\n".join([
            json.dumps({"prompt": [5, 11, 3], "max_new_tokens": 12}),
            json.dumps({"prompt": [1, 2], "arrival_s": 0.05, "eos_id": 7}),
            "", json.dumps({"prompt": [9], "slo": "standard"}),
            json.dumps({"prompt": [9, 4], "session": "conv1"}),
            json.dumps({"prompt": [3], "slo": "high", "tenant": "acme"}),
            json.dumps({"prompt": [6, 6], "slo": "batch"})]) + "\n")
        extra = ["--serve.requests", str(path)]
    argv = SERVE_ARGV + extra
    tcfg, jcfg = parse_args(argv + ["--device", "cpu"]), jax_parse_args(argv)
    vocab = tcfg.synthetic_vocab or 64
    got, want = trun._workload(tcfg, vocab), jrun._workload(jcfg, vocab)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert (g.rid, g.max_new_tokens, g.eos_id, g.arrival_s, g.session,
                g.slo, g.tenant) == (w.rid, w.max_new_tokens, w.eos_id,
                                     w.arrival_s, w.session, w.slo, w.tenant)
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.prompt.dtype == w.prompt.dtype


def test_cli_serves_jax_token_count_with_the_summary_keys(capsys):
    assert cli.main(SERVE_ARGV + ["--device", "cpu", "--serve.stream",
                                  "true"]) == 0
    out = capsys.readouterr().out.splitlines()
    summary = json.loads(next(l for l in out if '"serve_summary"' in l))
    line = next(l for l in out if l.startswith("[serve] 6 requests"))
    assert "fresh-init params" in line and "prefill programs" in line
    streamed = [l for l in out if l.startswith("[serve] rid=")]
    assert len(streamed) == 6 * 8
    assert sum(l.endswith("<done>") for l in streamed) == 6

    want = jrun.serve_run(jax_parse_args(SERVE_ARGV))
    for key in ("requests", "total_new_tokens", "decoded_tokens",
                "decode_steps", "prefills", "prefill_compiles", "buckets",
                "num_slots", "decode_priority", "policy", "params"):
        assert summary[key] == want[key], key
    assert summary["total_new_tokens"] == 6 * 8
    for key in ("wall_s", "tokens_per_sec", "mean_slot_occupancy",
                "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99", "tok_ms_mean"):
        assert summary[key] > 0, key


@pytest.mark.parametrize("extra", [
    [], ["--serve.spec-tokens", "4"], ["--serve.policy", "slo"],
    ["--serve.spec-tokens", "3", "--serve.policy", "slo", "--serve.slo-mix",
     "high:0.25,batch:0.25", "--serve.tenants", "2", "--serve.paged",
     "true", "--serve.page-size", "8"]])
def test_serve_sizes_the_cache_like_jax(extra, tmp_path):
    """Without --seq-len the cache is sized as JAX's serve_run sizes it:
    the workload (prompt + new tokens) plus spec_tokens of verify
    headroom, at least 32, paged rounded up to a page; the ladder covers
    the longest prompt, or under policy slo prompt + new tokens (a
    preemption's continuation). A --seq-len that cannot hold the
    workload, and a prompt id outside the model's vocabulary, are
    refused."""
    cfg, engine, requests = trun.serve_setup(parse_args(
        SERVE_ARGV + extra + ["--device", "cpu"]))
    need = max(len(r.prompt) + r.max_new_tokens for r in requests)
    want = max(need + cfg.serve.spec_tokens, 32)
    if cfg.serve.paged:
        want = -(-want // cfg.serve.page_size) * cfg.serve.page_size
    assert cfg.seq_len == engine.max_len == want
    assert engine.spec_tokens == cfg.serve.spec_tokens
    cover = (need if cfg.serve.policy == "slo"
             else max(len(r.prompt) for r in requests))
    assert engine.buckets == jbuckets.default_buckets(cover, cap=cfg.seq_len)
    with pytest.raises(ValueError, match="cannot hold"):
        trun.serve_setup(parse_args(SERVE_ARGV + ["--device", "cpu",
                                                  "--seq-len", "16"]))
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps({"prompt": [3, 64]}) + "\n")
    with pytest.raises(ValueError, match="outside the model vocabulary"):
        trun.serve_setup(parse_args(SERVE_ARGV + [
            "--device", "cpu", "--serve.requests", str(path)]))


@pytest.mark.parametrize("name", ["inbox"])
def test_unported_serve_flags_are_refused(name):
    """The fleet intake, the last serve flag to be ported, parses as JAX
    parses it: refused with JAX's message without its journal, under
    another mode or without an explicit --seq-len, taken with them."""
    from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
    from tensorflow_distributed_tpu_torch.config import TrainConfig

    flag = f"--serve.{name.replace('_', '-')}"
    parse_args(SERVE_ARGV + [flag, ""])
    argv = SERVE_ARGV + ["--seq-len", "64", flag, "x.jsonl"]
    with pytest.raises(ValueError, match="needs --serve.journal"):
        parse_args(argv)
    argv += ["--serve.journal", "j.jsonl"]
    tcfg, jcfg = parse_args(argv), jax_parse_args(argv)
    assert getattr(tcfg.serve, name) == getattr(jcfg.serve, name)
    for cfg_cls in (TrainConfig, JaxConfig):
        with pytest.raises(ValueError, match="mode=serve fleet-replica"):
            cfg = cfg_cls()
            cfg.serve.inbox = "x.jsonl"
            cfg.validate()


@pytest.mark.parametrize("argv,error", [
    # A fleet replica over a multi-process mesh (ROADMAP.md A6).
    (["--serve.inbox", "inbox.jsonl", "--serve.journal", "j.jsonl",
      "--seq-len", "64", "--mesh.data", "2"], NotImplementedError),
    (["--checkpoint-backend", "orbax"], NotImplementedError),
    (["--checkpoint-async", "true"], NotImplementedError),
    (["--model", "mnist_cnn"], ValueError),
    (["--mesh.seq", "2"], NotImplementedError),
    (["--serve.trace", "poisson"], ValueError),
    (["--serve.buckets", "8,4"], ValueError),
    (["--serve.num-slots", "0"], ValueError),
])
def test_serve_config_refusals(argv, error):
    with pytest.raises(error):
        parse_args(SERVE_ARGV + argv)


def test_float32_is_allowed_on_a_gpu_only_for_serving():
    assert parse_args(SERVE_ARGV).compute_dtype == "float32"
    with pytest.raises(NotImplementedError, match="bfloat16"):
        parse_args(["--model", "gpt_lm", "--compute-dtype", "float32"])


def test_serve_config_has_the_jax_fields_and_defaults():
    from tensorflow_distributed_tpu.config import ServeConfig as JaxServe

    port, ref = ServeConfig(), JaxServe()
    assert ({f.name for f in dataclasses.fields(port)}
            == {f.name for f in dataclasses.fields(ref)})
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("line", [{"text": "hello"}])
def test_request_file_fields_of_unported_layers_are_refused(line, tmp_path):
    """A ``text`` prompt without ``--dataset text`` (no tokenizer) gets
    the JAX ``_workload``'s ValueError, word for word."""
    from tensorflow_distributed_tpu.config import parse_args as jax_parse
    from tensorflow_distributed_tpu.serve import run as jrun

    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps(line) + "\n")
    argv = SERVE_ARGV + ["--serve.requests", str(path)]
    with pytest.raises(ValueError) as want:
        jrun._workload(jax_parse(argv), 64)
    with pytest.raises(ValueError) as got:
        trun._workload(parse_args(argv), 64)
    assert str(got.value) == str(want.value)
    assert "string prompts need --dataset text" in str(got.value)


@pytest.mark.parametrize("line", [
    {"prompt": [1], "slo": "high"}, {"prompt": [1], "tenant": "t0"},
    {"prompt": [1], "session": "s0", "tenant": "t1"},
    {"prompt": [1, 2], "slo": "batch", "tenant": 7},
    {"prompt": [1], "slo": "gold"}])
def test_request_file_slo_and_tenant_are_read_as_jax(line, tmp_path):
    """The request file's ``slo`` (checked against the classes, with
    JAX's message) and ``tenant`` keys are read as JAX's ``_workload``
    reads them."""
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps(line) + "\n")
    argv = SERVE_ARGV + ["--serve.requests", str(path)]
    got = _outcome(trun._workload, parse_args(argv), 64)
    want = _outcome(jrun._workload, jax_parse_args(argv), 64)
    if want[0] == "ValueError":
        assert got == want
        return
    (g,), (w,) = got[1], want[1]
    assert (g.slo, g.tenant, g.session) == (w.slo, w.tenant, w.session)
    np.testing.assert_array_equal(g.prompt, w.prompt)


# --- the speculation and SLO flags through --mode serve -----------------

SPEC_SLO_VALUES = {"spec_tokens": ["4"], "draft_config": ["tiny"],
                   "spec_kgram": ["2"], "tenant_quota": ["64"],
                   "preempt": ["false"], "slo_mix": ["high:0.25,batch:0.25"],
                   "tenants": ["3"]}
# The flags each knob needs beside it to pass JAX's checks.
SPEC_SLO_WITH = {"draft_config": ["--serve.spec-tokens", "2"],
                 "spec_kgram": ["--serve.spec-tokens", "2"],
                 "tenant_quota": ["--serve.policy", "slo", "--serve.tenants",
                                  "2"],
                 "preempt": ["--serve.policy", "slo"],
                 "slo_mix": ["--serve.policy", "slo"]}


@pytest.mark.parametrize("name", sorted(SPEC_SLO_VALUES))
def test_spec_and_slo_flags_parse_as_jax(name):
    """Each knob of speculation and the SLO scheduler parses with a value
    off its default into the field JAX parses it into (and no longer
    names ROADMAP.md)."""
    flag = f"--serve.{name.replace('_', '-')}"
    argv = SERVE_ARGV + [flag] + SPEC_SLO_VALUES[name] + SPEC_SLO_WITH.get(
        name, [])
    tcfg, jcfg = parse_args(argv), jax_parse_args(argv)
    assert getattr(tcfg.serve, name) == getattr(jcfg.serve, name)
    assert getattr(tcfg.serve, name) != getattr(ServeConfig(), name)


def _serve_check(module_config, **kw):
    cfg = module_config.TrainConfig(mode="serve", model="gpt_lm")
    for k, v in kw.items():
        setattr(cfg.serve, k, v)
    try:
        cfg.validate()
        return ("ok",)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", [
    dict(spec_tokens=-1), dict(draft_config="tiny"),
    dict(spec_tokens=2, spec_kgram=0), dict(kv_dtype="fp8"),
    dict(policy="edf"), dict(tenant_quota=-1), dict(tenant_quota=5),
    dict(policy="slo", tenant_quota=5), dict(slo_mix="high:0.5"),
    dict(policy="slo", slo_mix="gold:0.5"),
    dict(policy="slo", slo_mix="high:0.5", requests="r.jsonl"),
    dict(tenants=0), dict(policy="slo", slo_mix="high=0.5"),
    dict(policy="slo", slo_mix="high:0.8,batch:0.4"),
    dict(spec_tokens=4), dict(spec_tokens=4, draft_config="tiny"),
    dict(policy="slo", tenant_quota=64, tenants=2, slo_mix="high:0.25"),
    dict(policy="slo", tenant_quota=64, requests="r.jsonl")])
def test_serve_config_new_knobs_check_as_jax(kw):
    """tests/test_serve_slo.py's knob cases (rejections and valid sets)
    against both configs: the same outcome, exception type and message."""
    from tensorflow_distributed_tpu import config as jconfig
    from tensorflow_distributed_tpu_torch import config as tconfig

    assert _serve_check(tconfig, **kw) == _serve_check(jconfig, **kw)


# --- the int8 and paged caches through --mode serve --------------------

PAGED_VALUES = {"kv_dtype": "int8", "paged": "true", "page_size": "8",
                "num_pages": "64", "radix": "false", "session_turns": "2",
                "hbm_budget_gb": "0.5"}


@pytest.mark.parametrize("name", sorted(PAGED_VALUES))
def test_paging_flags_parse_as_jax(name):
    """Each flag of the int8 and paged caches parses with a value off its
    default (with --serve.paged where JAX needs it) into the field JAX
    parses it into."""
    flag = f"--serve.{name.replace('_', '-')}"
    argv = SERVE_ARGV + [flag, PAGED_VALUES[name]]
    if name not in ("kv_dtype", "paged", "session_turns"):
        argv += ["--serve.paged", "true"]
    tcfg, jcfg = parse_args(argv), jax_parse_args(argv)
    assert getattr(tcfg.serve, name) == getattr(jcfg.serve, name)
    assert getattr(tcfg.serve, name) != getattr(ServeConfig(), name)


def test_paged_serve_rounds_the_cache_up_to_a_page():
    cfg, engine, requests = trun.serve_setup(parse_args(
        SERVE_ARGV + ["--device", "cpu", "--serve.paged", "true",
                      "--serve.page-size", "24", "--serve.num-pages", "40"]))
    need = max(len(r.prompt) + r.max_new_tokens for r in requests)
    assert cfg.seq_len % 24 == 0 and cfg.seq_len >= max(need, 32)
    assert cfg.seq_len - 24 < max(need, 32)
    assert engine.paged and engine.pool.num_pages == 40
    with pytest.raises(ValueError, match="must divide"):
        trun.serve_setup(parse_args(SERVE_ARGV + [
            "--device", "cpu", "--serve.paged", "true", "--seq-len", "100"]))
