"""PyTorch port: a real two-replica fleet on the CPU (the port's
tests/test_fleet.py e2e, in the default tier).

A tiny GPT trained two steps is saved by the port's CLI (its checkpoint
is the JAX package's bytes). ``fleet.run.run_fleet`` starts two replica
processes of the port's ``--mode serve`` on it and serves ten requests
arriving 0.15 s apart, 32 new tokens each; one replica is SIGKILLed
while a request there is mid-decode (found through its journal, as
JAX's test finds it). Gates: none lost, none shed, every request done,
one death and one restart on a fresh epoch, at least one re-dispatch,
the restarted replica's snapshot on epoch 1, the lifecycle records in
the fleet JSONL, and every stream equal to JAX's greedy
``generate()`` on the JAX model restored from the same checkpoint. The
fleet's own deadline is 90 s.
"""

import json
import os
import threading
import time

import numpy as np

from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--model", "gpt_lm", "--model-size", "tiny", "--seq-len", "48",
          "--seed", "0", "--compute-dtype", "float32"]
NEW = 32


def _jax_streams(ckpt, prompts):
    """JAX's greedy generate() of each prompt on the JAX model restored
    from ``ckpt`` (its EMA where it tracks one, as serving takes it)."""
    import jax
    import jax.numpy as jnp

    from tensorflow_distributed_tpu.config import MeshConfig
    from tensorflow_distributed_tpu.config import parse_args as jparse
    from tensorflow_distributed_tpu.models.generate import generate
    from tensorflow_distributed_tpu.parallel.mesh import make_mesh
    from tensorflow_distributed_tpu.train import checkpoint as jckpt
    from tensorflow_distributed_tpu.train.loop import (
        _build_model_and_state, _GenTask)

    cfg = jparse(["--mode", "serve", *COMMON, "--checkpoint-dir", ckpt])
    mesh = make_mesh(MeshConfig(data=1), jax.devices()[:1])
    shim = _GenTask(vocab_size=64, sample_input=np.zeros((2, 48), np.int32))
    model, state = _build_model_and_state(cfg, mesh, shim)
    state = jckpt.restore(ckpt, state)
    params = state.params if state.ema is None else state.ema
    return {str(i): [int(t) for t in np.asarray(generate(
        model, params, jnp.asarray([p], jnp.int32), NEW))[0]]
        for i, p in enumerate(prompts)}


def test_fleet_e2e_sigkill_zero_lost(tmp_path):
    from tensorflow_distributed_tpu_torch import cli
    from tensorflow_distributed_tpu_torch.fleet.controller import (
        ControllerConfig)
    from tensorflow_distributed_tpu_torch.fleet.router import RouterConfig
    from tensorflow_distributed_tpu_torch.fleet.run import (
        load_workload, run_fleet)

    ckpt = str(tmp_path / "ckpt")
    assert cli.main([*COMMON, "--device", "cpu", "--dataset", "synthetic",
                     "--train-steps", "2", "--batch-size", "8",
                     "--eval-every", "0", "--log-every", "0",
                     "--checkpoint-dir", ckpt,
                     "--checkpoint-every", "2"]) == 0
    wl = tmp_path / "wl.jsonl"
    rng = np.random.default_rng(0)
    prompts = []
    with open(wl, "w") as f:
        for i in range(10):
            p = [int(t) for t in rng.integers(0, 64, int(rng.integers(4, 12)))]
            prompts.append(p)
            f.write(json.dumps({"prompt": p, "max_new_tokens": NEW,
                                "arrival_s": round(0.15 * i, 3)}) + "\n")
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="1")

    def arm_kill(ctl, router):
        def hunt():
            # Kill r1 while a request there is mid-decode with budget
            # left, so the death leaves in-flight work to re-dispatch.
            t_end = time.monotonic() + 30
            while time.monotonic() < t_end:
                h = ctl.members["r1"].handle
                jr = h.read_journal(epoch=h.epoch)
                if any(not e.get("done") and 1 <= len(e["tokens"]) <= 16
                       for e in jr.values()):
                    break
                time.sleep(0.005)
            ctl.kill("r1")
        threading.Thread(target=hunt, daemon=True).start()

    fleet_dir = tmp_path / "fleet"
    summary = run_fleet(
        fleet_dir=str(fleet_dir), replicas=2,
        base_args=["--mode", "serve", *COMMON, "--device", "cpu",
                   "--checkpoint-dir", ckpt, "--serve.num-slots", "2",
                   "--serve.buckets", "48"],
        workload=load_workload(str(wl)), ckpt_dir=ckpt, env=env,
        actions=[(0.2, arm_kill)],
        router_cfg=RouterConfig(dispatch_timeout_s=60.0),
        controller_cfg=ControllerConfig(backoff_base_s=0.25),
        timeout_s=90.0, jsonl=str(tmp_path / "fleet.jsonl"))
    assert not summary["timed_out"]
    assert summary["requests_lost"] == 0
    assert summary["requests_done"] == 10
    assert summary["requests_shed"] == 0
    assert summary["deaths"] == 1 and summary["restarts"] == 1
    assert summary["redispatches"] >= 1
    assert summary["drained_clean"]
    assert all(len(t) == NEW for t in summary["tokens"].values())
    # The restarted replica came back on a fresh epoch and exported there.
    snap = json.load(open(fleet_dir / "r1" / "e1" / "snapshot.json"))
    assert snap["ckpt_step"] == 2 and snap["seq"] >= 1
    recs = [json.loads(line) for line in open(tmp_path / "fleet.jsonl")]
    states = [(r["replica"], r["state"]) for r in recs
              if r["event"] == "fleet_replica"]
    assert ("r1", "exited") in states
    assert states.count(("r1", "spawned")) == 2
    assert summary["tokens"] == _jax_streams(ckpt, prompts)
