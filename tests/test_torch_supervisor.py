"""PyTorch port: the restart supervisor
(``python -m tensorflow_distributed_tpu_torch.resilience.supervisor``),
JAX's supervisor tests run against the port's CLI on the CPU.

- ``tests/test_resilience.py``'s four: a SIGKILLed train child restarts
  with ``--resume true`` and reaches its last step from the last durable
  save; a diverged child (exit 2) is not restarted; a child that always
  fails spends the budget; a missing ``--`` is a usage error.
- ``tests/test_serve_fire.py``'s ``build_leg_args`` (equal to JAX's for
  the same argv lists) and its serve SIGKILL leg: the restarted leg
  replays the journal and every request completes once; with
  ``--observe.metrics-jsonl`` the supervisor's restart record lands in
  that file between the two legs' records, as JAX's does.
- A tensor-parallel serve child (``--serve.mesh-model 2`` over gloo):
  SIGKILLed, restarted, its journal's streams the clean run's, and no
  worker process of the killed leg left alive.
- ``--elastic`` runs (``tests/test_torch_elastic*.py`` hold its planning
  and its restarts to JAX's).
"""

import json
import os
import re
import subprocess
import sys

import pytest

from tensorflow_distributed_tpu.resilience import supervisor as jsup
from tensorflow_distributed_tpu_torch.resilience import supervisor as tsup
from tensorflow_distributed_tpu_torch.serve import journal as journal_mod
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISOR = "tensorflow_distributed_tpu_torch.resilience.supervisor"
TRAIN = ["--device", "cpu", "--dataset", "synthetic", "--batch-size", "64",
         "--train-steps", "8", "--eval-every", "0", "--log-every", "1",
         "--eval-batch-size", "64", "--compute-dtype", "float32"]
SERVE = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
         "--seq-len", "48", "--compute-dtype", "float32", "--device", "cpu",
         "--serve.num-slots", "2", "--serve.num-requests", "6",
         "--serve.prompt-len-min", "4", "--serve.prompt-len-max", "10",
         "--serve.max-new-tokens", "16"]


def _run(args, module=SUPERVISOR, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO,
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 PYTHONUNBUFFERED="1"))


def _records(text: str):
    out = []
    for line in text.splitlines():
        line = line.removeprefix("[supervisor] ")
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def test_supervisor_restarts_sigkilled_child(tmp_path):
    """A train child SIGKILLed at step 5 (no notice, no drain) restarts
    with --resume true and resumes at the last durable save (step 4),
    running to step 8; the one restart record goes to standard
    output."""
    ck = str(tmp_path / "ckpt")
    proc = _run(["--max-restarts", "3", "--backoff-base-s", "0.2", "--",
                 *TRAIN,
                 "--checkpoint-dir", ck, "--checkpoint-every", "2",
                 "--resilience.fault-plan", "sigkill@5"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert '"kind": "restart"' in proc.stdout
    recs = _records(proc.stdout)
    restarts = [r for r in recs if r.get("kind") == "restart"]
    assert len(restarts) == 1
    assert restarts[0]["rc"] == -9 and restarts[0]["resume"] is True
    assert [r["step"] for r in recs if r.get("event") == "resumed"] == [4]
    assert "--resume true" in proc.stdout.split("[supervisor] leg 1:")[1]
    assert ckpt.latest_step(ck) == 8


def test_supervisor_does_not_restart_diverged_child(tmp_path):
    proc = _run(["--max-restarts", "3", "--backoff-base-s", "0.1", "--",
                 *TRAIN, "--checkpoint-dir", str(tmp_path / "ckpt"),
                 "--resilience.fault-plan", "nan_grad@3",
                 "--resilience.nonfinite", "halt"])
    assert proc.returncode == 2, proc.stdout[-2000:] + proc.stderr[-1000:]
    assert "not restarting" in proc.stdout
    assert '"kind": "restart"' not in proc.stdout


def test_supervisor_gives_up_after_budget():
    proc = _run(["--max-restarts", "1", "--backoff-base-s", "0.1", "--",
                 "--device", "cpu", "--dataset", "synthetic",
                 "--train-steps", "-1"])
    assert proc.returncode != 0
    assert "restart budget exhausted" in proc.stdout
    assert proc.stdout.count("[supervisor] leg ") == 2


def test_supervisor_usage_error():
    assert tsup.main([]) == 2


def test_elastic_is_refused_naming_a7():
    """``--elastic`` (once refused naming ROADMAP.md A7) runs: a CPU child
    with no mesh flag is probed (one CPU device undeclared), pinned to
    ``--mesh.data 1`` and run to its end, with no mesh change."""
    proc = _run(["--elastic", "--", *TRAIN])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-1000:]
    leg = proc.stdout.split("[supervisor] leg 0:")[1].splitlines()[0]
    assert leg.endswith("--mesh.data 1") and "torch.distributed.run" not in leg
    assert "mesh_change" not in proc.stdout
    assert "clean exit after 0 restart(s)" in proc.stdout


@pytest.mark.parametrize("args,restarts", [
    (["--checkpoint-dir", "/c", "--train-steps", "5"], 0),
    (["--checkpoint-dir", "/c", "--train-steps", "5"], 1),
    (["--checkpoint-dir", "/c", "--resume", "false"], 2),
    (["--checkpoint-dir=/c", "--resume=false"], 2),
    (["--train-steps", "5"], 3),
    (["--mode", "serve", "--model", "gpt_lm", "--serve.journal", "/tmp/j"],
     3),
    (["--mode", "serve", "--model", "gpt_lm", "--serve.journal", "/tmp/j",
      "--checkpoint-dir", "/c"], 3),
    (["--mode=serve", "--checkpoint-dir", "/c"], 1)])
def test_build_leg_args_equals_jax(args, restarts):
    assert tsup.build_leg_args(args, restarts) == jsup.build_leg_args(
        args, restarts)


def test_supervisor_serve_sigkill_journal_resume(tmp_path):
    """A serving child SIGKILLed at decode step 20 restarts with the same
    command; the restarted leg replays the journal and every request
    completes once, with all its tokens."""
    journal = str(tmp_path / "serve.journal")
    proc = _run(["--max-restarts", "2", "--backoff-base-s", "0.2", "--",
                 *SERVE, "--serve.journal", journal,
                 "--resilience.fault-plan", "sigkill@20"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert '"kind": "restart"' in proc.stdout
    assert "[serve] journal resume:" in proc.stdout
    played = journal_mod.replay(journal)
    assert len(played) == 6
    assert all(e["done"] and len(e["tokens"]) == 16
               for e in played.values())


def test_supervisor_appends_its_records_to_the_metrics_jsonl(tmp_path):
    """As JAX's: the restart record lands in the child's
    --observe.metrics-jsonl between the killed leg's records (the
    injected fault among them, through the active registry) and the
    resumed leg's, which appends (a journal resume) instead of
    truncating; it is printed on standard output too."""
    journal = str(tmp_path / "serve.journal")
    jsonl = str(tmp_path / "m.jsonl")
    proc = _run(["--max-restarts", "2", "--backoff-base-s", "0.2", "--",
                 *SERVE, "--serve.journal", journal,
                 "--observe.metrics-jsonl", jsonl,
                 "--resilience.fault-plan", "sigkill@20"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    recs = [json.loads(line) for line in open(jsonl)]
    kinds = [(r["event"], r.get("kind")) for r in recs]
    restart = kinds.index(("recovery", "restart"))
    assert ("recovery", "fault_injected") in kinds[:restart]
    assert ("serve_summary", None) in kinds[restart:]
    assert recs[restart]["leg"] == 1 and recs[restart]["resume"] is True
    assert any(r.get("kind") == "restart"
               for r in _records(proc.stdout))
    done = {r["rid"] for r in recs if r["event"] == "serve_request"}
    assert done == set(range(6))


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_tensor_parallel_serve_leg_restarts_with_no_worker_left(tmp_path):
    """--serve.mesh-model 2 over gloo: the SIGKILLed chief's worker dies
    with it (no process of the killed leg is left), the restarted leg
    starts its own, and the journal's streams equal a clean TP run's."""
    tp = SERVE + ["--serve.mesh-model", "2"]
    clean = str(tmp_path / "clean.journal")
    proc = _run([*tp, "--serve.journal", clean],
                module="tensorflow_distributed_tpu_torch.cli")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    journal = str(tmp_path / "tp.journal")
    proc = _run(["--max-restarts", "2", "--backoff-base-s", "0.2", "--",
                 *tp, "--serve.journal", journal,
                 "--resilience.fault-plan", "sigkill@20"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert '"kind": "restart"' in proc.stdout
    legs = proc.stdout.split("[supervisor] leg ")[1:]
    pids = [[int(p) for p in re.search(r"worker pids \[([0-9, ]*)\]",
                                       leg).group(1).split(",")]
            for leg in legs]
    assert len(pids) == 2 and len(pids[0]) == 1 and pids[0] != pids[1]
    assert not any(_alive(p) for p in pids[0] + pids[1])
    played = journal_mod.replay(journal)
    want = journal_mod.replay(clean)
    assert len(played) == 6 and all(e["done"] for e in played.values())
    assert ({r: e["tokens"] for r, e in played.items()}
            == {r: e["tokens"] for r, e in want.items()})
