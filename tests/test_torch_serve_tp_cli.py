"""PyTorch port: the serve flags across processes. The CLI at
``--serve.mesh-model 2`` over gloo (a chief and one spawned worker,
``serve/tp_replica.py``) against the same command in one process, for
each serve path that only a chief with workers runs: the paged cache in
sessions (radix hits, copy-on-write), the int8 cache, k-gram and draft
speculation (the replicated verify), the ``slot_nan`` poison and its
quarantine, a live ``reload`` (each worker restores and swaps its
slices), and a ``decode_stall`` past the watchdog (exit 3, the replica
stopped). The journal's streams and the summary's quarantine and swap
counts must be the one-process run's; no worker may outlive its chief.

Also the replica's own start and stop: a worker that raises ends the
chief (exit 1, not a hang), and ``--device cuda:K`` places the ranks on
``cuda:K..K+N-1``.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from tensorflow_distributed_tpu_torch.config import TrainConfig, parse_args
from tensorflow_distributed_tpu_torch.serve import journal as journal_mod
from tensorflow_distributed_tpu_torch.serve import run as trun
from tensorflow_distributed_tpu_torch.serve import tp_replica
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop

from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_LEN = 64
BASE = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
        "--seq-len", str(SEQ_LEN), "--compute-dtype", "float32",
        "--device", "cpu", "--serve.num-slots", "2",
        "--serve.num-requests", "6", "--serve.prompt-len-min", "4",
        "--serve.prompt-len-max", "10", "--serve.max-new-tokens", "12",
        "--serve.decode-priority", "2"]
CASES = {
    "paged_sessions": ["--serve.paged", "true", "--serve.page-size", "8",
                       "--serve.session-turns", "2"],
    "int8": ["--serve.kv-dtype", "int8"],
    "kgram": ["--serve.spec-tokens", "4"],
    "draft": ["--serve.spec-tokens", "4", "--serve.draft-config", "tiny"],
    "slot_nan": ["--resilience.fault-plan", "slot_nan@3:0"],
    "reload": ["--resilience.fault-plan", "reload@4"],
}
TIMEOUT_S = 300


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                PYTHONUNBUFFERED="1")


def _start(argv):
    return subprocess.Popen(
        [sys.executable, "-m", "tensorflow_distributed_tpu_torch.cli",
         *argv], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env())


def _pair(tmp_path, extra):
    """The command in one process and at --serve.mesh-model 2, run side
    by side, each with its own journal. Returns {name: (rc, stdout,
    stderr, journal)}."""
    procs = {}
    for name, flags in (("one", []), ("tp", ["--serve.mesh-model", "2"])):
        journal = str(tmp_path / f"{name}.jsonl")
        procs[name] = (_start(BASE + extra + flags
                              + ["--serve.journal", journal]), journal)
    out = {}
    for name, (proc, journal) in procs.items():
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        out[name] = (proc.returncode, stdout, stderr, journal)
    return out


def _summary(stdout):
    return json.loads(next(line for line in stdout.splitlines()
                           if '"serve_summary"' in line))


def _worker_pids(stdout):
    line = next(line for line in stdout.splitlines()
                if line.startswith("[serve] tensor-parallel replica:"))
    return [int(p) for p in re.search(r"worker pids \[([0-9, ]*)\]",
                                      line).group(1).split(",")]


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """A checkpoint of the tiny GPT's fresh-init weights (the reload
    case's source: its swap restores the newest step)."""
    d = str(tmp_path_factory.mktemp("ck"))
    cfg = TrainConfig(model="gpt_lm", model_size="tiny", seq_len=SEQ_LEN,
                      compute_dtype="float32", device="cpu")
    _, state = tloop._build_model_and_state(cfg, torch.device("cpu"))
    ckpt.save(d, state)
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_flag_across_processes_matches_one_process(
        case, tmp_path, checkpoint_dir):
    extra = list(CASES[case])
    if case == "reload":
        extra += ["--checkpoint-dir", checkpoint_dir]
    runs = _pair(tmp_path, extra)
    for name, (rc, stdout, stderr, _) in runs.items():
        assert rc == 0, f"{name}: {stdout[-2000:]}{stderr[-2000:]}"
    one, tp = _summary(runs["one"][1]), _summary(runs["tp"][1])
    streams = {name: {rid: e["tokens"] for rid, e in
                      journal_mod.replay(journal).items()}
               for name, (_, _, _, journal) in runs.items()}
    assert len(streams["one"]) == one["requests"]
    assert streams["tp"] == streams["one"]
    assert tp["tp_width"] == 2
    for key in ("retries", "swaps", "total_new_tokens", "verify_steps",
                "prefix_hits", "cow_copies"):
        assert tp.get(key) == one.get(key), key
    if case == "slot_nan":
        assert one["retries"] >= 1
    if case == "reload":
        assert one["swaps"] == 1
    if case in ("kgram", "draft"):
        assert one["verify_steps"] > 0
    if case == "paged_sessions":
        assert one["prefix_hits"] > 0
    assert set(tp["tp_start_s"]) == {"spawn_join", "build", "warmup"}
    stop = next(line for line in runs["tp"][1].splitlines()
                if line.startswith("[serve] tensor-parallel replica stopped"))
    assert set(json.loads(stop.split(": ", 1)[1])) == {
        "shutdown", "group_end", "workers"}
    assert not any(_alive(p) for p in _worker_pids(runs["tp"][1]))


def test_decode_stall_across_processes_exits_3_and_stops_the_workers(
        tmp_path):
    """A decode_stall past the watchdog: the chief raises StallError in
    its token fetch and exits 3 as one process does, and ``close`` stops
    the worker on the way out."""
    runs = _pair(tmp_path, ["--resilience.fault-plan", "decode_stall@3:3s",
                            "--resilience.sync-timeout-s", "0.5"])
    for name, (rc, stdout, stderr, _) in runs.items():
        assert rc == 3, f"{name}: {stdout[-2000:]}{stderr[-2000:]}"
    stdout = runs["tp"][1]
    assert "[serve] tensor-parallel replica stopped" in stdout
    assert not any(_alive(p) for p in _worker_pids(stdout))


FAILING_WORKER = textwrap.dedent("""
    import time

    import torch
    import torch.distributed as dist

    from tensorflow_distributed_tpu_torch.serve import tp_replica


    class Engine:
        def step(self):
            dist.all_reduce(torch.ones(1))

        def boom(self):
            raise RuntimeError("the worker's engine failed")


    def build(device, mesh):
        return Engine()


    if __name__ == "__main__":
        mesh, replica = tp_replica.start(2, torch.device("cpu"), build, ())
        print("started", replica.pids, flush=True)
        replica.send("step", ())
        Engine().step()
        replica.send("boom", ())
        # As a chief in an NCCL collective the dead worker never joins:
        # no return to check anything from.
        time.sleep(600)
        print("unreachable", flush=True)
""")


def test_a_failing_worker_ends_the_chief(tmp_path):
    """A worker that raises in a command prints its traceback and exits
    1; the chief, blocked in a collective the worker will never join,
    is ended by its watcher with exit 1 (a crash the supervisor
    restarts), not left hanging."""
    script = tmp_path / "replica.py"
    script.write_text(FAILING_WORKER)
    proc = subprocess.run([sys.executable, str(script)], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=_env())
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "started" in proc.stdout and "unreachable" not in proc.stdout
    assert "worker rank 1 failed in boom" in proc.stderr
    assert "the worker's engine failed" in proc.stderr
    assert re.search(r"worker pid \d+ exited with code 1 while serving",
                     proc.stderr)


def test_ranks_start_at_the_device_index(monkeypatch):
    """``--device cuda:K`` puts rank r on cuda:K+r; a replica that would
    run past the last card is refused before any process starts."""
    assert tp_replica.rank_device(torch.device("cuda"), 1) == (
        torch.device("cuda", 1))
    assert tp_replica.rank_device(torch.device("cuda", 2), 1) == (
        torch.device("cuda", 3))
    assert tp_replica.rank_device(torch.device("cpu"), 1) == (
        torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cfg = parse_args(BASE + ["--serve.mesh-model", "4"])
    model_cfg = tloop.build_model_for(cfg, "meta").cfg
    trun.check_tp_serving(cfg, model_cfg, torch.device("cuda", 4))
    with pytest.raises(ValueError, match=r"cuda:6\.\.cuda:9, have 8"):
        trun.check_tp_serving(cfg, model_cfg, torch.device("cuda", 6))
