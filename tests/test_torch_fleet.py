"""PyTorch port: the fleet's host policy against the JAX package's.

Every scenario of tests/test_fleet.py's router, replica and controller
tiers (failover token identity, quarantine and rejoin on an anomaly or a
stale snapshot, the cooldown, retry budgets and timeouts with capped
backoff, lowest-class shedding, journal rejects, session stickiness, the
inbox feed's torn tail, the handle's epochs and incremental journal
tail, restart backoff and epoch rotation, divergence, drain before stop
and its escalation, the checkpoint scan, rolling and partial swaps) runs
twice through ``torch_parity.run``: over the JAX package's ``Router``,
``RouterConfig``, ``FleetController``, ``ControllerConfig``,
``InboxFeed``, ``ReplicaHandle``, ``append_line`` and
``latest_ckpt_step``, then over the port's, on tests/test_fleet.py's own
``FakeReplica``/``FakeProc`` and hand-advanced clocks. The JAX test's
assertions hold the port, and the two records (every public call's
result: dispatch decisions, emitted ``fleet_*`` records, summaries,
polled items, snapshots, journals, and the files left behind) are equal.
The report folding (``observe/report.py``) and the slow end-to-end run
are not here: the first waits for the port's report (ROADMAP.md A8), the
second is tests/test_torch_fleet_e2e.py.
"""

import subprocess
import sys

import pytest

import test_fleet as jf
import torch_parity
from tensorflow_distributed_tpu.fleet import controller as jctl
from tensorflow_distributed_tpu.fleet import replica as jrep
from tensorflow_distributed_tpu.fleet import router as jrt
from tensorflow_distributed_tpu_torch.fleet import controller as tctl
from tensorflow_distributed_tpu_torch.fleet import replica as trep
from tensorflow_distributed_tpu_torch.fleet import router as trt
from torch_threads import _one_thread  # noqa: F401

ROUTER_SCENARIOS = (
    "test_slo_class_parity_with_scheduler",
    "test_dispatch_least_loaded",
    "test_dispatch_class_p95_tiebreak",
    "test_failover_redispatch_token_identity",
    "test_quarantine_on_anomaly_evacuates_and_rejoins",
    "test_anomaly_cooldown_rejoin_does_not_oscillate",
    "test_quarantine_on_stale_snapshot_and_rejoin",
    "test_retry_budget_exhaustion_sheds_loudly",
    "test_saturation_shed_order_lowest_class_first",
    "test_dispatch_timeout_retries_with_capped_backoff",
    "test_reject_in_journal_sheds",
    "test_summary_shape_and_recovery_population",
    "test_session_turns_stick_to_one_replica_and_repin_on_death",
)
REPLICA_SCENARIOS = (
    "test_inbox_feed_requests_commands_and_torn_tail",
    "test_replica_handle_incremental_journal_tail",
    "test_replica_handle_epochs_and_tolerant_readers",
)
CONTROLLER_SCENARIOS = (
    "test_controller_restart_backoff_and_epoch_rotation",
    "test_controller_diverged_not_restarted",
    "test_controller_drain_before_stop",
    "test_controller_drain_escalates_on_deadline",
    "test_latest_ckpt_step_scanner_matches_checkpoint_layer",
    "test_controller_rolling_swap_one_replica_at_a_time",
    "test_controller_swap_timeout_is_a_partial_roll",
)


def _targets(rt, rep, ctl):
    """tests/test_fleet.py's module-level names, bound to one package."""
    return {(jf, "Router"): rt.Router, (jf, "RouterConfig"): rt.RouterConfig,
            (jf, "SLO_CLASSES"): rt.SLO_CLASSES,
            (jf, "InboxFeed"): rep.InboxFeed,
            (jf, "ReplicaHandle"): rep.ReplicaHandle,
            (jf, "append_line"): rep.append_line,
            (jf, "FleetController"): ctl.FleetController,
            (jf, "ControllerConfig"): ctl.ControllerConfig,
            (jf, "latest_ckpt_step"): ctl.latest_ckpt_step}


# lag_stats reads the wall clock (the router's enqueue stamp to now).
SKIP = ("lag_stats", "snapshot_mtime")


def _both(name, tmp_path):
    fn = getattr(jf, name)
    jax = torch_parity.run(fn, _targets(jrt, jrep, jctl), tmp_path / "jax",
                           skip=SKIP)
    port = torch_parity.run(fn, _targets(trt, trep, tctl),
                            tmp_path / "port", skip=SKIP)
    return jax, port


@pytest.mark.parametrize("name", ROUTER_SCENARIOS + REPLICA_SCENARIOS
                         + CONTROLLER_SCENARIOS)
def test_fleet_scenario_equals_jax(name, tmp_path):
    (jcalls, jfiles), (tcalls, tfiles) = _both(name, tmp_path)
    # The class tuple's check compares values, not calls.
    assert jcalls or name == "test_slo_class_parity_with_scheduler"
    assert len(tcalls) == len(jcalls)
    for i, (j, t) in enumerate(zip(jcalls, tcalls)):
        assert t == j, f"call {i}: {j[0]}.{j[1]}"
    assert tfiles == jfiles


def test_router_classes_are_the_port_scheduler_classes():
    from tensorflow_distributed_tpu_torch.serve import scheduler as tsched

    assert trt.SLO_CLASSES == tsched.SLO_CLASSES == jrt.SLO_CLASSES


def test_controller_spawns_the_port_cli_with_the_fleet_wiring(tmp_path):
    """A replica's argv: the port's CLI, the supervisor's leg args, then
    JAX's per-epoch wiring (inbox, journal, snapshot at the export
    cadence, metrics), each flag through ``child_flag``; a restart rolls
    the epoch directory."""
    cmds = []
    handles = [trep.ReplicaHandle("r0", str(tmp_path / "r0"))]

    class Proc(jf.FakeProc):
        pass

    def spawn(cmd):
        cmds.append(cmd)
        return Proc()

    ctl = tctl.FleetController(handles, ["--mode", "serve"], spawn=spawn,
                               cfg=tctl.ControllerConfig(backoff_base_s=0.1))
    ctl.start(0.0)
    assert cmds[0][:3] == [sys.executable, "-m",
                           "tensorflow_distributed_tpu_torch.cli"]
    e0 = str(tmp_path / "r0" / "e0")
    assert cmds[0][3:] == [
        "--mode", "serve", "--serve.inbox", f"{e0}/inbox.jsonl",
        "--serve.journal", f"{e0}/journal.jsonl",
        "--observe.export-path", f"{e0}/snapshot.json",
        "--observe.export-every", "0.2",
        "--observe.metrics-jsonl", f"{e0}/metrics.jsonl"]
    ctl.members["r0"].proc.rc = -9
    ctl.poll(1.0)
    ctl.poll(1.2)
    assert len(cmds) == 2 and f"{tmp_path}/r0/e1/inbox.jsonl" in cmds[1]
    from tensorflow_distributed_tpu_torch.config import parse_args

    cfg = parse_args(cmds[1][3:] + ["--model", "gpt_lm", "--seq-len", "64",
                                    "--device", "cpu"])
    assert cfg.serve.inbox.endswith("e1/inbox.jsonl")
    assert cfg.observe.export_every == 0.2


def test_latest_ckpt_step_matches_the_port_checkpoint_layer(tmp_path):
    from tensorflow_distributed_tpu_torch.train.checkpoint import (
        available_steps)

    ckpt = str(tmp_path / "ckpt")
    for step, marker in ((2, "state.msgpack"), (6, "ORBAX_COMMITTED"),
                         (8, "unrelated.file")):
        jf._mk_step(ckpt, step, marker)
    assert tctl.latest_ckpt_step(ckpt) == 6
    assert max(available_steps(ckpt)) <= 6


def test_fleet_obs_config_matches_jax_and_refuses_the_trace():
    from tensorflow_distributed_tpu.fleet.run import FleetObsConfig as JObs
    from tensorflow_distributed_tpu_torch.fleet.run import (
        FleetObsConfig as TObs)

    def outcome(cls, **kw):
        try:
            cls(**kw).validate()
            return "ok"
        except ValueError as e:
            return str(e)

    for kw in (dict(), dict(slo="high:ttft_p95=100ms"), dict(slo="bad"),
               dict(slo_windows="5,2"), dict(slo_burn=0),
               dict(slo_windows="10,20"), dict(export_every=-1),
               dict(export_every=1.0), dict(export_path="x.json",
                                            export_every=0.5)):
        assert outcome(TObs, **kw) == outcome(JObs, **kw), kw
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8"):
        TObs(trace=True).validate()


def test_fleet_run_help_and_refusals_on_the_cpu(tmp_path):
    mod = "tensorflow_distributed_tpu_torch.fleet.run"
    out = subprocess.run([sys.executable, "-m", mod, "--help"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "--fleet-dir" in out.stdout
    out = subprocess.run([sys.executable, "-m", mod], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 2 and "usage" in out.stderr
    wl = tmp_path / "wl.jsonl"
    wl.write_text('{"prompt": [1, 2]}\n')
    out = subprocess.run(
        [sys.executable, "-m", mod, "--fleet-dir", str(tmp_path / "f"),
         "--requests", str(wl), "--fleet.trace", "true", "--", "--mode",
         "serve"], capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "ROADMAP.md A8" in out.stderr


def test_load_workload_equals_jax(tmp_path):
    from tensorflow_distributed_tpu.fleet.run import load_workload as jload
    from tensorflow_distributed_tpu_torch.fleet.run import (
        load_workload as tload)

    wl = tmp_path / "wl.jsonl"
    wl.write_text('{"prompt": [1, 2], "arrival_s": 0.5, "slo": "high"}\n\n'
                  '{"prompt": [3], "max_new_tokens": 4, "eos_id": 2, '
                  '"tenant": "t1", "session": "s"}\n')
    assert tload(str(wl)) == jload(str(wl))
    (tmp_path / "empty.jsonl").write_text("\n")
    for load in (tload, jload):
        with pytest.raises(ValueError, match="names no requests"):
            load(str(tmp_path / "empty.jsonl"))
