"""PyTorch port: ``chip_smoke.py``'s elastic phases (60-61: model_reshard,
train_elastic), rehearsed on the CPU.

The argvs parse; the phases run last, in order, and ``--only`` takes
them; the resize legs planned for 1-8 cards; the supervisor's output
parsed into records and the chief's losses; the gates' arithmetic (the
loss at model_zero's gate, model_tp's on the model axis; the step's
gradient from Adam's first moment at model_tp's; the control's params at
model_zero's);
model_reshard at a tiny size on the CPU (re-saves equal to the bit, the
next step equal to the unresharded one's, the same-mesh control not
resharded) failing only on the launch counts; train_elastic's one-card leg through the real supervisor on a
CPU child: the drill, the restart and ``mesh_exhausted`` with exit 137.
"""

import importlib.util
import json
import os

import pytest
import torch
from torch_threads import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()


def test_elastic_argvs_parse():
    """GPT-2-small, seq 1024, global batch 8, bf16, the dense head, saves
    every 2 steps; model_reshard's layouts on model_zero's configuration."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    cfg = parse_args(cs.TRAIN_ELASTIC_ARGV + ["--train-steps", "10"])
    assert (cfg.model_size, cfg.seq_len, cfg.batch_size) == ("small", 1024, 8)
    assert cfg.compute_dtype == "bfloat16" and cfg.ce_chunk == 0
    assert cfg.checkpoint_every == 2 and cfg.dropout_rate == 0.0
    for name, width, part in (cs.RESHARD_FROM,) + cs.RESHARD_LEGS:
        if width == "tp":
            continue
        c = parse_args(cs.MODEL_ZERO_ARGV + ["--mesh.data", str(width),
                                             "--param-partition", part])
        assert c.mesh.data == width and c.param_partition == part
        assert c.ema_decay and c.optimizer == "adam"


def test_elastic_phases_run_last_in_order():
    import inspect

    src = inspect.getsource(cs.main)
    order = ["phase_generate_tp(", "phase_model_reshard(",
             "phase_train_elastic(", 'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)
    assert {"model_reshard", "train_elastic"} <= set(cs.ONLY_PHASES)


@pytest.mark.parametrize("count", [2, 3, 4, 8])
def test_resize_legs_by_card_count(count):
    """Two or three cards: data 2 -> 1, losing all but one card; four:
    data 4 fsdp -> 2 and data 2 x model 2 -> model 2, losing 2; each
    resumes at the save before the fault with the same global batch."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.resilience import supervisor

    runs = cs.train_elastic_runs(count)
    assert [r[0] for r in runs] == (["a_data2"] if count < 4 else
                                    ["a_data4_fsdp", "c_data2_model2"])
    for name, mesh, plan, src, dst, at, rows in runs:
        argv = cs.TRAIN_ELASTIC_ARGV + mesh + ["--train-steps", "10"]
        cfg = parse_args(argv)
        lost = int(plan.split(":")[1])
        total = min(count, 4) if count >= 4 else count
        planned, masked = supervisor.plan_elastic(argv, total, lost)
        assert {k: v for k, v in planned.items() if v != 1} == dst
        assert masked == total - planned["data"] * planned["model"]
        assert cfg.mesh.data == src["data"]
        assert at == int(plan.split("@")[1].split(":")[0]) - 1
        assert at % cfg.checkpoint_every == 0
        assert rows == cfg.batch_size // planned["data"]


def test_supervisor_output_parsed():
    out = "\n".join([
        "[supervisor] leg 0: python -m torch.distributed.run ...",
        '{"event": "start", "mesh": {"data": 4}}',
        "[step      1] t=    0.20s loss=4.17558 accuracy=0.0078",
        "[step      2] t=    0.27s loss=nan accuracy=0.01",
        '[supervisor] {"event": "recovery", "kind": "mesh_change", '
        '"from_mesh": {"data": 4, "model": 1}, "to_mesh": {"data": 2}}',
        "{not json",
        '[W1018 socket.cpp:207] [c10d] a warning{"event": "preempted", '
        '"step": 6, "rank": 3}{"event": "preempted", "step": 6, "rank": 1}',
        '{"event": "preempted", "step": 6, "rank": 0}{"bad": ',
        "[step      2] t=    0.11s loss=4.5e-01 accuracy=0.04"])
    recs = cs.elastic_records(out)
    assert [r["event"] for r in recs] == ["start", "recovery"] + [
        "preempted"] * 3
    assert [r["rank"] for r in recs[2:]] == [3, 1, 0]
    assert cs.records_of(recs, "mesh_change")[0]["to_mesh"] == {"data": 2}
    assert cs.elastic_losses(out) == {1: 4.17558, 2: 0.45}


def test_elastic_gates_hold_the_losses_after_the_resize(capsys):
    """The losses after the resumed step against one card's at
    TOL_RING_LOSS; exit 0, the reshard and the resume are checked."""
    failed = []
    real = cs.check
    cs.check = lambda cond, msg: cond or failed.append(msg)
    try:
        recs = [{"event": "recovery", "kind": "reshard_restore",
                 "from_mesh": {"data": 4, "seq": 1, "model": 1},
                 "to_mesh": {"data": 2, "seq": 1, "model": 1},
                 "seconds": 0.5},
                {"event": "resumed", "step": 4, "per_device_batch": 4}]
        one = {s: 5.0 - 0.1 * s for s in range(1, 11)}
        losses = {s: one[s] + (0.005 if s > 4 else 1.0) for s in one}
        rec = cs.elastic_gates("a", 0, "", recs, losses, one, {"data": 4},
                               {"data": 2}, 4, 4)
        assert not failed and rec["steps_after"] == list(range(5, 11))
        assert rec["max_loss_diff_after"] == pytest.approx(0.005)
        losses[7] += 0.02
        cs.elastic_gates("a", 1, "", recs, losses, one, {"data": 4},
                         {"data": 1}, 4, 8)
        assert len(failed) == 4
    finally:
        cs.check = real
    assert json.loads(capsys.readouterr().out.splitlines()[0])["leg"] == "a"


def test_reshard_gates_arithmetic():
    """Every leg's loss at model_zero's gate (model_tp's on the model
    axis) and its step's gradient, read from Adam's first moment (mu less
    b1 x the restored mu), at model_tp's 2e-2; the same-mesh leg's params
    at model_zero's gates; the update's sign flips counted."""
    b1 = 0.9
    before = {"params/w": torch.tensor([1.0, -2.0]),
              "params/b": torch.tensor([0.5]),
              "mu/w": torch.tensor([0.1, -0.2]), "mu/b": torch.tensor([0.3])}

    def after(grad_w, grad_b, dw=(-1e-3, 1e-3), db=-1e-3):
        """A state one step on from ``before``: mu from the gradient, the
        params moved by the update."""
        return {"params/w": before["params/w"] + torch.tensor(dw),
                "params/b": before["params/b"] + db,
                "mu/w": b1 * before["mu/w"] + (1 - b1) * torch.tensor(grad_w),
                "mu/b": b1 * before["mu/b"] + (1 - b1) * torch.tensor(
                    [grad_b])}

    ref = after([1.0, -1.0], 2.0)
    near = after([1.0 + 1e-3, -1.0], 2.0, dw=(-1e-3 + 1e-5, 1e-3))
    same = cs.RESHARD_FROM
    got = cs.reshard_gates(torch, same, 1.0, 1.0, near, ref, before, b1)
    assert got["ok"] and got["loss_rel_err"] == 0.0
    assert got["grads_rel_err"] == pytest.approx(1e-3 / 6 ** 0.5, rel=1e-3)
    assert got["update_sign_flip_frac"] == 0.0
    assert got["params_excess_over_tol"][1] == "params/w"
    # A params drift past model_zero's gate fails only the control leg.
    far = after([1.0 + 1e-3, -1.0], 2.0, db=-1e-3 + 1e-4)
    assert not cs.reshard_gates(torch, same, 1.0, 1.0, far, ref, before,
                                b1)["ok"]
    width = ("x", 2, "fsdp")
    got = cs.reshard_gates(torch, width, 1.0, 1.0, far, ref, before, b1)
    assert got["ok"] and got["params_rel_err"] == pytest.approx(5e-5,
                                                                rel=1e-2)
    assert not cs.reshard_gates(torch, width, 1.0 + 1e-4, 1.0, far, ref,
                                before, b1)["ok"]
    # A gradient of half the batch, or none: the params still read
    # within one lr, the gradient gate fails.
    for grad in (([0.5, -0.5], 1.0), ([0.0, 0.0], 0.0)):
        bad = after(*grad, dw=(-1e-3, -1e-3))
        got = cs.reshard_gates(torch, width, 1.0, 1.0, bad, ref, before, b1)
        assert not got["ok"] and got["grads_rel_err"] >= 0.3
        assert got["params_rel_err"] < cs.TOL_TP
        assert got["update_sign_flip_frac"] == pytest.approx(1 / 3)
    tp = ("x", "tp", "replicated")
    assert cs.reshard_gates(torch, tp, 1.01, 1.0, far, ref, before, b1)["ok"]
    assert not cs.reshard_gates(torch, tp, 1.03, 1.0, far, ref, before,
                                b1)["ok"]


def test_model_reshard_on_the_cpu(monkeypatch, capsys):
    """A tiny GPT (f32, the CPU, the threshold 256): every layout's info,
    re-save bytes and next step pass; the checks that fail are the launch
    counts (the CPU's plain attention launches no kernel)."""
    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "ZERO_MIN_SIZE", 256)
    argv = list(cs.MODEL_ZERO_ARGV)
    argv[argv.index("small")] = "tiny"
    argv[argv.index("1024")] = "64"
    argv[argv.index("bfloat16")] = "float32"
    monkeypatch.setattr(cs, "MODEL_ZERO_ARGV",
                        argv + ["--synthetic-vocab", "512", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    cs.phase_model_reshard(fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS,
                           torch)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"phase"')]
    assert [r.get("leg") for r in rows] == [cs.RESHARD_FROM[0]] + [
        leg[0] for leg in cs.RESHARD_LEGS] + [None]
    for r in rows[1:-1]:
        assert r["info"]["resharded"] == (r["leg"] != "stacked4_fsdp_same_mesh")
        assert r["resave_sha256_equal"] is (
            None if r["leg"] == "stacked4_fsdp_same_mesh" else True)
        assert r["ok"] and r["loss_rel_err"] == 0.0
    assert len(failed) == 1 + len(cs.RESHARD_LEGS)
    assert all("not launched" in msg for msg in failed)


def test_train_elastic_one_card_on_a_cpu_child(monkeypatch, capsys):
    """The one-card leg through the real supervisor (a tiny CPU child,
    one CPU device declared): the drill writes the mask and kills the
    leg, no mesh fits the survivors, exit 128 + SIGKILL."""
    argv = list(cs.TRAIN_ELASTIC_ARGV)
    argv[argv.index("small")] = "tiny"
    argv[argv.index("1024")] = "32"
    argv[argv.index("bfloat16")] = "float32"
    monkeypatch.setattr(cs, "TRAIN_ELASTIC_ARGV", argv + ["--device", "cpu"])
    monkeypatch.setenv("TFD_CPU_DEVICE_COUNT", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO)
    for var in ("TFD_DEVICE_MASK", "TFD_DEVICE_MASK_FILE"):
        monkeypatch.delenv(var, raising=False)
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cs.phase_train_elastic(torch)
    assert not failed
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"phase"')]
    assert rows[0]["leg"] == "one_card" and rows[0]["rc"] == 137
    assert rows[0]["mask"] == {"lost": 1, "step": 3}
