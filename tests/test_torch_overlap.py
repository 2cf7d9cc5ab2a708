"""PyTorch port: the explicit gradient sync (``--grad-sync
serial|overlap``, ``parallel/overlap.py``) against the JAX package on
the CPU.

The bucket plan and its traffic estimate equal JAX's on JAX's own cases
(given JAX's leaf order); the block layout round-trips. One gloo world
of 2 ranks runs a tiny GPT (f32) from the JAX init through the port's
explicit step on JAX's identity-test batches: serial and overlap are
bit-identical over 3 steps with the middle one NaN-poisoned and skipped
(clip, EMA, Adam slots), and each equals JAX's ``make_explicit_train_step``
on a 2-device mesh at 1e-4 (the clipped runs against JAX's serial path:
JAX's own overlap-with-clip test is red on this tree, ROADMAP.md C); the
slots stay blocks. ``TrainConfig.validate`` refuses what JAX's refuses,
with its messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.data.lm import synthetic_clm
from tensorflow_distributed_tpu.models import transformer as jtf
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.parallel import overlap as joverlap
from tensorflow_distributed_tpu.train.state import create_train_state
from tensorflow_distributed_tpu.train.tasks import (
    make_mlm_loss, mlm_batch_shardings)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import MeshConfig, TrainConfig
from tensorflow_distributed_tpu_torch.parallel import overlap
from torch_ring_workers import explicit_steps, spawn_ranks
from torch_threads import _one_thread  # noqa: F401


# --- the plan (JAX's cases, tests/test_overlap.py) -----------------------


def _fake_tree(shapes, dtype="float32"):
    return {f"leaf_{i:02d}": np.zeros(s, dtype=dtype)
            for i, s in enumerate(shapes)}


def _leaves(tree):
    """JAX's leaf order (a dict flattens by sorted key)."""
    return [((k,), v.shape, v.dtype.name) for k, v in sorted(tree.items())]


PLAN_CASES = {
    "size-bound": (_fake_tree([(64, 64)] * 6), 2,
                   dict(bucket_bytes=40 * 1024, fsdp_min_size=256)),
    "oversize": (_fake_tree([(16, 16), (512, 512), (16, 16)]), 2,
                 dict(bucket_bytes=8 * 1024, fsdp_min_size=64)),
    "dtype-keyed": ({"a": np.zeros((64, 64), np.float32),
                     "b": np.zeros((64, 64), np.float16),
                     "c": np.zeros((64, 64), np.float32),
                     "tiny": np.zeros((8,), np.float32),
                     "odd": np.zeros((63, 3), np.float32)}, 2,
                    dict(bucket_bytes=1 << 20, fsdp_min_size=64)),
    "axis2": (_fake_tree([(64, 64)] * 4), 2, dict(fsdp_min_size=64)),
    "axis4": (_fake_tree([(64, 64)] * 4), 4, dict(fsdp_min_size=64)),
    "axis1": (_fake_tree([(64, 64)] * 4), 1, dict(fsdp_min_size=64)),
    "default-bound": (_fake_tree([(1024, 1024)] * 3 + [(96, 1000)]), 8, {})}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_is_jax_s(case):
    """The same buckets (leaf paths, shapes, scatter dims, sizes), the
    same summary and the same per-step traffic estimate."""
    tree, n, kw = PLAN_CASES[case]
    want = joverlap.plan_buckets(tree, n, **kw)
    got = overlap.plan_buckets(_leaves(tree), n, **kw)
    assert got.describe() == want.describe()
    for mine, theirs in ((got.scatter, want.scatter),
                         (got.replicated, want.replicated)):
        assert [[(lp.path, lp.shape, lp.dtype, lp.scatter_dim, lp.size,
                  lp.nbytes) for lp in b] for b in mine] == \
            [[(lp.path, lp.shape, lp.dtype, lp.scatter_dim, lp.size,
               lp.nbytes) for lp in b] for b in theirs]
    assert overlap.comm_bytes_per_step(got) == pytest.approx(
        joverlap.comm_bytes_per_step(want))


@pytest.mark.parametrize("n", [2, 4])
def test_block_layout_round_trip(n):
    """A bucket's leaves -> rows side by side -> each rank's blocks (a
    leaf's rank-i block is row i of the leaf viewed [n, numel / n]) ->
    gathered rows -> the leaves, bit for bit."""
    rng = np.random.default_rng(0)
    leaves = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((8, 5), (5, 8), (3, 4, 8), (16,))]
    rows = overlap.bucket_rows(leaves, n)
    assert rows.shape == (n, sum(t.numel() for t in leaves) // n)
    sizes = [t.numel() for t in leaves]
    for i in range(n):
        for t, block in zip(leaves, overlap.split_blocks(rows[i:i + 1],
                                                         sizes, n)):
            assert torch.equal(block[0],
                               overlap.leaf_rows(t, n)[i])
    for t, part in zip(leaves, overlap.split_blocks(rows, sizes, n)):
        assert torch.equal(overlap.rows_to_leaf(part, t.shape), t)


# --- the steps: the port on 2 gloo ranks, JAX on a 2-device mesh ---------

SEQ, BATCH, STEPS, CLIP = 16, 8, 3, 0.05
PORT = dict(model="gpt_lm", model_size="tiny", seq_len=SEQ,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=1e-3,
            ema_decay=0.999)
OVERLAP = dict(grad_sync="overlap", param_partition="zero1")
SERIAL = dict(grad_sync="serial")
RUNS = {"serial": SERIAL, "overlap": OVERLAP,
        "serial_clip": dict(SERIAL, grad_clip_norm=CLIP),
        "overlap_clip": dict(OVERLAP, grad_clip_norm=CLIP),
        "serial_skip": dict(SERIAL, grad_clip_norm=CLIP, poison=(1,)),
        "overlap_skip": dict(OVERLAP, grad_clip_norm=CLIP, poison=(1,))}


def _jax_run(mesh, model, batches, sync, clip=0.0):
    """JAX's explicit step (JAX's identity-test setup in f32): 3 steps,
    the losses and the state."""
    sh = mlm_batch_shardings(mesh)
    state = create_train_state(model, optax.adam(1e-3),
                               np.zeros((2, SEQ), np.int32), mesh, seed=0,
                               opt_fsdp=sync == "overlap",
                               fsdp_min_size=256, ema=True)
    params_out = (jax.tree_util.tree_map(lambda a: a.sharding, state.params)
                  if sync == "overlap" else None)
    step = joverlap.make_explicit_train_step(
        mesh, state, loss=make_mlm_loss(), batch_shardings=sh,
        grad_sync=sync, bucket_bytes=8192, fsdp_min_size=256, donate=False,
        ema_decay=0.999, params_out_shardings=params_out,
        grad_clip_norm=clip)
    losses = []
    for b in batches:
        state, m = step(state, {k: jax.device_put(v, sh[k])
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, state, step.bucket_plan


@pytest.fixture(scope="module")
def explicit(tmp_path_factory, devices8):
    """The port's RUNS on 2 gloo ranks and JAX's serial, overlap and
    clipped serial runs on the same init and batches."""
    tmp = tmp_path_factory.mktemp("overlap")
    mesh = make_mesh(JaxMesh(data=2), devices8[:2])
    model = jtf.gpt_lm(mesh=None, size="tiny", tp_partitioning=False,
                       dropout_rate=0.0, compute_dtype=jnp.float32,
                       max_len=SEQ)
    ds = synthetic_clm(n=64, seq_len=SEQ, vocab_size=64)
    batches = [{k: np.asarray(v) for k, v in ds.batch(
        (np.arange(BATCH) + i * BATCH) % ds.tokens.shape[0]).items()}
        for i in range(STEPS)]
    jax_runs = {"serial": _jax_run(mesh, model, batches, "serial"),
                "overlap": _jax_run(mesh, model, batches, "overlap"),
                "serial_clip": _jax_run(mesh, model, batches, "serial",
                                        CLIP)}
    init = create_train_state(model, optax.adam(1e-3),
                              np.zeros((2, SEQ), np.int32), mesh, seed=0)
    torch.save(interop.params_from_flax(jax.device_get(init.params)),
               tmp / "init.pt")
    torch.save([{k: torch.from_numpy(v) for k, v in b.items()}
                for b in batches], tmp / "batches.pt")
    spawn_ranks(explicit_steps, 2, tmp, tmp / "init.pt", tmp / "batches.pt",
                [(name, dict(PORT, **kw)) for name, kw in RUNS.items()], tmp)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)], jax_runs


def _bit_equal(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("pair", [("serial", "overlap"),
                                  ("serial_clip", "overlap_clip"),
                                  ("serial_skip", "overlap_skip")])
def test_serial_and_overlap_are_bit_identical(explicit, pair):
    """Params, Adam slots and EMA bit for bit, and the same metrics (the
    skipped step discarded on both, the norm rebuilt alike)."""
    ranks, _ = explicit
    for got in ranks:
        a, b = got[pair[0]], got[pair[1]]
        assert _bit_equal(a["tensors"], b["tensors"]) == []
        assert a["metrics"][0] == b["metrics"][0]
        skipped = [m.get("skipped_nonfinite", 0.0) for m in b["metrics"]]
        assert skipped == ([0.0, 1.0, 0.0] if "skip" in pair[0]
                           else [0.0] * STEPS)
    assert ranks[0]["overlap"]["tensors"].keys() == \
        ranks[1]["overlap"]["tensors"].keys()
    for k, v in ranks[0][pair[1]]["tensors"].items():
        assert torch.equal(v, ranks[1][pair[1]]["tensors"][k]), k


@pytest.mark.parametrize("name,jax_name", [("serial", "serial"),
                                           ("overlap", "overlap"),
                                           ("serial_clip", "serial_clip"),
                                           ("overlap_clip", "serial_clip")])
def test_steps_match_jax(explicit, name, jax_name):
    """The losses (each rank's mean, averaged) and the params after 3
    steps equal JAX's explicit step at 1e-4 (the params with atol 1e-5,
    1% of one Adam step at lr 1e-3: Adam's first steps move an element
    whose gradient sums to ~0 by a step of either sign); the plan's
    summary is JAX's."""
    ranks, jax_runs = explicit
    losses, state, plan = jax_runs[jax_name]
    params = interop.params_from_flax(jax.device_get(state.params))
    for got in ranks:
        np.testing.assert_allclose([m["loss"] for m in got[name]["metrics"]],
                                   losses, rtol=1e-4)
        for k, v in params.items():
            np.testing.assert_allclose(
                got[name]["tensors"][f"params/{k}"].numpy(), v.numpy(),
                rtol=1e-4, atol=1e-5, err_msg=k)
        assert got[name]["plan"] == plan.describe()


def test_slots_stay_blocks(explicit):
    """After the overlap steps each scattered leaf's Adam slots on a
    rank are its [1, numel / 2] block; the others whole."""
    ranks, _ = explicit
    got = ranks[0]["overlap"]
    params = {k.split("/", 1)[1]: v for k, v in got["tensors"].items()
              if k.startswith("params/")}
    assert got["blocked"]
    for k, shape in got["slot_shapes"].items():
        want = ((1, params[k].numel() // 2) if k in got["blocked"]
                else tuple(params[k].shape))
        assert shape == want, k


# --- TrainConfig.validate: JAX's refusals and messages -------------------

def _both(**kw):
    base = dict(model="gpt_lm", model_size="tiny", dataset="synthetic",
                grad_sync="overlap", param_partition="zero1",
                batch_size=16)
    base.update(kw)
    jmesh = base.pop("mesh", dict(data=2))
    return (JaxConfig(**base, mesh=JaxMesh(**jmesh)),
            TrainConfig(**base, mesh=MeshConfig(**jmesh)))


REJECTIONS = {
    "data1": dict(mesh=dict(data=1)),
    "model2": dict(mesh=dict(data=2, model=2)),
    "seq2": dict(mesh=dict(data=2, seq=2)),
    "replicated": dict(param_partition="replicated"),
    "fsdp": dict(param_partition="fsdp"),
    "serial-zero1": dict(grad_sync="serial"),
    "adafactor": dict(optimizer="adafactor"),
    "accum": dict(grad_accum_steps=2),
    "ce-chunk": dict(ce_chunk=8),
    "shard-vocab": dict(shard_vocab=True),
    "serve": dict(mode="serve"),
    "banana": dict(grad_sync="banana"),
    "partition-banana": dict(param_partition="banana"),
    "bucket-without-overlap": dict(grad_sync="implicit",
                                   param_partition="replicated",
                                   grad_sync_bucket_mb=4.0),
    "bucket-zero": dict(grad_sync_bucket_mb=0.0)}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_config_refuses_with_jax_s_message(case):
    jcfg, cfg = _both(**REJECTIONS[case])
    with pytest.raises(ValueError) as want:
        jcfg.validate()
    with pytest.raises(ValueError) as got:
        cfg.validate()
    assert str(got.value) == str(want.value)


def test_config_takes_what_jax_takes():
    for kw in ({}, dict(grad_clip_norm=1.0), dict(grad_sync_bucket_mb=8.0),
               dict(grad_sync="serial", param_partition="replicated",
                    grad_clip_norm=1.0)):
        jcfg, cfg = _both(**kw)
        jcfg.validate()
        cfg.validate()
        assert cfg.overlap_grad_sync_conflict() is None


@pytest.mark.parametrize("kw,what", [
    (dict(grad_sync="implicit", optimizer="adafactor"), "adafactor"),
    (dict(grad_sync="implicit", mode="serve"), "--mode serve")])
def test_port_refuses_naming_roadmap(kw, what):
    """Where JAX would run (adafactor's factored statistics on blocks) or
    ignore the flag (serving), the port refuses, naming ROADMAP.md A5."""
    _, cfg = _both(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A5") as e:
        cfg.validate()
    assert what in str(e.value)
