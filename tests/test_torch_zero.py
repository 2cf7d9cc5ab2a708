"""PyTorch port: ZeRO-1 and FSDP (``--param-partition zero1|fsdp``)
against the JAX package on the CPU.

The leaves the port cuts into data blocks are the ones JAX's
``param_sharding(fsdp=True)`` shards over ``data``, for a tiny GPT (with
and without a model axis, and BERT under ``--shard-vocab``) and the CNN.
One gloo world of 2 ranks then trains a tiny GPT (a 512-id vocabulary,
so its tables are cut) replicated, zero1 and fsdp, and the CNN zero1 and
fsdp, all from the JAX init: the partitions agree at JAX's
``test_fsdp`` bounds, the losses equal JAX ``train()``'s under the same
partition at 1e-4, the saves are byte for byte the replicated run's,
they resume under another partition, and each rank holds the predicted
1/data of what is cut. Four ranks run fsdp over data 2 x model 2
against JAX at 1e-4.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import cnn as jcnn
from tensorflow_distributed_tpu.models import transformer as jtf
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.parallel.sharding import param_sharding
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models.cnn import MnistCNN
from tensorflow_distributed_tpu_torch.models.transformer import (
    bert_base_mlm, gpt_lm)
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    FSDP_MIN_SIZE, data_blocked)
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    StackedTP)
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.train.state import Partition
from tests.conftest import FIXTURE_DIR
from torch_ring_workers import spawn_ranks, train_runs
from torch_threads import _one_thread  # noqa: F401


GPT = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
           train_steps=5, eval_every=0, log_every=1, eval_batch_size=8,
           compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
           seed=0, synthetic_vocab=512, ema_decay=0.9)
CNN = dict(model="mnist_cnn", dataset="mnist", data_dir=FIXTURE_DIR,
           validation_size=64, batch_size=64, train_steps=5, eval_every=0,
           log_every=1, eval_batch_size=64, compute_dtype="float32",
           dropout_rate=0.0, learning_rate=2e-3, seed=0, grad_clip_norm=0.5)
# The clip's norm under fsdp sums blocks over the data group, so its
# bits (and a clipped run's) differ from the replicated sum's: the byte-
# identical saves are the unclipped GPT's, the clipped runs are held to
# JAX (the CNN; fsdp over data x model).


def _port_name(path) -> str:
    """A flax param path as the port's parameter name."""
    *module, leaf = [str(getattr(k, "key", k)) for k in path]
    return ".".join(module + ["bias" if leaf == "bias" else "weight"])


def _jax_blocked(model, sample, mesh, min_size):
    abstract = jax.eval_shape(lambda k: model.init(k, sample, train=False),
                              jax.random.key(0))
    tree = param_sharding(mesh, abstract["params"], fsdp=True,
                          fsdp_min_size=min_size)
    return {_port_name(p) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]
            if "data" in jax.tree_util.tree_leaves(tuple(s.spec))}


BLOCKED_CASES = {
    "gpt-data2": ("gpt", 2, 1, 256, {}),
    "gpt-data4-default-min": ("gpt", 4, 1, FSDP_MIN_SIZE, {}),
    "gpt-data2-model2": ("gpt", 2, 2, 256, {}),
    "bert-data2-model2-shard-vocab": ("bert", 2, 2, 256,
                                      {"shard_vocab": True}),
    "cnn-data2": ("cnn", 2, 1, FSDP_MIN_SIZE, {}),
    "cnn-data8": ("cnn", 8, 1, FSDP_MIN_SIZE, {})}


@pytest.mark.parametrize("case", list(BLOCKED_CASES))
def test_blocked_leaves_are_jax_s(case, devices8):
    """``data_blocked`` names exactly the params JAX's fsdp rule shards
    over ``data``: on the flax shapes, at the whole model's size, with
    the dims a model axis (or ``shard_vocab``) takes."""
    family, data, model_axis, min_size, kw = BLOCKED_CASES[case]
    mesh = make_mesh(JaxMesh(data=data, model=model_axis),
                     devices8[:data * model_axis])
    tp = StackedTP(model_axis) if model_axis > 1 else None
    if family == "cnn":
        jmodel, sample = jcnn.MnistCNN(), np.zeros((2, 28, 28, 1),
                                                   np.float32)
        port = MnistCNN()
    else:
        size = dict(vocab_size=512, max_len=32, **kw)
        build = jtf.gpt_lm if family == "gpt" else jtf.bert_base_mlm
        jmodel = build(mesh=mesh, size="tiny", **size)
        sample = np.zeros((2, 32), np.int32)
        port = (gpt_lm if family == "gpt" else bert_base_mlm)(
            "tiny", tp=tp, **size)
    want = _jax_blocked(jmodel, sample, mesh, min_size)
    assert want, "the case cuts nothing"
    assert data_blocked(port, data, min_size) == want


# --- one gloo world of 2 ranks, shared by the tests below ---------------

RUNS = {"rep": ({}, 5), "zero1": ({"param_partition": "zero1"}, 5),
        "fsdp": ({"param_partition": "fsdp"}, 5),
        "fsdp3": ({"param_partition": "fsdp"}, 3),
        "zero1_resume": ({"param_partition": "zero1", "resume": True}, 5),
        "rep3": ({}, 3),
        "fsdp_resume": ({"param_partition": "fsdp", "resume": True}, 5)}
# Where each run saves (a resume reads its partner's 3-step save).
DIRS = {"rep": "rep", "zero1": "zero1", "fsdp": "fsdp", "fsdp3": "a",
        "zero1_resume": "a", "rep3": "b", "fsdp_resume": "b"}


def _jax_init(fields):
    jcfg = JaxConfig(**fields)
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    return interop.params_from_flax(jax.device_get(jstate.params))


def _jax_losses(fields):
    res = jloop.train(JaxConfig(**fields), logger=JaxLogger(enabled=False))
    return ([r.metrics["loss"] for r in res.logger.records
             if "loss" in r.metrics], res.final_metrics)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every run of ``RUNS`` (the GPT) and the CNN under zero1 and fsdp
    on 2 gloo ranks, from the JAX init: (each rank's results, the
    checkpoint root)."""
    tmp = tmp_path_factory.mktemp("zero")
    torch.save(_jax_init(GPT), tmp / "gpt_init.pt")
    torch.save(_jax_init(CNN), tmp / "cnn_init.pt")
    runs = [(name, dict(GPT, **extra, train_steps=steps,
                        checkpoint_dir=str(tmp / DIRS[name]),
                        checkpoint_every=3),
             {"data": 2}, str(tmp / "gpt_init.pt"))
            for name, (extra, steps) in RUNS.items()]
    runs += [(f"cnn_{p}", dict(CNN, param_partition=p), {"data": 2},
              str(tmp / "cnn_init.pt")) for p in ("zero1", "fsdp")]
    spawn_ranks(train_runs, 2, tmp, runs, tmp)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)], tmp


def test_partitions_agree_on_two_ranks(two_ranks):
    """zero1 and fsdp train the replicated run: losses at rtol 1e-5, the
    params at JAX test_fsdp's bounds (fsdp 2e-5 / 1e-6, zero1 1e-4 /
    5e-6), on both ranks."""
    ranks, _ = two_ranks
    for got in ranks:
        rep = got["rep"]
        for name, (rtol, atol) in (("fsdp", (2e-5, 1e-6)),
                                   ("zero1", (1e-4, 5e-6))):
            np.testing.assert_allclose(got[name]["losses"], rep["losses"],
                                       rtol=1e-5)
            for k, v in rep["params"].items():
                np.testing.assert_allclose(got[name]["params"][k].numpy(),
                                           v.numpy(), rtol=rtol, atol=atol,
                                           err_msg=f"{name} {k}")
        assert got["fsdp"]["blocked"] == got["zero1"]["blocked"] == [
            "lm_head.weight", "tok_emb.weight"]


@pytest.mark.parametrize("name,partition", [("zero1", "zero1"),
                                            ("fsdp", "fsdp"),
                                            ("cnn_fsdp", "fsdp")])
def test_train_matches_jax(two_ranks, name, partition):
    """5 steps (EMA on the GPT, clip on the CNN) equal JAX train() under the same
    partition (its data axis all 8 devices: the same global batch) at
    1e-4, losses and final eval."""
    ranks, _ = two_ranks
    base = CNN if name.startswith("cnn") else GPT
    losses, final = _jax_losses(dict(base, param_partition=partition))
    for got in ranks:
        np.testing.assert_allclose(got[name]["losses"], losses, rtol=1e-4)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(got[name]["final"][k], final[k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def _sha(root, d, step):
    path = root / d / f"step_{step:08d}" / "state.msgpack"
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_saves_are_the_replicated_save(two_ranks):
    """A zero1 and an fsdp save (their slot, param and EMA blocks
    gathered) are byte for byte the replicated run's save."""
    _, root = two_ranks
    want = _sha(root, "rep", 5)
    assert _sha(root, "zero1", 5) == want
    assert _sha(root, "fsdp", 5) == want
    assert _sha(root, "rep", 3) == _sha(root, "a", 3) == _sha(root, "b", 3)


def test_saves_resume_under_another_partition(two_ranks):
    """An fsdp save resumed under zero1, and a replicated save under
    fsdp, end at the straight run's bytes; one process restores the
    fsdp save into its whole state."""
    ranks, root = two_ranks
    want = _sha(root, "rep", 5)
    assert _sha(root, "a", 5) == want
    assert _sha(root, "b", 5) == want
    cfg = TrainConfig(**GPT, device="cpu")
    _, state = tloop._build_model_and_state(
        cfg, torch.device("cpu"), task=tloop._make_task(cfg, tloop.ONE_PROCESS))
    ckpt.restore(str(root / "fsdp"), state)
    for k, v in ranks[0]["fsdp"]["params"].items():
        assert torch.equal(state.params[k].detach(), v), k


def test_a_rank_holds_its_share(two_ranks):
    """What a rank's tensors take: fsdp holds half of each cut param
    and of its two Adam slots, zero1 half of the slots only (the
    layout's ``resident_bytes`` prediction)."""
    ranks, _ = two_ranks
    for got in ranks:
        whole = sum(v.numel() * 4 for v in got["rep"]["params"].values())
        cut = sum(got["rep"]["params"][k].numel() * 4
                  for k in got["fsdp"]["blocked"])
        assert got["rep"]["held"] == {"params": whole, "slots": 2 * whole}
        assert got["zero1"]["held"] == {"params": whole,
                                        "slots": 2 * (whole - cut // 2)}
        assert got["fsdp"]["held"] == {"params": whole - cut // 2,
                                       "slots": 2 * (whole - cut // 2)}
    shapes = {k: v.shape for k, v in ranks[0]["rep"]["params"].items()
              if k in ranks[0]["fsdp"]["blocked"]}
    part = Partition("fsdp", tloop.mesh_lib.stacked_data(2),
                     frozenset(shapes), shapes)
    predicted = part.resident_bytes(ranks[0]["rep"]["params"], slots=2)
    assert predicted["params"] == ranks[0]["fsdp"]["held"]["params"]
    assert predicted["slots"] == ranks[0]["fsdp"]["held"]["slots"]


def test_fsdp_over_data_and_model_matches_jax(tmp_path):
    """fsdp over data 2 x model 2 (4 gloo ranks; the blocks cut from a
    rank's TP shard, the norm summed over both groups) equals JAX's
    fsdp on model 2 (data the other 4 devices) at 1e-4."""
    fields = dict(GPT, param_partition="fsdp", grad_clip_norm=0.5)
    jcfg = JaxConfig(**fields, mesh=JaxMesh(model=2))
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    torch.save(interop.params_from_flax(jax.device_get(jstate.params)),
               tmp_path / "init.pt")
    spawn_ranks(train_runs, 4, tmp_path,
                [("fsdp_tp", fields, {"data": 2, "model": 2},
                  str(tmp_path / "init.pt"))], tmp_path)
    want = [r.metrics["loss"] for r in jres.logger.records
            if "loss" in r.metrics]
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")["fsdp_tp"]
        assert got["blocked"] == ["lm_head.weight", "tok_emb.weight"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        np.testing.assert_allclose(got["final"]["loss"],
                                   jres.final_metrics["loss"], rtol=1e-4)
