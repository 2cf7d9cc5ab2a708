"""PyTorch port: ``parallel/pipeline.py`` (the schedules' bookkeeping and
GPipe on a toy stage) and the pipeline's config walls, against the JAX
package on the CPU.

``bubble_fraction`` and ``stack_stage_params`` (and its inverse, V 1 and
2) equal JAX's; ``pipeline_apply`` over ``StackedPipe(S)`` (every stage
in one process) computes JAX's output and gradients on a toy stage
(``tanh(x W_s + b_s)``) at M 4 and 8 to 1e-6, with the stage aux summed
over the (stage, microbatch) slots; every JAX pipeline check raises
JAX's message, and what is left out (Adafactor under pipe x model or
zero1, MoE under pipe x seq, an expert axis with pipelined_lm, the pipe
for another family) is refused naming ROADMAP.md A5; local SGD
validates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import pipeline as jpipe
from tensorflow_distributed_tpu.parallel.mesh import make_mesh
from tensorflow_distributed_tpu_torch.config import MeshConfig, TrainConfig
from tensorflow_distributed_tpu_torch.parallel import pipeline as tpipe
from tensorflow_distributed_tpu_torch.parallel.mesh import (
    StackedPipe, stacked_pipe)
from torch_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("M,S", [(4, 1), (4, 4), (8, 4), (16, 2)])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_bubble_fraction_is_jaxs(M, S, schedule):
    assert tpipe.bubble_fraction(M, S, schedule) == jpipe.bubble_fraction(
        M, S, schedule)


def test_bubble_fraction_refuses_an_unknown_schedule():
    with pytest.raises(ValueError, match="schedule 'x'"):
        tpipe.bubble_fraction(4, 2, "x")


@pytest.mark.parametrize("S,V", [(2, 1), (4, 1), (2, 2), (3, 2)])
def test_stack_stage_params_is_jaxs_and_inverts(S, V):
    n = 12
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.normal(size=(n, 3, 5)).astype(np.float32)},
            "b": rng.normal(size=(n, 7)).astype(np.float32)}
    want = jax.tree_util.tree_map(
        np.asarray, jpipe.stack_stage_params(tree, S, virtual=V))
    got = tpipe.stack_stage_params(tree, S, V)
    got_t = tpipe.stack_stage_params(
        jax.tree_util.tree_map(torch.from_numpy, tree), S, V)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        mine = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        mine_t = (got_t[keys[0]] if len(keys) == 1
                  else got_t[keys[0]][keys[1]])
        np.testing.assert_array_equal(mine, leaf)
        np.testing.assert_array_equal(mine_t.numpy(), leaf)
    back = tpipe.unstack_stage_params(got, V)
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
    np.testing.assert_array_equal(back["b"], tree["b"])
    # Virtual stage j = v S + s owns layers [j lps, (j + 1) lps).
    lps = n // (S * V)
    for s in range(S):
        for v in range(V):
            j = v * S + s
            layers = list(tpipe.stage_layers(j, n, S, V))
            assert layers == list(range(j * lps, (j + 1) * lps))
            block = got["b"][s] if V == 1 else got["b"][s, v]
            np.testing.assert_array_equal(block, tree["b"][layers])


def test_stack_stage_params_refuses_an_uneven_cut():
    with pytest.raises(ValueError, match="12 layers not divisible by 4 "
                                         "stages x 2 virtual chunks"):
        tpipe.stack_stage_params({"w": np.zeros((12, 2))}, 4, 2)


def _toy(S, M, D=8, B=16, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=(S, D)).astype(np.float32) * 0.1
    x = rng.normal(size=(B, 4, D)).astype(np.float32)
    g = rng.normal(size=(B, 4, D)).astype(np.float32)
    return w, b, x, g


@pytest.mark.parametrize("M", [4, 8])
def test_pipeline_apply_and_its_gradient_match_jax(devices8, M):
    """GPipe on a toy stage over S 4: output, d/dx and d/d(stage params)
    of <out, g>, and the aux sums (stage_aux), against JAX's
    pipeline_apply on the 8-device mesh's pipe axis."""
    S = 4
    w, b, x, g = _toy(S, M)
    mesh = make_mesh(JaxMesh(data=8 // S, pipe=S), devices8)

    def jstage(p, xm):
        y = jnp.tanh(xm @ p["w"] + p["b"])
        return y, {"sq": jnp.sum(y * y)}

    def jloss(params, xx):
        out, aux = jpipe.pipeline_apply(jstage, params, xx, mesh, M,
                                        stage_aux=True)
        return jnp.sum(out * g) + 0.5 * aux["sq"], (out, aux)

    (_, (jout, jaux)), (jdp, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))({"w": w, "b": b}, x)

    tw = torch.tensor(w, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)

    def tstage(j, xm, m):
        y = torch.tanh(xm @ tw[j] + tb[j])
        return y, {"sq": torch.sum(y * y)}

    out, aux = tpipe.pipeline_apply(tstage, tx, StackedPipe(S), M,
                                    stage_aux=True)
    (torch.sum(out * torch.from_numpy(g)) + 0.5 * aux["sq"]).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux["sq"].detach()), float(jaux["sq"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdp["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdp["b"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backward", ["recompute", "stash"])
def test_one_f_one_b_equals_gpipe_on_the_toy_stage(backward):
    """1F1B (and, at V 2, the interleaved form) on the toy stage gives
    GPipe's gradients, and keeps at most min(2S, M) microbatches in
    flight a stage."""
    S, M = 4, 8
    w, b, x, g = _toy(S * 2, M)
    gt = torch.from_numpy(g)
    for V in ((1, 2) if backward == "recompute" else (1,)):
        Sv = S * V
        tw = torch.tensor(w[:Sv], requires_grad=True)
        tb = torch.tensor(b[:Sv], requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)

        def stage(j, xm, m):
            return torch.tanh(xm @ tw[j] + tb[j])

        out = tpipe.pipeline_apply(stage, tx, StackedPipe(S), M, V)
        torch.sum(out * gt).backward()
        want = [t.grad.clone() for t in (tw, tb, tx)]
        for t in (tw, tb, tx):
            t.grad = None

        def last_fn(y, aux_mb):
            return torch.sum(y * aux_mb[0]), {}

        xx = tx.detach()
        if V == 1:
            _, _, _, d_x = tpipe.pipeline_value_and_grad(
                stage, last_fn, xx, (gt,), StackedPipe(S), M,
                backward=backward)
        else:
            _, _, _, d_x = tpipe.interleaved_pipeline_value_and_grad(
                stage, last_fn, xx, (gt,), StackedPipe(S), M, V)
        for got, ref in zip((tw.grad, tb.grad, d_x), want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_gpipe_takes_as_few_microbatches_as_stages():
    """GPipe needs M >= S, as JAX's pipeline_apply (its virtual stages
    are V passes): S 2 x V 2 over M 2 is the four stages in order."""
    w, b, x, _ = _toy(4, 2)
    tw, tb = torch.tensor(w), torch.tensor(b)
    out = tpipe.pipeline_apply(lambda j, xm, m: torch.tanh(xm @ tw[j]
                                                           + tb[j]),
                               torch.tensor(x), StackedPipe(2), 2, 2)
    want = torch.tensor(x)
    for j in range(4):
        want = torch.tanh(want @ tw[j] + tb[j])
    torch.testing.assert_close(out, want)
    with pytest.raises(ValueError, match="microbatches >= stages"):
        tpipe.pipeline_apply(lambda j, xm, m: xm, torch.tensor(x),
                             StackedPipe(4), 2)


def test_stacked_pipe_mesh_holds_every_stage():
    mesh = stacked_pipe(4)
    assert (mesh.pipe, mesh.pp.stages, mesh.distributed) == (
        4, [0, 1, 2, 3], False)
    assert tpipe.local_virtual_stages(mesh.pp, 2) == list(range(8))


# --- the config walls --------------------------------------------------

BASE = dict(model="pipelined_lm", model_size="tiny", dataset="synthetic",
            batch_size=8, compute_dtype="float32")
# Each: TrainConfig fields and mesh axes JAX and the port both refuse with
# JAX's ValueError and message.
JAX_WALLS = {
    "schedule": dict(pipeline_schedule="zb"),
    "backward": dict(pipeline_backward="both"),
    "backward_needs_1f1b": dict(pipeline_backward="stash",
                                pipeline_schedule="gpipe"),
    "backward_needs_pipelined": dict(model="gpt_lm",
                                     pipeline_backward="stash"),
    "1f1b_accum": dict(grad_accum_steps=2),
    "fsdp": dict(param_partition="fsdp"),
    "grad_sync": dict(grad_sync="serial", mesh=dict(data=2)),
    "microbatches": dict(pipeline_microbatches=0),
    "virtual": dict(pipeline_virtual_stages=0),
    "virtual_family": dict(model="gpt_lm", pipeline_virtual_stages=2),
    "virtual_stash": dict(pipeline_virtual_stages=2,
                          pipeline_backward="stash"),
    "virtual_inflight": dict(pipeline_virtual_stages=2,
                             pipeline_microbatches=2, mesh=dict(pipe=2)),
    "batch_split": dict(batch_size=10),
    "inflight": dict(pipeline_microbatches=2, mesh=dict(pipe=4)),
    "label_smoothing": dict(label_smoothing=1.0),
    "param_sync": dict(param_sync_every=0),
    "param_sync_pipe": dict(param_sync_every=2, mesh=dict(pipe=2)),
    "param_sync_pipelined": dict(param_sync_every=2),
    "param_sync_extra": dict(model="resnet20", param_sync_every=2,
                             dataset="cifar10_synthetic"),
    "shard_vocab": dict(shard_vocab=True),
    "ce_kernel": dict(ce_chunk=16, ce_impl="kernel"),
    "skip_batch": dict(resilience_nonfinite="skip_batch"),
    "serve_pipe": dict(model="gpt_lm", mode="serve", mesh=dict(pipe=2)),
}


def _configs(fields):
    fields = dict(BASE, **fields)
    mesh = fields.pop("mesh", {})
    nonfinite = fields.pop("resilience_nonfinite", None)
    from tensorflow_distributed_tpu.config import (
        ResilienceConfig as JaxRes)
    from tensorflow_distributed_tpu_torch.config import ResilienceConfig
    jkw, tkw = {}, {}
    if nonfinite:
        jkw["resilience"] = JaxRes(nonfinite=nonfinite)
        tkw["resilience"] = ResilienceConfig(nonfinite=nonfinite)
    return (JaxConfig(**fields, mesh=JaxMesh(**mesh), **jkw),
            TrainConfig(**fields, mesh=MeshConfig(**mesh), device="cpu",
                        **tkw))


@pytest.mark.parametrize("name", sorted(JAX_WALLS))
def test_pipeline_walls_raise_jaxs_message(name):
    jcfg, tcfg = _configs(JAX_WALLS[name])
    with pytest.raises(ValueError) as jerr:
        jcfg.validate()
    with pytest.raises(ValueError) as terr:
        tcfg.validate()
    assert str(terr.value) == str(jerr.value)


def test_the_pipeline_knobs_take_jaxs_defaults():
    jcfg, tcfg = JaxConfig(), TrainConfig()
    for name in ("pipeline_schedule", "pipeline_microbatches",
                 "pipeline_backward", "pipeline_virtual_stages",
                 "param_sync_every"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.mesh.pipe == jcfg.mesh.pipe == 1


# What is left of each combination: pipe x model and zero1 train, and
# Adafactor under either stays refused (A5c); pipe x seq trains, and MoE
# under a seq axis stays refused (A5); local SGD trains (None: it
# validates).
A5_REFUSALS = {
    "pipe_x_model": (dict(optimizer="adafactor",
                          mesh=dict(pipe=2, model=2)), NotImplementedError),
    "pipe_x_seq": (dict(moe_experts=4, mesh=dict(pipe=2, seq=2)),
                   NotImplementedError),
    "zero1": (dict(optimizer="adafactor", param_partition="zero1",
                   mesh=dict(data=2, pipe=2)), NotImplementedError),
    "expert": (dict(moe_experts=4, mesh=dict(pipe=2, expert=2)), ValueError),
    "pipe_for_gpt": (dict(model="gpt_lm", mesh=dict(pipe=2)),
                     NotImplementedError),
    "local_sgd": (dict(model="gpt_lm", param_sync_every=2,
                       mesh=dict(data=2)), None),
}


@pytest.mark.parametrize("name", sorted(A5_REFUSALS))
def test_what_the_slice_leaves_out_is_refused_naming_a5(name):
    fields, exc = A5_REFUSALS[name]
    _, tcfg = _configs(fields)
    if exc is None:
        tcfg.validate()
        return
    with pytest.raises(exc, match="ROADMAP.md A5"):
        tcfg.validate()


def test_an_expert_axis_takes_jaxs_model_message():
    from tensorflow_distributed_tpu.models.pipelined import pipelined_lm

    mesh = make_mesh(JaxMesh(data=2, pipe=2, expert=2), jax.devices())
    with pytest.raises(ValueError) as jerr:
        pipelined_lm(mesh, moe_experts=4)
    _, tcfg = _configs(A5_REFUSALS["expert"][0])
    with pytest.raises(ValueError) as terr:
        tcfg.validate()
    assert str(terr.value).startswith(str(jerr.value))


def test_generate_and_serve_refuse_pipelined_lm_as_jax():
    for mode in ("generate", "serve"):
        jcfg, tcfg = _configs(dict(mode=mode, checkpoint_dir="/nope",
                                   prompt="1,2"))
        with pytest.raises(ValueError) as jerr:
            jcfg.validate()
        with pytest.raises(ValueError, match="needs a causal LM"):
            tcfg.validate()
        assert "needs a causal LM" in str(jerr.value)


def test_cli_parses_the_pipeline_flags():
    from tensorflow_distributed_tpu_torch.config import parse_args

    cfg = parse_args(["--model", "pipelined_lm", "--mesh.pipe", "2",
                      "--pipeline-schedule", "gpipe",
                      "--pipeline-microbatches", "8",
                      "--pipeline-virtual-stages", "2", "--batch-size", "16",
                      "--device", "cpu", "--compute-dtype", "float32"])
    assert (cfg.mesh.pipe, cfg.pipeline_schedule, cfg.pipeline_microbatches,
            cfg.pipeline_virtual_stages) == (2, "gpipe", 8, 2)
