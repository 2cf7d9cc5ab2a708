"""PyTorch port: checkpoints (``utils/serialization.py``,
``interop.state_to_flax``/``state_from_flax``, ``train/checkpoint.py``
and ``--resume``) against the JAX package.

One format serves both packages. The port's codec writes flax's bytes
(``flax.serialization.to_bytes``, the chunked form included) and reads
what flax writes; a port checkpoint restores bit-exactly through JAX's
``ckpt.restore`` into JAX's own template, and JAX saving that restored
state writes the port's bytes again; a JAX checkpoint restores in the
port, whose eval loss and next steps then follow JAX's. Resume is exact:
3 steps, then ``--resume`` to 6, equal 6 straight steps bit for bit with
dropout on. The rest mirrors ``tests/test_checkpoint.py``: keep-N, the
corrupt step quarantined with a fallback, the explicit missing step,
``available_steps`` ignoring garbage, a pre-EMA checkpoint.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization as fser

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import checkpoint as jckpt
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models.cnn import MnistCNN
from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils import serialization as ser
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

TINY = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
            eval_every=0, log_every=1, eval_batch_size=8,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0)
CHAINS = {"adam": {}, "adamw": dict(weight_decay=0.1),
          "sgd": dict(optimizer="sgd"), "clip": dict(grad_clip_norm=0.5),
          "ema": dict(ema_decay=0.9),
          "sgd_clip": dict(optimizer="sgd", grad_clip_norm=0.5)}


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models run hundreds of small ops a step: one intra-op
    thread keeps them fast when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(**fields):
    """JAX's freshly built train state (its own template) for ``fields``."""
    jcfg = JaxConfig(**{**TINY, **fields})
    mesh = make_mesh(jcfg.mesh)
    return jloop._build_model_and_state(jcfg, mesh,
                                        jax_make_task(jcfg, mesh))[1]


def _state_dict(jstate):
    return fser.to_state_dict(jax.device_get(jstate))


def _port_train(tmp, steps, **fields):
    cfg = TrainConfig(**{**TINY, **fields}, train_steps=steps, device="cpu",
                      checkpoint_dir=str(tmp))
    return tloop.train(cfg, logger=MetricLogger(enabled=False))


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    return None if tree is None else (np.shape(tree), np.asarray(tree).dtype)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
        assert np.asarray(got).dtype == np.asarray(want).dtype, path


# --- the codec ------------------------------------------------------------

def _mixed_tree():
    rng = np.random.default_rng(0)
    return {"step": np.asarray(7, np.int32),
            "params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "empty": np.zeros((0, 2), np.float32),
                       "big": rng.standard_normal(40000).astype(np.float32)},
            "scalars": {str(i): v for i, v in enumerate(
                [0, 127, 128, -32, -33, 200, -200, 70000, -70000, 2 ** 40,
                 -2 ** 40, 1.5, True, False, "x" * 40, b"\0" * 300,
                 np.float32(2.5), np.int64(-3)])},
            "extra": {}, "ema": None}


@pytest.mark.parametrize("chain", ["adam", "ema"])
def test_to_bytes_of_a_jax_state_dict_is_flax_bytes(chain):
    tree = _state_dict(_jax_state(**CHAINS[chain]))
    assert ser.to_bytes(tree) == fser.to_bytes(tree)


def test_to_bytes_of_mixed_leaves_is_flax_bytes():
    tree = _mixed_tree()
    assert ser.to_bytes(tree) == fser.to_bytes(tree)


def test_msgpack_restore_reads_what_flax_writes():
    tree = _mixed_tree()
    got = ser.msgpack_restore(fser.to_bytes(tree))
    want = fser.msgpack_restore(fser.to_bytes(tree))
    _assert_trees_equal(got, want)


def test_chunked_form_matches_flax(monkeypatch):
    """Arrays over the chunk size (patched small in both codecs) go out
    in flax's chunked form, byte for byte, and come back whole."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 1000)
    tree = _mixed_tree()
    blob = fser.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert ser.to_bytes(tree) == blob
    got = ser.msgpack_restore(blob)
    np.testing.assert_array_equal(got["params"]["big"],
                                  tree["params"]["big"])
    assert got["params"]["big"].shape == (40000,)


def test_codec_refuses_bfloat16_and_damaged_bytes():
    import jax.numpy as jnp

    blob = fser.to_bytes({"w": np.asarray(jnp.ones((2,), jnp.bfloat16))})
    with pytest.raises(ValueError, match="bfloat16"):
        ser.msgpack_restore(blob)
    good = fser.to_bytes(_mixed_tree())
    with pytest.raises(ValueError, match="truncated"):
        ser.msgpack_restore(good[:-5])
    with pytest.raises(ValueError, match="extra data"):
        ser.msgpack_restore(good + b"\0")


def test_codec_imports_no_msgpack():
    import subprocess
    import sys

    code = ("import sys; sys.modules['msgpack'] = None\n"
            "from tensorflow_distributed_tpu_torch.utils import "
            "serialization as s\n"
            "import numpy as np\n"
            "t = {'a': np.arange(3.0)}\n"
            "assert (s.msgpack_restore(s.to_bytes(t))['a'] == t['a']).all()\n"
            "print('OK')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


# --- the state dict --------------------------------------------------------

@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_state_to_flax_has_the_jax_templates_keys_and_shapes(chain, tmp_path):
    """The port's state dict has the key sets, order, leaf shapes and
    dtypes of JAX's own template for every optimizer chain."""
    want = _skeleton(_state_dict(_jax_state(**CHAINS[chain])))
    res = _port_train(tmp_path, 1, **CHAINS[chain])
    got = _skeleton(interop.state_to_flax(res.state))
    assert got == want


@pytest.mark.parametrize("make", ["gpt", "gpt_tied", "cnn"])
def test_params_to_flax_inverts_params_from_flax(make):
    model = {"gpt": lambda: gpt_lm("tiny"),
             "gpt_tied": lambda: gpt_lm("tiny", tie_embeddings=True),
             "cnn": MnistCNN}[make]()
    model.init_weights(torch.Generator().manual_seed(1))
    params = dict(model.named_parameters())
    tree = interop.params_to_flax(params, model)
    back = interop.params_from_flax(tree)
    assert set(back) == set(params)
    for name, p in params.items():
        assert torch.equal(back[name], p.detach()), name
    assert list(tree) == sorted(tree)


# --- port save -> JAX restore, JAX save -> port restore ---------------------

@pytest.mark.parametrize("chain", ["adam", "adamw", "sgd", "clip", "ema"])
def test_port_checkpoint_restores_bit_exactly_in_jax(chain, tmp_path):
    """Port: 2 steps and the final save. JAX restores it into its own
    template: params, moments, counts, step and EMA bit-equal to the
    port's state. JAX saving that state writes the port's bytes."""
    fields = CHAINS[chain]
    res = _port_train(tmp_path / "port", 2, **fields)
    assert ckpt.available_steps(str(tmp_path / "port")) == [2]
    jstate = jckpt.restore(str(tmp_path / "port"), _jax_state(**fields))
    restored = _state_dict(jstate)
    assert int(restored["step"]) == 2
    _assert_trees_equal(restored, interop.state_to_flax(res.state))
    jckpt.save(str(tmp_path / "jax"), jstate)
    for name in ("state.msgpack", "manifest.json"):
        with open(tmp_path / "port" / "step_00000002" / name, "rb") as f:
            port_bytes = f.read()
        with open(tmp_path / "jax" / "step_00000002" / name, "rb") as f:
            assert f.read() == port_bytes, name


def test_mesh_manifest_has_the_jax_keys(tmp_path):
    res = _port_train(tmp_path / "port", 1)
    jckpt.save(str(tmp_path / "jax"), jckpt.restore(
        str(tmp_path / "port"), _jax_state()))
    got = ckpt.read_mesh_manifest(str(tmp_path / "port"), 1)
    want = jckpt.read_mesh_manifest(str(tmp_path / "jax"), 1)
    assert set(got) == set(want) == {"mesh", "process_count", "devices",
                                     "specs"}
    assert got["mesh"] == {"data": 1, "seq": 1}
    assert (got["process_count"], got["devices"]) == (1, 1)
    assert set(got["specs"]) == set(want["specs"])
    assert set(got["specs"].values()) == {"PartitionSpec()"}
    assert list(got["specs"]) == sorted(got["specs"])
    assert ckpt.steps_with_mesh(str(tmp_path / "port")) == [
        (1, {"data": 1, "seq": 1})]
    assert res.state.step == 1


def test_jax_checkpoint_restores_in_the_port_and_training_follows_jax(
        tmp_path):
    """JAX: 2 steps and its save. The port restores it: its eval loss is
    JAX's ``evaluate`` to 1e-5, and 3 further port steps (``--resume``)
    follow 3 further JAX steps to 1e-4."""
    d = str(tmp_path)
    jloop.train(JaxConfig(**TINY, train_steps=2, checkpoint_dir=d,
                          checkpoint_every=2),
                logger=MetricLogger(enabled=False))
    jeval = jloop.evaluate_only(JaxConfig(**TINY, mode="eval",
                                          checkpoint_dir=d),
                                logger=MetricLogger(enabled=False))
    teval = tloop.evaluate_only(TrainConfig(**TINY, mode="eval",
                                            checkpoint_dir=d, device="cpu"),
                                logger=MetricLogger(enabled=False))
    assert set(teval) == set(jeval)
    for k in jeval:
        np.testing.assert_allclose(teval[k], jeval[k], rtol=1e-5, err_msg=k)

    jres = jloop.train(JaxConfig(**TINY, train_steps=5, checkpoint_dir=d,
                                 resume=True),
                       logger=MetricLogger(enabled=False))
    jckpt_dir = str(tmp_path / "port")
    os.makedirs(jckpt_dir)
    os.rename(os.path.join(d, "step_00000002"),
              os.path.join(jckpt_dir, "step_00000002"))
    tres = _port_train(jckpt_dir, 5, resume=True)

    def losses(res):
        return [r.metrics["loss"] for r in res.logger.records
                if "loss" in r.metrics]

    assert len(losses(tres)) == 3
    np.testing.assert_allclose(losses(tres), losses(jres), atol=1e-4)
    assert tres.state.step == 5


# --- the port's own round trip and resume ----------------------------------

def test_port_save_then_restore_is_bit_exact(tmp_path):
    res = _port_train(tmp_path, 3, ema_decay=0.9, weight_decay=0.1)
    saved = res.state
    fresh = tloop._build_model_and_state(
        TrainConfig(**TINY, ema_decay=0.9, weight_decay=0.1, device="cpu"),
        torch.device("cpu"))[1]
    got = ckpt.restore(str(tmp_path), fresh)
    assert got.step == saved.step == 3
    assert got.opt_state["count"] == saved.opt_state["count"] == 3
    for name, p in saved.params.items():
        assert torch.equal(got.params[name], p), name
    for key in ("mu", "nu"):
        for name, t in saved.opt_state[key].items():
            assert torch.equal(got.opt_state[key][name], t), (key, name)
    for name, t in saved.ema.items():
        assert torch.equal(got.ema[name], t), name


@pytest.mark.parametrize("fields", [dict(), dict(ema_decay=0.9,
                                                 grad_accum_steps=2)])
def test_resume_equals_an_uninterrupted_run_with_dropout(fields, tmp_path):
    """6 straight steps against 3 steps, then --resume to 6 in a new
    train(): the same losses, params, moments and EMA, bit for bit, with
    dropout 0.25 (the masks are drawn from the step)."""
    fields = dict(fields, dropout_rate=0.25)
    straight = _port_train(tmp_path / "a", 6, **fields)
    first = _port_train(tmp_path / "b", 3, checkpoint_every=3, **fields)
    second = _port_train(tmp_path / "b", 6, resume=True, **fields)

    def losses(res):
        return [r.metrics["loss"] for r in res.logger.records
                if "loss" in r.metrics]

    assert losses(first) + losses(second) == losses(straight)
    for name, p in straight.state.params.items():
        assert torch.equal(second.state.params[name], p), name
    for name, t in (straight.state.ema or {}).items():
        assert torch.equal(second.state.ema[name], t), name
    for name, t in straight.state.opt_state["nu"].items():
        assert torch.equal(second.state.opt_state["nu"][name], t), name
    assert ckpt.available_steps(str(tmp_path / "b")) == [3, 6]


def test_resume_writes_resumed_and_start_records(tmp_path, capsys):
    _port_train(tmp_path, 2, checkpoint_every=2)
    cfg = TrainConfig(**TINY, train_steps=3, device="cpu", resume=True,
                      checkpoint_dir=str(tmp_path))
    tloop.train(cfg)
    out = capsys.readouterr().out
    assert '{"event": "resumed", "step": 2}' in out
    assert '"start_step": 2' in out
    # --resume on an empty directory starts from step 0, as JAX does.
    cfg = TrainConfig(**TINY, train_steps=1, device="cpu", resume=True,
                      checkpoint_dir=str(tmp_path / "empty"))
    tloop.train(cfg)
    assert '"start_step": 0' in capsys.readouterr().out


# --- mirrors of tests/test_checkpoint.py -----------------------------------

def _fresh_state(**fields):
    cfg = TrainConfig(**{**TINY, **fields}, device="cpu")
    return tloop._build_model_and_state(cfg, torch.device("cpu"))[1]


def test_keep_n_prunes_the_oldest(tmp_path):
    state = _fresh_state()
    for step in range(1, 6):
        state.step = step
        ckpt.save(str(tmp_path), state, keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_corrupt_latest_is_quarantined_with_a_fallback(tmp_path, capsys):
    state = _fresh_state()
    for step in (1, 2):
        state.step = step
        ckpt.save(str(tmp_path), state)
    path = tmp_path / "step_00000002" / "state.msgpack"
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    got = ckpt.restore(str(tmp_path), _fresh_state())
    assert got.step == 1
    assert ckpt.available_steps(str(tmp_path)) == [1]
    assert (tmp_path / "quarantined_step_00000002").is_dir()
    assert "checksum mismatch" in capsys.readouterr().err
    # An explicit corrupt step raises and touches nothing.
    state.step = 3
    ckpt.save(str(tmp_path), state)
    (tmp_path / "step_00000003" / "state.msgpack").write_bytes(b"\x93\x01")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(str(tmp_path), _fresh_state(), step=3)
    assert ckpt.available_steps(str(tmp_path)) == [1, 3]


def test_every_step_corrupt_raises(tmp_path):
    state = _fresh_state()
    state.step = 1
    ckpt.save(str(tmp_path), state)
    (tmp_path / "step_00000001" / "state.msgpack").write_bytes(b"junk")
    with pytest.raises(ckpt.CheckpointCorruptError, match="every checkpoint"):
        ckpt.restore(str(tmp_path), _fresh_state())


def test_explicit_missing_step_lists_the_available_ones(tmp_path):
    state = _fresh_state()
    for step in (3, 6):
        state.step = step
        ckpt.save(str(tmp_path), state)
    with pytest.raises(FileNotFoundError,
                       match=r"available steps: \[3, 6\] \(written on mesh "
                             r"single-device\)"):
        ckpt.restore(str(tmp_path), _fresh_state(), step=4)
    with pytest.raises(FileNotFoundError, match="no checkpoints under"):
        ckpt.restore(str(tmp_path / "none"), _fresh_state())
    assert ckpt.restore(str(tmp_path), _fresh_state(), step=3).step == 3


def test_available_steps_ignores_garbage(tmp_path):
    state = _fresh_state()
    state.step = 4
    ckpt.save(str(tmp_path), state)
    (tmp_path / "step_00000009.tmp").mkdir()          # a crashed save
    (tmp_path / "step_00000007").write_text("x")      # a stray file
    (tmp_path / "step_00000008").mkdir()              # no state file
    (tmp_path / "step_abc").mkdir()
    (tmp_path / "quarantined_step_00000010").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    assert ckpt.available_steps(str(tmp_path)) == [4]
    assert ckpt.available_steps(str(tmp_path / "absent")) == []
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("ema_now", [False, True])
def test_pre_ema_checkpoint_restores(ema_now, tmp_path):
    """A state file without the ``ema`` key (written before TrainState
    had one) restores with EMA off, and seeds a newly enabled EMA from
    its params; an EMA checkpoint restores into an EMA-off run by
    dropping the average."""
    state = _fresh_state()
    state.step = 1
    tree = interop.state_to_flax(state)
    del tree["ema"]
    ckpt._write(str(tmp_path), 1, tree, keep=3)
    got = ckpt.restore(str(tmp_path), _fresh_state(
        **(dict(ema_decay=0.9) if ema_now else {})))
    if ema_now:
        for name, p in got.params.items():
            assert torch.equal(got.ema[name], p), name
    else:
        assert got.ema is None
    with_ema = _fresh_state(ema_decay=0.9)
    with_ema.step = 2
    ckpt.save(str(tmp_path), with_ema)
    assert ckpt.restore(str(tmp_path), _fresh_state()).ema is None


def test_a_checkpoint_of_another_model_is_refused(tmp_path):
    state = _fresh_state()
    state.step = 1
    ckpt.save(str(tmp_path), state)
    with pytest.raises(ValueError, match="checkpoint leaf shape"):
        ckpt.restore(str(tmp_path), _fresh_state(seq_len=64))
    with pytest.raises(ValueError, match="do not match the model"):
        ckpt.restore(str(tmp_path), _fresh_state(tie_embeddings=True))
    with pytest.raises(ValueError, match="'trace'"):
        ckpt.restore(str(tmp_path), _fresh_state(optimizer="sgd"))
