"""PyTorch port: the native host runtime, the uint8 data backend and the
CIFAR-10 / synthetic image sets, against the JAX package on the CPU.

The port's ctypes binding builds ``native/tfd_native.cc`` into its own
``build/torch_native/`` (never the JAX package's library): its idx
reader and threaded u8 -> f32 gather equal numpy's; ``U8Dataset`` and
``U8ShardedBatcher`` give JAX's batches bit for bit, with numpy's
fallback where the library is missing; the CIFAR binary parse, the
loader and the synthetic CIFAR-10 / ImageNet sets are JAX's arrays; the
CNN under ``--data-backend u8_native`` follows JAX's 5-step trajectory
to 1e-4 and the numpy backend's to 1e-5 (the fixture is uint8 on disk).
"""

import gzip
import os
import struct

import numpy as np
import pytest

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.data import cifar as jcifar
from tensorflow_distributed_tpu.data import mnist as jmnist
from tensorflow_distributed_tpu.data import u8 as ju8
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.data import cifar as tcifar
from tensorflow_distributed_tpu_torch.data import mnist as tmnist
from tensorflow_distributed_tpu_torch.data import u8 as tu8
from tensorflow_distributed_tpu_torch.native import runtime as native
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from tests.conftest import FIXTURE_DIR
from torch_threads import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_into_the_ports_own_dir():
    assert native.available()
    path = native.loaded_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "torch_native")
    assert path == native.library_path() and os.path.exists(path)
    assert native.SRC == os.path.join(REPO, "native", "tfd_native.cc")


@pytest.mark.parametrize("name", sorted(os.listdir(FIXTURE_DIR)))
def test_idx_read_equals_numpy(name):
    path = os.path.join(FIXTURE_DIR, name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "rb") as f:
        want = tmnist.parse_idx(f.read())
    got = native.idx_read(path)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_idx_read_of_int32_is_big_endian(tmp_path):
    arr = np.arange(-6, 6, dtype=np.int32).reshape(3, 4)
    path = tmp_path / "x.idx"
    path.write_bytes(struct.pack(">BBBB", 0, 0, 0x0C, 2)
                     + struct.pack(">ii", 3, 4) + arr.astype(">i4").tobytes())
    np.testing.assert_array_equal(native.idx_read(str(path)), arr)


@pytest.mark.parametrize("threads", [1, 3])
def test_gather_equals_numpy(threads):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (300, 8, 8, 3), dtype=np.uint8)
    idx = rng.integers(0, 300, 77)
    got = native.gather_u8_f32(src, idx, 1.0 / 255.0, nthreads=threads)
    np.testing.assert_array_equal(got, src[idx].astype(np.float32)
                                  * np.float32(1.0 / 255.0))


def _tiny(seed=0, n=96):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (n, 6, 6, 1), dtype=np.uint8)
    return tmnist.Dataset(u8.astype(np.float32) / 255.0,
                          rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("procs,index", [(1, 0), (2, 1), (4, 3), (2, 0)])
def test_u8_batches_equal_jax_s(procs, index):
    """from_float, gather / gather_raw and the sharded stream: JAX's
    arrays bit for bit, and the float batcher's sample order."""
    ds = _tiny()
    jds = jmnist.Dataset(ds.images, ds.labels)
    got = tu8.U8Dataset.from_float(ds)
    want = ju8.U8Dataset.from_float(jds)
    np.testing.assert_array_equal(got.images, want.images)
    idx = np.random.default_rng(procs + index).integers(0, len(got), 16)
    for g, w in zip(got.gather_raw(idx), want.gather_raw(idx)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    tb = tu8.U8ShardedBatcher(got, 16, seed=2, num_processes=procs,
                              process_index=index)
    jb = ju8.U8ShardedBatcher(want, 16, seed=2, num_processes=procs,
                              process_index=index)
    fb = tmnist.ShardedBatcher(ds, 16, seed=2, num_processes=procs,
                               process_index=index)
    for (gi, gl), (wi, wl), (fi, fl), _ in zip(tb.forever(3), jb.forever(3),
                                                fb.forever(3), range(8)):
        assert gi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gl, fl)
        np.testing.assert_allclose(gi, fi, atol=1e-7)


def test_gather_falls_back_to_numpy_without_the_library(monkeypatch):
    ds = tu8.U8Dataset.from_float(_tiny())
    idx = np.array([5, 1, 90])
    want = ds.gather(idx)
    monkeypatch.setattr(native, "load_library", lambda: None)
    got = ds.gather(idx)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_u8_dataset_refuses_float_images():
    with pytest.raises(TypeError, match="uint8"):
        tu8.U8Dataset(np.zeros((2, 3), np.float32), np.zeros(2, np.int32))


# --- CIFAR-10 and the synthetic image sets ---------------------------------------

def _cifar_bin(rng, n):
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    images = rng.integers(0, 256, (n, 3 * 32 * 32), dtype=np.uint8)
    return np.concatenate([labels[:, None], images], 1).tobytes()


def test_cifar_parse_equals_jax():
    raw = _cifar_bin(np.random.default_rng(0), 7)
    got, want = tcifar.parse_cifar_batch(raw), jcifar.parse_cifar_batch(raw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[0].shape == (7, 32, 32, 3)
    for mod in (tcifar, jcifar):
        with pytest.raises(ValueError, match="not a multiple of record"):
            mod.parse_cifar_batch(raw[:-1])


def test_cifar_loader_equals_jax_and_refuses_a_partial_copy(tmp_path):
    rng = np.random.default_rng(1)
    base = tmp_path / "cifar-10-batches-bin"
    base.mkdir()
    for i in range(1, 6):
        (base / f"data_batch_{i}.bin").write_bytes(_cifar_bin(rng, 20))
    (base / "test_batch.bin").write_bytes(_cifar_bin(rng, 10))
    got = tcifar.load_cifar10(str(tmp_path), validation_size=30)
    want = jcifar.load_cifar10(str(tmp_path), validation_size=30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.name == w.name == "cifar10"
    assert len(got[0]) == 70
    train, _, _ = tmnist.load_dataset("cifar10", str(tmp_path), 0, 30)
    np.testing.assert_array_equal(train.images, want[0].images)
    (base / "data_batch_3.bin").unlink()
    for mod in (tcifar, jcifar):
        with pytest.raises(ValueError, match="incomplete"):
            mod.load_cifar10(str(tmp_path))


def test_missing_cifar_falls_back_to_the_synthetic_twin(tmp_path, capsys):
    train, val, _ = tmnist.load_dataset("cifar10", str(tmp_path), seed=2,
                                        validation_size=5000)
    assert "falling back to synthetic cifar10" in capsys.readouterr().out
    want = jcifar.synthetic_cifar10(seed=2, validation_size=1000)
    np.testing.assert_array_equal(train.images, want[0].images)
    assert len(val) == 1000


@pytest.mark.parametrize("which", ["cifar10", "imagenet"])
def test_synthetic_images_equal_jax(which):
    if which == "cifar10":
        got = tcifar.synthetic_cifar10(n_train=64, n_test=16,
                                       validation_size=16, seed=4)
        want = jcifar.synthetic_cifar10(n_train=64, n_test=16,
                                        validation_size=16, seed=4)
    else:
        got = tcifar.synthetic_imagenet(n_train=8, n_test=4,
                                        validation_size=4, seed=4,
                                        image_size=50, num_classes=7)
        want = jcifar.synthetic_imagenet(n_train=8, n_test=4,
                                         validation_size=4, seed=4,
                                         image_size=50, num_classes=7)
    for g, w in zip(got, want):
        assert g.images.dtype == np.float32
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.name == w.name


def test_load_dataset_dispatches_every_vision_set(monkeypatch):
    """cifar10_synthetic loads JAX's set; imagenet_synthetic (2,560
    images of 224 x 224 x 3 f32, 1.5 GB) is checked for its dispatch and
    defaults only."""
    train, _, _ = tmnist.load_dataset("cifar10_synthetic", "/nonexistent",
                                      seed=1)
    assert train.images.shape[1:] == (32, 32, 3)
    assert train.name == "cifar10_synthetic" and len(train) == 7000
    calls = []
    monkeypatch.setattr(tcifar, "synthetic_imagenet",
                        lambda **kw: calls.append(kw) or "imagenet")
    assert tmnist.load_dataset("imagenet_synthetic", "/x", seed=3) == (
        "imagenet")
    assert calls == [{"seed": 3}]


# --- the CNN under u8_native -------------------------------------------------------

CNN = dict(model="mnist_cnn", dataset="mnist", data_dir=FIXTURE_DIR,
           validation_size=64, batch_size=64, train_steps=5, eval_every=0,
           log_every=1, eval_batch_size=64, compute_dtype="float32",
           dropout_rate=0.0, learning_rate=2e-3, seed=0,
           data_backend="u8_native")


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def test_cnn_under_u8_native_follows_jax_and_the_numpy_backend():
    jcfg = JaxConfig(**CNN)
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    import jax

    init = interop.params_from_flax(jax.device_get(jstate.params))
    runs = {}
    for backend in ("u8_native", "numpy"):
        runs[backend] = tloop.train(
            TrainConfig(**dict(CNN, data_backend=backend), device="cpu"),
            logger=MetricLogger(enabled=False), init_params=init)
    np.testing.assert_allclose(_losses(runs["u8_native"].logger),
                               _losses(jres.logger), rtol=1e-4)
    np.testing.assert_allclose(_losses(runs["u8_native"].logger),
                               _losses(runs["numpy"].logger), rtol=1e-5)
    assert native.loaded_path() is not None
