"""PyTorch port: the MNIST data path against the JAX package's.

The idx parser and loader on the committed fixture (its train files are
gzipped, its test files raw), the synthetic digits and the sharded
batcher's rows equal the JAX package's arrays exactly; the fall-back to
the synthetic digits warns and names its split; the prefetcher hands
over the batches of its source unchanged.
"""

import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.data import mnist as jmnist
from tensorflow_distributed_tpu_torch.data import mnist as tmnist
from tensorflow_distributed_tpu_torch.data.prefetch import (
    map_batch, prefetch, to_device)
from tests.conftest import FIXTURE_DIR


def _assert_split_equal(got, want):
    assert got.name == want.name
    for field in ("images", "labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("fname", ["train-images-idx3-ubyte.gz",
                                   "train-labels-idx1-ubyte.gz",
                                   "t10k-images-idx3-ubyte",
                                   "t10k-labels-idx1-ubyte"])
def test_parse_idx_equals_jax(fname):
    import gzip

    opener = gzip.open if fname.endswith(".gz") else open
    with opener(f"{FIXTURE_DIR}/{fname}", "rb") as f:
        raw = f.read()
    got, want = tmnist.parse_idx(raw), jmnist.parse_idx(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("raw,match", [(b"\x00\x00", "truncated"),
                                       (b"\x00\x00\x08\x02\x00\x00\x00\x01",
                                        "magic")])
def test_parse_idx_refuses_what_jax_refuses(raw, match):
    for parse in (tmnist.parse_idx, jmnist.parse_idx):
        with pytest.raises(ValueError, match=match):
            parse(raw)


def test_load_mnist_equals_jax_on_the_fixture():
    got = tmnist.load_mnist(FIXTURE_DIR, validation_size=64)
    want = jmnist.load_mnist(FIXTURE_DIR, validation_size=64)
    assert [len(s) for s in got] == [960, 64, 256]
    for g, w in zip(got, want):
        _assert_split_equal(g, w)


def test_synthetic_mnist_equals_jax():
    kw = dict(n_train=300, n_test=40, validation_size=50, seed=7)
    for g, w in zip(tmnist.synthetic_mnist(**kw),
                    jmnist.synthetic_mnist(**kw)):
        _assert_split_equal(g, w)


@pytest.mark.parametrize("dataset", ["mnist", "synthetic"])
def test_load_dataset_equals_jax(dataset):
    got = tmnist.load_dataset(dataset, FIXTURE_DIR, seed=0,
                              validation_size=64)
    want = jmnist.load_dataset(dataset, FIXTURE_DIR, seed=0,
                               validation_size=64)
    for g, w in zip(got, want):
        _assert_split_equal(g, w)


def test_missing_files_fall_back_to_synthetic_with_a_warning(tmp_path,
                                                             capsys):
    train, val, _ = tmnist.load_dataset("mnist", str(tmp_path), seed=3,
                                        validation_size=64)
    assert "falling back to synthetic digits" in capsys.readouterr().out
    assert train.name == val.name == "synthetic" and len(val) == 64
    want, _, _ = jmnist.synthetic_mnist(seed=3, validation_size=64)
    np.testing.assert_array_equal(train.images, want.images)


def test_unported_dataset_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmnist.load_dataset("cifar10", FIXTURE_DIR)


@pytest.mark.parametrize("procs,index", [(1, 0), (2, 1), (4, 3)])
def test_sharded_batcher_rows_equal_jax(procs, index):
    ds = tmnist.load_mnist(FIXTURE_DIR, validation_size=64)[0]
    jds = jmnist.load_mnist(FIXTURE_DIR, validation_size=64)[0]
    got = tmnist.ShardedBatcher(ds, 64, seed=5, num_processes=procs,
                                process_index=index).forever(12)
    want = jmnist.ShardedBatcher(jds, 64, seed=5, num_processes=procs,
                                 process_index=index).forever(12)
    for _ in range(5):  # crosses the epoch boundary (15 steps an epoch)
        (gi, gl), (wi, wl) = next(got), next(want)
        assert gi.shape == (64 // procs, 28, 28, 1)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_yields_the_source_batches(size):
    rng = np.random.default_rng(0)
    source = [(rng.random((4, 28, 28, 1)).astype(np.float32),
               rng.integers(0, 10, 4).astype(np.int32)) for _ in range(3)]
    source.append({"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)})
    got = list(prefetch(iter(source), torch.device("cpu"), size=size))
    assert len(got) == len(source)
    for g, w in zip(got, source):
        assert type(g) is type(w)
        flat_g = list(g.values()) if isinstance(g, dict) else list(g)
        flat_w = list(w.values()) if isinstance(w, dict) else list(w)
        for a, b in zip(flat_g, flat_w):
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(a.numpy(), b)


def test_prefetch_reads_ahead_by_size():
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield {"x": np.full((1,), i)}

    it = prefetch(source(), torch.device("cpu"), size=3)
    first = next(it)
    assert int(first["x"]) == 0 and pulled == [0, 1, 2, 3]
    assert [int(b["x"]) for b in it] == [1, 2, 3, 4, 5]


def test_to_device_and_map_batch_keep_the_structure():
    batch = (np.ones((2, 3), np.float32), np.arange(2))
    out = to_device(batch, torch.device("cpu"))
    assert isinstance(out, tuple) and out[0].shape == (2, 3)
    halves = map_batch(lambda t: t[:1], {"a": out[0], "b": out[1]})
    assert set(halves) == {"a", "b"} and halves["b"].tolist() == [0]
