"""PyTorch port: the kernel libraries' build cache key (CPU, no nvcc).

A library is rebuilt when its name's digest changes, so the digest must
cover every file the build reads: the ``.cu`` source, every shared
``.cuh`` header beside it (``hopper.cuh``), and the nvcc flags.
"""

import shutil

import pytest

from tensorflow_distributed_tpu_torch.ops import cuda_ext


@pytest.fixture
def csrc(tmp_path):
    """A copy of the port's csrc/ to edit."""
    dst = tmp_path / "csrc"
    shutil.copytree(cuda_ext.CSRC, dst)
    return dst


def test_digest_is_stable_and_per_library(csrc):
    assert (cuda_ext.source_digest("flash_attention", csrc)
            == cuda_ext.source_digest("flash_attention", csrc))
    assert (cuda_ext.source_digest("flash_attention", csrc)
            != cuda_ext.source_digest("fused_ce", csrc))
    assert (cuda_ext.source_digest("fused_ce", csrc)
            == cuda_ext.source_digest("fused_ce"))


@pytest.mark.parametrize("library", ["flash_attention", "fused_ce"])
def test_digest_changes_when_a_header_changes(csrc, library):
    """An edit to hopper.cuh alone gives both libraries a new name, so
    neither reloads a stale build."""
    assert (csrc / "hopper.cuh").exists()
    before = cuda_ext.source_digest(library, csrc)
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert cuda_ext.source_digest(library, csrc) != before


def test_digest_changes_with_a_new_header_or_the_source(csrc):
    before = cuda_ext.source_digest("fused_ce", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_header = cuda_ext.source_digest("fused_ce", csrc)
    assert with_header != before
    with open(csrc / "fused_ce.cu", "a") as f:
        f.write("\n// edited\n")
    assert cuda_ext.source_digest("fused_ce", csrc) != with_header


def test_digest_covers_the_flags(csrc, monkeypatch):
    before = cuda_ext.source_digest("flash_attention", csrc)
    monkeypatch.setattr(cuda_ext, "NVCC_FLAGS",
                        cuda_ext.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_ext.source_digest("flash_attention", csrc) != before
