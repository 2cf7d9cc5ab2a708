"""PyTorch port: ``scripts/torch_kernel_variants.py``'s variant sources,
on the CPU.

The script builds and times its variants only on a card; what it builds
is checked here: each variant is the shipped source with only its group's
tile constants changed, inside the namespace of the kernel it names.
"""

import importlib.util
import os
import re

import pytest
from torch_threads import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_variants",
        os.path.join(REPO, "scripts", "torch_kernel_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


kv = _script()
# group -> (library, namespace, the constants its variants change)
CHANGES = {"dq": ("flash_attention", "hdq", {"BN", "CONSUMERS"}),
           "fwd_partial": ("flash_attention", "hfwd",
                           {"PARTIAL_BN", "PARTIAL_CONSUMERS"}),
           "dq_partial": ("flash_attention", "hdq",
                          {"PARTIAL_BN", "PARTIAL_CONSUMERS"}),
           "dkv_partial": ("flash_attention", "hdkv",
                           {"PARTIAL_BM", "PARTIAL_CONSUMERS"}),
           "ce": ("fused_ce", "hfw", {"STAGES"})}


def _shipped(library):
    with open(os.path.join(kv.CSRC, f"{library}.cu")) as f:
        return f.read()


def test_every_group_is_described():
    assert set(kv.GROUPS) == set(CHANGES)


@pytest.mark.parametrize("group", sorted(CHANGES))
def test_variants_change_only_their_tile_constants(group):
    library, namespace, names = CHANGES[group]
    shipped = _shipped(library).splitlines()
    start = next(i for i, ln in enumerate(shipped)
                 if ln == f"namespace {namespace} {{")
    end = next(i for i, ln in enumerate(shipped)
               if ln == f"}}  // namespace {namespace}")
    got = kv.variant_sources([group])
    assert len(got) == (2 if group == "ce" else 4)
    assert len(set(text for _, text in got.values())) == len(got)
    for tag, (lib, text) in got.items():
        assert lib == library and tag.startswith(f"{group}_")
        lines = text.splitlines()
        assert len(lines) == len(shipped)
        for i, (a, b) in enumerate(zip(shipped, lines)):
            if a != b:
                assert start < i < end, (tag, b)
                assert re.match(r"constexpr int (\w+) = \d+;$", b).group(1) in names


def test_unknown_group_is_refused(capsys):
    assert kv.main(["dq", "nope"]) == 2
    assert "nope" in capsys.readouterr().err
