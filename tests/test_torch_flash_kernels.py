"""PyTorch port: the flash-attention CUDA kernels against their plain
versions, on the card.

Every test here needs a CUDA GPU and skips without one (the kernels have
no CPU mode; their plain versions are held to the JAX package by
tests/test_torch_flash_attention.py). This file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_flash_kernels.py -m gpu

Tolerances as chip_smoke.py: out max abs error <= 2e-2, lse <= 1e-3,
dQ/dK/dV max abs error / max |reference| <= 2e-2 (the plain version runs
in f32 from the same bf16 inputs).
"""

import pytest
import torch

from tensorflow_distributed_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _check_against_plain(cuda, BH, L, Lk, D, causal, window, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(BH, L, D, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(BH, Lk, D, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    tfa.reset_launch_counts()
    out, lse = tfa.flash_fwd(q, k, v, causal, window)
    dq = tfa.flash_dq(q, k, v, out, lse, do, causal, window)
    dk, dv = tfa.flash_dkv(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert [kern.launches for kern in tfa.KERNELS] == [1, 1, 1]
    f = [t.float() for t in (q, k, v, out, do)]
    ref_o, ref_lse = tfa.flash_attention_reference(f[0], f[1], f[2], causal,
                                                   window)
    assert float((out.float() - ref_o).abs().max()) <= 2e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    refs = (tfa.flash_dq_reference(*f[:4], lse, f[4], causal, window),
            *tfa.flash_dkv_reference(*f[:4], lse, f[4], causal, window))
    for got, ref in zip((dq, dk, dv), refs):
        assert float((got.float() - ref).abs().max()
                     / ref.abs().max()) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 80)])
def test_kernels_match_plain_versions_on_gpu(cuda, D, causal, window):
    _check_against_plain(cuda, 4, 256, 256, D, causal, window, D + window)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,Lk", [(192, 192), (128, 256), (64, 64),
                                  (320, 320), (64, 320)],
                         ids=["L192", "L128_Lk256", "L64", "L320",
                              "L64_Lk320"])
def test_kernels_on_shapes_off_the_forward_tile(cuda, L, Lk, causal):
    """The forward takes 128 keys a tile and the dK/dV kernel 128 keys a
    CTA: L 192, L 320 and L 64 leave a tile's or a CTA's keys past Lk
    (a whole 64-key warpgroup of dK/dV at Lk 320), Lk != L gives the
    key and query loops their own bounds; rows and keys past the end
    read as TMA's zeros and are masked or dropped."""
    _check_against_plain(cuda, 3, L, Lk, 64, causal, 0, L + Lk)


@pytest.mark.gpu
@pytest.mark.parametrize("L,Lk", [(192, 320), (128, 320)],
                         ids=["L192_Lk320", "L128_Lk320"])
def test_window_across_key_ctas_with_lk_not_l(cuda, L, Lk):
    """Window 80 crosses the dK/dV kernel's 128-key CTAs and its 64-key
    warpgroups, with Lk != L. (Lk > L: with L >= Lk + window a query row
    would see no key at all, which no caller asks for.)"""
    _check_against_plain(cuda, 3, L, Lk, 64, True, 80, L * Lk)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [80, 200])
@pytest.mark.parametrize("L,Lk", [(192, 384), (320, 448)],
                         ids=["L192_Lk384", "L320_Lk448"])
def test_dq_band_inside_a_key_tile(cuda, L, Lk, window):
    """The dQ kernel streams keys 128 a tile: with L 192 and 320 the
    causal band ends inside a key tile, windows 80 and 200 start it inside
    one, and Lk > L leaves key tiles past every query row's band."""
    _check_against_plain(cuda, 3, L, Lk, 64, True, window, L + window)


@pytest.mark.gpu
def test_cuda_wrappers_reject_unsupported_inputs(cuda):
    x = torch.zeros(2, 64, 64, device=cuda)  # f32: the kernels take bf16
    with pytest.raises(ValueError, match="not supported"):
        tfa.flash_fwd(x, x, x, True, 0)


@pytest.mark.gpu
def test_attention_on_f32_cuda_inputs_raises(cuda):
    """A supported shape in f32 on the card raises; it is never sent to
    the plain path (the gate checks shapes only, as in the JAX package)."""
    x = torch.zeros(1, 128, 2, 64, device=cuda)
    assert tfa.supported(128, 128, 64)
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="not supported"):
        tfa.attention(x, x, x, causal=True)
    assert [kern.launches for kern in tfa.KERNELS] == [0, 0, 0]


@pytest.mark.gpu
def test_kernels_launch_on_the_tensors_device(cuda):
    """The kernels run on the device of their inputs, not on the current
    device (needs two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, 128, 64, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    with torch.cuda.device(0):
        out, lse = tfa.flash_fwd(q, k, v, True, 0)
    torch.cuda.synchronize(dev)
    assert out.device == dev
    ref_o, ref_lse = tfa.flash_attention_reference(
        q.float(), k.float(), v.float(), True, 0)
    assert float((out.float() - ref_o).abs().max()) <= 2e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3
