"""Kernel K1 (the CUDA flash-attention forward) against its plain version,
on the card.

Marked ``cuda``: without a CUDA device each test skips.  The file imports no
jax package module, so it also runs where flax is not installed:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: f32 1e-5 max abs (both sides accumulate in f32, in other
orders); bf16 2^-5, one bf16 step of an output below 4 plus the bf16
rounding of the softmax weights; lse (f32 on both sides) 1e-5.
"""

import pytest
import torch

from diff_sampler_tpu_torch.ops import attention as A

SHAPES = [(2, 64, 1, 32), (2, 256, 1, 256), (2, 200, 2, 64), (3, 100, 3, 128),
          (256, 64, 1, 256)]  # (B, T, H, d)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_interleaved_views(cuda, b, t, h, d, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    qkv = torch.randn(b, t, h * d * 3, generator=g, device="cuda").to(dt)
    q, k, v = qkv.reshape(b, t, h, d, 3).unbind(-1)
    before = A.flash_attention_mh.launches
    out, lse = A.flash_attention_mh(q, k, v, d ** -0.5)
    ref_out, ref_lse = A.reference_sdpa(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert A.flash_attention_mh.launches == before + 1
    tol = 1e-5 if dt == torch.float32 else 2 ** -5
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 64, 1, 40, device="cuda")
    with pytest.raises(ValueError, match="head dim 40"):
        A.flash_attention_mh(q, q, q, 0.1)
