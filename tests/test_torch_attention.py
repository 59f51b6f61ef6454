"""The port's attention against the JAX package's.

The JAX side runs the Pallas multi-head flash kernel in interpret mode on
the CPU (as tests/test_pallas.py does) and its einsum path; the port's side
runs its plain version, which a CPU tensor always takes.  f32, max abs
error <= 1e-5.  The CUDA kernel itself is checked on the card, by
tests/test_torch_kernels_cuda.py and ``chip_smoke.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import layers as jlayers
from diff_sampler_tpu.ops import pallas_attention as PA
from diff_sampler_tpu_torch.models.layers import attention
from diff_sampler_tpu_torch.ops import attention as A

TOL = 1e-5
SHAPES = [(2, 64, 1, 32), (2, 256, 1, 256), (2, 200, 2, 64)]  # (B, T, H, d)


def _qkv(b, t, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_out_and_lse_match_pallas_kernel_interpret(b, t, h, d):
    q, k, v = _qkv(b, t, h, d)
    scale = 1.0 / math.sqrt(d)
    # block_k=128 gives the JAX kernel more than one key tile where T > 128
    j_out, j_lse = PA._flash_fwd_mh_res(
        *(jnp.asarray(a.reshape(b, t, h * d)) for a in (q, k, v)), h, scale,
        block_k=128, interpret=True)
    out, lse = A.flash_attention_mh(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert out.shape == (b, t, h, d) and lse.shape == (b, h, t)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out).reshape(b, t, h, d),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, :t], rtol=0, atol=TOL)


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_sdpa_matches_jax_sdpa(b, t, h, d):
    q, k, v = _qkv(b, t, h, d, seed=1)
    ref = PA.sdpa(*(jnp.asarray(a) for a in (q, k, v)))  # einsum path on the CPU
    ours = A.sdpa(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("heads,ch,res", [(1, 32, 8), (2, 16, 4), (1, 256, 4)])
def test_attention_interleaved_split_matches_jax(heads, ch, res):
    c = heads * ch
    qkv = np.random.RandomState(2).randn(2, res, res, 3 * c).astype(np.float32)
    ref = jlayers.attention(jnp.asarray(qkv), heads)
    ours = attention(torch.from_numpy(qkv), heads)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_cpu_tensor_takes_plain_path_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 1, 32, seed=3))
    before = A.flash_attention_mh.launches
    out, lse = A.flash_attention_mh(q, k, v, 0.125)
    ref_out, ref_lse = A.reference_sdpa(q, k, v, 0.125)
    assert A.flash_attention_mh.launches == before
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_bf16_plain_path_keeps_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(1, 64, 1, 32, seed=4))
    out, lse = A.flash_attention_mh(q, k, v, 0.125)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = A.reference_sdpa(q.float(), k.float(), v.float(), 0.125)[0]
    assert (out.float() - ref).abs().max().item() < 3e-2  # bf16 rounding of P and out


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty(1, 64, 1, 32, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        A.flash_attention_mh(q, q, q, 0.125)
