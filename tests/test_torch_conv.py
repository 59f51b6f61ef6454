"""The port's direct 3x3 conv entry points (kernel K4's wrappers) on the
CPU, where they take the plain version, against the JAX package's Pallas
kernel in interpret mode.

The shapes of ``tests/test_pallas_conv.py``, both entry points, f32 within
1e-5 of max|ref| (both sum in f32, in other orders) and bf16 within 2^-7 of
max|ref| (one bf16 step of the largest output, for an element whose f32 sums
straddle a rounding boundary).  b ~ 0.5 in the GroupNorm fold, so a halo
computed as silu(b) in place of 0 would show (by ~1.6 at 8x8x128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops import pallas_conv as J
from diff_sampler_tpu_torch.ops import conv as C

SHAPES = [(2, 8, 8, 128, 128), (3, 4, 4, 128, 256), (1, 8, 4, 256, 128)]
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    a = (1 + 0.1 * rng.randn(n, cin)).astype(np.float32)
    b = (0.5 + 0.1 * rng.randn(n, cin)).astype(np.float32)
    return x, wt, bias, a, b


def _check(ours, ref, dtype):
    ref = np.asarray(ref.astype(jnp.float32))
    ours = ours.float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
def test_conv3x3_matches_jax_interpret(n, h, w, cin, cout, dtype):
    x, wt, bias, _, _ = _inputs(n, h, w, cin, cout)
    ref = J.conv3x3(jnp.asarray(x).astype(dtype), jnp.asarray(wt), jnp.asarray(bias),
                    interpret=True)
    ours = C.conv3x3(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(wt),
                     torch.from_numpy(bias))
    assert ours.dtype == getattr(torch, dtype)
    _check(ours, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
def test_gn_silu_conv3x3_matches_jax_interpret(n, h, w, cin, cout, dtype):
    x, wt, bias, a, b = _inputs(n, h, w, cin, cout, seed=1)
    ref = J.gn_silu_conv3x3(jnp.asarray(x).astype(dtype), jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(wt), jnp.asarray(bias), interpret=True)
    ours = C.gn_silu_conv3x3(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(a),
                             torch.from_numpy(b), torch.from_numpy(wt), torch.from_numpy(bias))
    _check(ours, ref, dtype)


def test_halo_is_zero_after_the_prologue():
    """Padding before the prologue (silu(b) at the border) moves the output
    far past the tolerance; the port's plain version agrees with the JAX
    kernel, whose padded scratch is zero."""
    x, wt, _, a, b = _inputs(2, 8, 8, 128, 128, seed=2)
    ref = np.asarray(J.gn_silu_conv3x3(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(wt), interpret=True))
    ours = C.gn_silu_conv3x3(*(torch.from_numpy(v) for v in (x, a, b, wt))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    wrong = C.gn_silu_conv3x3(*(torch.from_numpy(v) for v in (xp, a, b, wt))).numpy()[:, 1:-1, 1:-1]
    assert np.abs(wrong - ref).max() > 100 * 1e-5 * np.abs(ref).max()


def test_supported_holds_wherever_jax_holds():
    for n, h, w in [(1, 1, 1), (5, 8, 8), (3, 7, 5), (256, 32, 32)]:
        for cin in (8, 96, 128, 256, 384):
            for cout in (8, 96, 128, 256, 384):
                if J.supported(n, h, w, cin, cout):
                    assert C.supported(n, h, w, cin, cout)
    assert C.supported(3, 7, 5, 128, 384) and C.supported(2, 4, 4, 24, 40)
    assert not C.supported(2, 8, 8, 12, 128) and not C.supported(2, 8, 8, 128, 100)
    assert not C.supported(0, 8, 8, 128, 128)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, wt, bias, a, b = (torch.from_numpy(v) for v in _inputs(1, 4, 4, 128, 128, seed=3))
    before = C.conv3x3.launches
    assert torch.equal(C.conv3x3(x, wt, bias), C.reference_conv3x3(x, wt, bias))
    assert torch.equal(C.gn_silu_conv3x3(x, a, b, wt, bias),
                       C.reference_conv3x3(x, wt, bias, a, b))
    assert C.conv3x3.launches == before
