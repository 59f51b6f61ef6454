"""The port's GroupNorm (+ affine) (+ SiLU) against the JAX package's.

On a CPU tensor ``groupnorm_silu`` is its plain version,
``reference_groupnorm_silu`` (kernel K3 runs on the card, where
``tests/test_torch_kernels_cuda.py`` holds it against this plain version).
Here the plain version meets the JAX package's default path ``_jnp_gn`` and
its Pallas kernel ``_pallas_gn`` in interpret mode, across eps 1e-5 / 1e-6,
SiLU on and off, f32 / bf16 and group sizes 7, 21 and 49 (the LSUN LDM
U-Net's 224, 672 and 1568 channels over 32 groups), on a ragged H * W.

Tolerances, relative to max(1, max|JAX out|): f32 1e-5 (f32 sums in other
orders; the Pallas kernel takes the group means through a matmul); bf16 2^-7,
one bf16 step at the largest output, where the two f32 results straddle a
rounding boundary.  Gradients (by x, scale and bias, against ``jax.vjp`` of
``_jnp_gn``) 1e-5 of each one's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops.pallas_groupnorm import _jnp_gn, _pallas_gn
from diff_sampler_tpu_torch.ops import groupnorm as G

GROUPS = 32
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _inputs(c, seed, hw=(3, 5), n=2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, *hw, c) * 3 + 1).astype(np.float32)
    # a different offset per group, so a group mixed up shows
    x += np.repeat(rng.randn(GROUPS), c // GROUPS).astype(np.float32)
    return x, (1 + 0.5 * rng.randn(c)).astype(np.float32), rng.randn(c).astype(np.float32)


def _to(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax_in(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _assert_close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("cg", [7, 21, 49])
def test_plain_version_matches_jnp_gn(cg, eps, silu, dtype):
    x, scale, bias = _inputs(GROUPS * cg, seed=cg)
    want = _jnp_gn(_jax_in(x, dtype), jnp.asarray(scale), jnp.asarray(bias), GROUPS, eps, silu)
    got = G.groupnorm_silu(_to(x, dtype), torch.from_numpy(scale), torch.from_numpy(bias),
                           groups=GROUPS, eps=eps, apply_silu=silu)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)], ids=["silu", "no-silu"])
@pytest.mark.parametrize("cg", [7, 21, 49])
def test_plain_version_matches_the_pallas_kernel_in_interpret_mode(cg, silu, eps, dtype):
    x, scale, bias = _inputs(GROUPS * cg, seed=100 + cg)
    want = _pallas_gn(_jax_in(x, dtype), jnp.asarray(scale), jnp.asarray(bias), GROUPS, eps,
                      silu, interpret=True)
    got = G.reference_groupnorm_silu(_to(x, dtype), torch.from_numpy(scale),
                                     torch.from_numpy(bias), groups=GROUPS, eps=eps,
                                     apply_silu=silu)
    _assert_close(got, want, dtype)


def _vjp_jax(x, scale, bias, g, eps, silu):
    _, vjp = jax.vjp(lambda *a: _jnp_gn(*a, GROUPS, eps, silu), jnp.asarray(x),
                     jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
def test_plain_gradient_matches_jax_vjp(silu):
    x, scale, bias = _inputs(GROUPS * 7, seed=3)
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    out = G.groupnorm_silu(*leaves, groups=GROUPS, eps=1e-6, apply_silu=silu)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip(("x", "scale", "bias"), got, _vjp_jax(x, scale, bias, g, 1e-6, silu)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def test_kernel_function_backward_is_the_plain_vjp(monkeypatch):
    """``_GroupNormK3``'s backward, with its forward's launch replaced by the
    plain version (no card here): the gradient by x alone (a frozen net) and
    by all three equals plain autograd's, bit for bit."""
    monkeypatch.setattr(G, "_launch", lambda x, s, b, groups, eps, silu:
                        G.reference_groupnorm_silu(x, s, b, groups=groups, eps=eps,
                                                   apply_silu=silu))
    x, scale, bias = _inputs(GROUPS * 21, seed=5)
    g = torch.from_numpy(np.random.RandomState(6).randn(*x.shape).astype(np.float32))
    for need in ((True, False, False), (True, True, True)):
        leaves = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((x, scale, bias), need)]
        got = torch.autograd.grad(G._GroupNormK3.apply(*leaves, GROUPS, 1e-5, True),
                                  [t for t in leaves if t.requires_grad], g)
        want = torch.autograd.grad(G.reference_groupnorm_silu(*leaves, groups=GROUPS),
                                   [t for t in leaves if t.requires_grad], g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_tensor_runs_the_plain_version_and_other_devices_raise():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(GROUPS * 7, seed=7))
    before = G.groupnorm_silu.launches
    assert torch.equal(G.groupnorm_silu(x, scale, bias, groups=GROUPS),
                       G.reference_groupnorm_silu(x, scale, bias, groups=GROUPS))
    assert G.groupnorm_silu.launches == before
    meta = torch.empty(2, 3, 5, GROUPS * 7, device="meta")
    with pytest.raises(ValueError, match="no GroupNorm kernel for device meta"):
        G.groupnorm_silu(meta, scale.to("meta"), bias.to("meta"), groups=GROUPS)


@pytest.mark.parametrize("n,hw", [(1, 15), (2, 65536), (16, 65536), (64, 4096), (64, 64),
                                  (8, 1024), (1100, 16)])
def test_stats_rows_cover_the_image_in_multiples_of_16(n, hw):
    rows = G.stats_rows(n, hw)
    chunks = -(-hw // rows)
    assert rows % 16 == 0 and rows >= 16
    assert (chunks - 1) * rows < hw <= chunks * rows
    # the fewest rows, in whole 16s, that split the image into the chunks
    # wanted: ``_STATS_BLOCKS`` blocks over the batch, at most one per 16 rows
    wanted = min(-(-G._STATS_BLOCKS // n), -(-hw // 16))
    assert rows - 16 < -(-hw // wanted) <= rows
