"""The port's attention at head dims below 128, where the JAX package takes
its packed Pallas kernels (``_attn_kernel_mh_packed``,
``_bwd_dq_kernel_mh_packed`` / ``_bwd_dkv_kernel_mh_packed``: 128 // d
heads per block), against those kernels run in interpret mode on the CPU
(as tests/test_pallas.py runs them).  The port computes the same function
one head per block with kernels K1 and K2, so on the CPU these are K1's and
K2's plain versions.

Cases: d=64 with H=2 and H=3 (a last group of one head under pack 2), d=32
with H=4 (pack 4) and H=5, and a ragged T.  f32; forward 1e-5 max abs on out
and lse; backward rtol 1e-3 and atol 1e-4, the bar of
tests/test_torch_attention_bwd.py.  The CUDA kernels themselves are checked
on the card by tests/test_torch_kernels_cuda.py and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops import pallas_attention as PA
from diff_sampler_tpu_torch.ops import attention as A

# (B, T, H, d)
FWD_SHAPES = [(2, 128, 2, 64), (2, 128, 3, 64), (2, 128, 4, 32), (2, 200, 3, 64),
              (1, 72, 5, 32)]
BWD_SHAPES = [(2, 128, 3, 64), (1, 200, 5, 32)]


def _qkv(b, t, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _flat(a):
    b, t, h, d = a.shape
    return jnp.asarray(a.reshape(b, t, h * d))


def test_k1_takes_every_head_dim_the_jax_package_packs():
    packed = [d for d in range(8, A.MAX_HEAD_DIM + 1, 8) if PA._pack_factor(d) > 1]
    assert packed == list(range(8, 72, 8))  # 32, 40 and 64 among them
    assert all(A.supports_head_dim(d) for d in packed)


@pytest.mark.parametrize("b,t,h,d", FWD_SHAPES)
def test_packed_forward_matches_pallas_packed_kernel_interpret(b, t, h, d):
    q, k, v = _qkv(b, t, h, d, seed=0)
    scale = d ** -0.5
    pack = PA._pack_factor(d)
    assert pack > 1  # the JAX launcher takes _attn_kernel_mh_packed
    # block_k=128 gives the JAX kernel more than one key tile where T > 128
    j_out, j_lse = PA._flash_fwd_mh_res(_flat(q), _flat(k), _flat(v), h, scale, block_k=128,
                                        interpret=True, pack=pack)
    before = A.flash_attention_mh.launches
    out, lse = A.flash_attention_mh(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert A.flash_attention_mh.launches == before  # a CPU tensor launches nothing
    assert out.shape == (b, t, h, d) and lse.shape == (b, h, t)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out).reshape(b, t, h, d),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, :t], rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,t,h,d", BWD_SHAPES)
def test_packed_backward_matches_pallas_packed_kernels_interpret(b, t, h, d, monkeypatch):
    q, k, v = _qkv(b, t, h, d, seed=1)
    q, k, v = (a * 0.5 for a in (q, k, v))
    cot = np.random.RandomState(2).randn(b, t, h, d).astype(np.float32)
    scale = float(d ** -0.5)
    pack = PA._pack_factor(d)
    used = []
    for name in ("_bwd_dq_kernel_mh_packed", "_bwd_dkv_kernel_mh_packed"):
        real = getattr(PA, name)

        def spy(*a, _real=real, _name=name, **kw):
            used.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(PA, name, spy)
    j_out, j_lse = PA._flash_fwd_mh_res(_flat(q), _flat(k), _flat(v), h, scale,
                                        interpret=True, pack=pack)
    want = PA._flash_bwd_mh(_flat(q), _flat(k), _flat(v), j_out, j_lse, _flat(cot), h, scale,
                            interpret=True, out_shape=(b, t, h, d))
    assert set(used) == {"_bwd_dq_kernel_mh_packed", "_bwd_dkv_kernel_mh_packed"}
    qt, kt, vt, ct = (torch.from_numpy(a) for a in (q, k, v, cot))
    out, lse = A.flash_attention_mh(qt, kt, vt, scale)
    got = A.flash_attention_mh_bwd(qt, kt, vt, out, lse, ct, scale)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4,
                                   err_msg=f"d{name}")


def test_sdpa_at_d64_takes_k1_and_k2_on_the_cpu_without_launching():
    """sdpa's forward and backward at d=64 go through K1's and K2's entry
    points (their plain versions on a CPU tensor, which count no launch) and
    agree with autograd through the plain forward."""
    calls = []
    real = (A.flash_attention_mh, A.flash_attention_mh_bwd)
    counters = (A.flash_attention_mh, A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    try:
        A.flash_attention_mh = lambda *a: calls.append("fwd") or real[0](*a)
        A.flash_attention_mh_bwd = lambda *a: calls.append("bwd") or real[1](*a)
        leaves = [torch.from_numpy(a).requires_grad_() for a in _qkv(1, 64, 3, 64, seed=3)]
        cot = torch.from_numpy(np.random.RandomState(4).randn(1, 64, 3, 64).astype(np.float32))
        got = torch.autograd.grad((A.sdpa(*leaves) * cot).sum(), leaves)
    finally:
        A.flash_attention_mh, A.flash_attention_mh_bwd = real
    assert calls == ["fwd", "bwd"]
    assert [c.launches for c in counters] == before
    out, _ = A.reference_sdpa(*leaves, 64 ** -0.5)
    want = torch.autograd.grad((out * cot).sum(), leaves)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-3, atol=1e-4)


def test_wrappers_at_d64_raise_on_other_devices():
    q = torch.empty(1, 64, 2, 64, device="meta")
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        A.flash_attention_mh(q, q, q, 0.125)
    with pytest.raises(ValueError, match="no attention kernel"):
        A.flash_attention_mh_bwd(q, q, q, q, lse, q, 0.125)
