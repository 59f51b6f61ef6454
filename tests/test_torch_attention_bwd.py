"""The port's attention backward against the JAX package's.

``reference_sdpa_bwd`` is the plain version of kernel K2 (the CUDA
flash-attention backward).  It is held against the JAX package's native
multi-head flash backward, ``_flash_bwd_mh`` (the Pallas kernels
``_bwd_dq_kernel_mh`` / ``_bwd_dkv_kernel_mh`` and their packed twins at
d < 128), run in interpret mode through ``jax.grad`` of
``flash_attention_mh`` with its logits-bytes threshold at 0, as
tests/test_pallas.py does; and against torch autograd through
``reference_sdpa``.  f32, rtol 1e-3 and atol 1e-4 (the bar
tests/test_pallas.py holds the JAX kernels to).  The CUDA kernels
themselves are checked on the card by tests/test_torch_kernels_cuda.py and
``chip_smoke.py``.

The plain bf16 backward, the card's yardstick for the bf16 kernels, is held
against the JAX Pallas backward in bf16 in interpret mode on the same
seeded inputs rounded to bf16, also on the legacy [B, T, H, 3d] views of
the ADM classifier's attention (d=64, at a small T): within 2^-6 of
max|grad|, the card's bf16 gate, since both round P, dS and the grads to
bf16 from f32 values that differ in the last bits (the JAX forward's lse,
another order of the sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops import pallas_attention as PA
from diff_sampler_tpu_torch.ops import attention as A

SHAPES = [(2, 64, 1, 256), (2, 128, 2, 64), (2, 200, 2, 64)]  # (B, T, H, d); T=200 ragged
# (B, T, H, d, dtype, layout) of the JAX parity test: every shape in f32 and
# bf16, and the ADM classifier's legacy views (4 heads of 64) in bf16
JAX_CASES = ([(*s, "float32", "separate") for s in SHAPES]
             + [(*s, "bfloat16", "separate") for s in SHAPES]
             + [(2, 64, 4, 64, "bfloat16", "legacy")])
JAX_IDS = ["-".join(map(str, c[:4])) + ("" if c[4] == "float32" else "-bf16")
           + ("-legacy" if c[5] == "legacy" else "") for c in JAX_CASES]


def _inputs(b, t, h, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) * 0.5 for _ in range(3))
    return q, k, v, rng.randn(b, t, h, d).astype(np.float32)


def _plain_grads(q, k, v, cot):
    qt, kt, vt, ct = (torch.from_numpy(a) for a in (q, k, v, cot))
    scale = q.shape[-1] ** -0.5
    out, lse = A.reference_sdpa(qt, kt, vt, scale)
    return A.reference_sdpa_bwd(qt, kt, vt, out, lse, ct, scale)


@pytest.mark.parametrize("b,t,h,d,dtype,layout", JAX_CASES, ids=JAX_IDS)
def test_plain_backward_matches_jax_native_flash_backward(b, t, h, d, dtype, layout,
                                                          monkeypatch):
    monkeypatch.setattr(PA, "_FLASH_BWD_MIN_LOGITS_BYTES", 0)
    used = {}
    real = PA._flash_bwd_mh

    def spy(*a, **kw):
        used["native"] = True
        return real(*a, **kw)

    monkeypatch.setattr(PA, "_flash_bwd_mh", spy)
    q, k, v, cot = _inputs(b, t, h, d, seed=0)
    scale = float(d ** -0.5)
    if dtype == "float32":
        c = jnp.asarray(cot)
        want = jax.grad(lambda *a: (PA.flash_attention_mh(*a, scale, True) * c).sum(),
                        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
        assert used.get("native"), "the JAX native mh backward was not dispatched"
        for name, got, ref in zip("qkv", _plain_grads(q, k, v, cot), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4,
                                       err_msg=f"d{name}")
        return
    # bf16: one [B, T, H, 3d] array whose slices are q, k, v (the legacy
    # views), or three arrays
    parts = np.concatenate([q, k, v], axis=-1)
    pj = jnp.asarray(parts, jnp.bfloat16)
    c = jnp.asarray(cot, jnp.bfloat16).astype(jnp.float32)
    want = jax.grad(lambda *a: (PA.flash_attention_mh(*a, scale, True).astype(jnp.float32)
                                * c).sum(), argnums=(0, 1, 2))(
        pj[..., :d], pj[..., d:2 * d], pj[..., 2 * d:])
    assert used.get("native"), "the JAX native mh backward was not dispatched"
    pt = torch.from_numpy(parts).bfloat16()
    if layout == "legacy":
        qt, kt, vt = pt[..., :d], pt[..., d:2 * d], pt[..., 2 * d:]
        assert qt.stride() == (t * h * 3 * d, h * 3 * d, 3 * d, 1)
    else:
        qt, kt, vt = (x.contiguous() for x in (pt[..., :d], pt[..., d:2 * d], pt[..., 2 * d:]))
    out, lse = A.reference_sdpa(qt, kt, vt, scale)
    got = A.reference_sdpa_bwd(qt, kt, vt, out, lse, torch.from_numpy(cot).bfloat16(), scale)
    for name, x, ref in zip("qkv", got, want):
        ref = np.asarray(ref.astype(jnp.float32))
        assert x.dtype == torch.bfloat16
        err = np.abs(x.float().numpy() - ref).max()
        assert err <= 2.0 ** -6 * np.abs(ref).max(), f"d{name}: {err}"


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_plain_backward_matches_torch_autograd(b, t, h, d):
    q, k, v, cot = _inputs(b, t, h, d, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, _ = A.reference_sdpa(*leaves, d ** -0.5)
    want = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for name, got, ref in zip("qkv", _plain_grads(q, k, v, cot), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=f"d{name}")


def test_split_kernels_plain_versions_make_the_backward():
    q, k, v, cot = (torch.from_numpy(a) for a in _inputs(2, 100, 2, 32, seed=2))
    out, lse = A.reference_sdpa(q, k, v, 0.2)
    delta = (cot * out).sum(-1).permute(0, 2, 1).contiguous()
    dq = A.reference_sdpa_bwd_dq(q, k, v, cot, lse, delta, 0.2)
    dk, dv = A.reference_sdpa_bwd_dkv(q, k, v, cot, lse, delta, 0.2)
    for got, ref in zip((dq, dk, dv), A.reference_sdpa_bwd(q, k, v, out, lse, cot, 0.2)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("heads,ch", [(1, 32), (2, 16)])
def test_sdpa_gradient_on_strided_qkv_views(heads, ch):
    """The autograd Function takes the interleaved (head, c, qkv) views of
    the qkv projection and returns their gradients (through the plain
    backward on the CPU); it agrees with autograd through reference_sdpa."""
    rng = np.random.RandomState(3)
    qkv_np = rng.randn(2, 64, heads * ch * 3).astype(np.float32)
    cot = torch.from_numpy(rng.randn(2, 64, heads, ch).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: A.sdpa(q, k, v),
               lambda q, k, v: A.reference_sdpa(q, k, v, ch ** -0.5)[0]):
        qkv = torch.from_numpy(qkv_np).requires_grad_()
        q, k, v = qkv.reshape(2, 64, heads, ch, 3).unbind(-1)
        assert q.stride() != torch.empty(q.shape).stride()
        out = fn(q, k, v)
        assert out.grad_fn is not None
        (out * cot).sum().backward()
        grads.append(qkv.grad)
    assert grads[0] is not None and grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-3, atol=1e-4)


def test_sdpa_under_no_grad_saves_nothing():
    """The autograd Function saves q, k, v, out and lse only where autograd
    records: under no_grad, or on inputs that need no gradient, it packs no
    tensor, so sampling keeps nothing alive."""
    q = torch.randn(1, 64, 1, 32, requires_grad=True)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t, lambda t: t):
        with torch.no_grad():
            out = A.sdpa(q, q, q)
        plain = A.sdpa(q.detach(), q.detach(), q.detach())
        assert not packed
        A.sdpa(q, q, q)
        assert len(packed) == 5
    assert out.grad_fn is None and not out.requires_grad
    assert plain.grad_fn is None
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_cpu_backward_counts_no_kernel_launch():
    q, k, v, cot = (torch.from_numpy(a) for a in _inputs(1, 64, 1, 32, seed=4))
    out, lse = A.flash_attention_mh(q, k, v, 0.125)
    before = (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches)
    got = A.flash_attention_mh_bwd(q, k, v, out, lse, cot, 0.125)
    assert (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches) == before
    for x, y in zip(got, A.reference_sdpa_bwd(q, k, v, out, lse, cot, 0.125)):
        assert torch.equal(x, y)


def test_backward_on_other_devices_raises():
    q = torch.empty(1, 64, 1, 32, device="meta")
    lse = torch.empty(1, 1, 64, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        A.flash_attention_mh_bwd(q, q, q, q, lse, q, 0.125)
