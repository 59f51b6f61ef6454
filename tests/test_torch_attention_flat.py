"""The port's flat-layout attention (K1c / K2c's plain versions) and its
route, against the JAX package's.

``flash_attention`` on a CPU tensor takes ``reference_flash_attention``, the
plain version of kernel K1c; ``flash_attention_bwd`` takes K2c's plain
versions.  They are held against the JAX package's ``flash_attention`` (the
Pallas ``_attn_kernel`` in interpret mode, as tests/test_pallas.py runs it)
and its VJP with ``_FLASH_BWD_MIN_LOGITS_BYTES`` at 0, so that the Pallas
``_flash_bwd`` (``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``) runs, at Stable
Diffusion's head dims 40 and 80 and ragged T (77 context-sized tokens, 200).
``reference_sdpa`` is held against the JAX ``sdpa`` at d = 40 / 80 / 160.
The route test holds ``takes_flat_kernel`` against the JAX dispatcher's
planners (``_mh_plan`` / ``_fits_vmem``, read here only) at every attention
shape of the ported tiers.  The CUDA kernels themselves are checked on the
card by tests/test_torch_kernels_cuda.py and ``chip_smoke.py``.

Tolerances: f32 outputs and lse 1e-5 max abs; f32 gradients 1e-5 * max|grad|
(both sides sum the same f32 products in other orders); bf16 2^-5 *
max|out| for outputs (the Pallas kernel rounds the unnormalised softmax
weights to bf16 and divides after the product, the plain version rounds the
normalised ones: a few bf16 steps of the largest output) and 2^-5 *
max|grad| for gradients (P and dS rounded to bf16 on both sides, from f32
values that differ in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops import pallas_attention as PA
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.ops import attention as A

FLAT = [(3, 77, 40), (2, 200, 40), (2, 77, 80), (2, 200, 80)]  # (B, T, d)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _both(arrays, dtype):
    dt_t, dt_j = DTYPES[dtype]
    return ([torch.from_numpy(a).to(dt_t) for a in arrays],
            [jnp.asarray(a).astype(dt_j) for a in arrays])


def _err(got, want):
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


def _tol(dtype, want, f32):
    return (f32 if dtype == "float32" else 2.0 ** -5) * float(np.abs(np.asarray(
        want, np.float32)).max())


@pytest.mark.parametrize("b,t,d", FLAT)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flat_forward_matches_pallas_flat_kernel_interpret(b, t, d, dtype):
    (q, k, v, _), (qj, kj, vj, _) = _both(_inputs((b, t, d), seed=t + d), dtype)
    scale = d ** -0.5
    # block_k=128 gives the JAX kernel more than one key tile where T > 128
    j_out, j_lse = PA._flash_fwd_res(qj, kj, vj, scale, block_q=128, block_k=128,
                                     interpret=True)
    before = A.flash_attention.launches
    out, lse = A.flash_attention(q, k, v, scale)
    assert A.flash_attention.launches == before  # a CPU tensor launches nothing
    assert out.shape == (b, t, d) and out.dtype == q.dtype and lse.shape == (b, t)
    assert _err(out, j_out) <= (1e-5 if dtype == "float32" else _tol(dtype, j_out, 0))
    assert _err(lse, np.asarray(j_lse)[:, 0, :t]) <= 1e-5


@pytest.mark.parametrize("b,t,d", FLAT)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flat_backward_matches_pallas_flash_bwd_interpret(b, t, d, dtype, monkeypatch):
    monkeypatch.setattr(PA, "_FLASH_BWD_MIN_LOGITS_BYTES", 0)
    used = {}
    real = PA._flash_bwd

    def spy(*a, **kw):
        used["flash"] = True
        return real(*a, **kw)

    monkeypatch.setattr(PA, "_flash_bwd", spy)
    arrays = _inputs((b, t, d), seed=2 * t + d)
    arrays[:3] = [a * 0.5 for a in arrays[:3]]
    (q, k, v, cot), (qj, kj, vj, cj) = _both(arrays, dtype)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda *a: PA.flash_attention(*a, scale, True), qj, kj, vj)
    want = vjp(cj)
    assert used.get("flash"), "the JAX flat flash backward was not dispatched"
    out, lse = A.flash_attention(q, k, v, scale)
    before = (A.flash_attention_flat_bwd_dq.launches, A.flash_attention_flat_bwd_dkv.launches)
    got = A.flash_attention_bwd(q, k, v, out, lse, cot, scale)
    assert (A.flash_attention_flat_bwd_dq.launches,
            A.flash_attention_flat_bwd_dkv.launches) == before
    for name, x, y in zip("qkv", got, want):
        assert x.shape == (b, t, d) and x.dtype == q.dtype
        assert _err(x, y) <= _tol(dtype, y, 1e-5), f"d{name}"


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reference_sdpa_matches_jax_sdpa_at_sd_head_dims(d, dtype):
    (q, k, v, _), (qj, kj, vj, _) = _both(_inputs((2, 64, 3, d), seed=d), dtype)
    want = PA.sdpa(qj, kj, vj)  # the einsum path on the CPU
    got, lse = A.reference_sdpa(q, k, v, d ** -0.5)
    assert got.dtype == q.dtype and lse.shape == (2, 3, 64)
    assert _err(got, want) <= (1e-5 if dtype == "float32" else _tol(dtype, want, 0))


def test_flat_function_and_route_give_sdpa_and_its_gradient(monkeypatch):
    """Routed flat (the threshold at 0), ``sdpa`` transposes to [B * H, T, d],
    runs the autograd Function ``_FlashAttention`` and transposes back: its
    output and gradient equal the multi-head route's."""
    rng = np.random.RandomState(5)
    qkv_np = rng.randn(2, 50, 3 * 3 * 40).astype(np.float32)
    cot = torch.from_numpy(rng.randn(2, 50, 3, 40).astype(np.float32))
    results = []
    for flat_bytes in (A._FLAT_ROUTE_BYTES, 0):
        monkeypatch.setattr(A, "_FLAT_ROUTE_BYTES", flat_bytes)
        assert A.takes_flat_kernel(50, 3, 40, torch.float32) == (flat_bytes == 0)
        qkv = torch.from_numpy(qkv_np).requires_grad_()
        q, k, v = (x.reshape(2, 50, 3, 40) for x in qkv.split(120, dim=-1))
        out = A.sdpa(q, k, v)
        assert out.shape == (2, 50, 3, 40) and out.grad_fn is not None
        (out * cot).sum().backward()
        results.append((out.detach(), qkv.grad))
    (out_mh, g_mh), (out_flat, g_flat) = results
    torch.testing.assert_close(out_flat, out_mh, rtol=0, atol=1e-6)
    torch.testing.assert_close(g_flat, g_mh, rtol=0, atol=1e-5 * g_mh.abs().max().item())


def _ported_attention_shapes():
    """(T, H, d) of every self-attention site of the ported tiers: CIFAR-10
    (16x16, one head of 256), ImageNet-64 (heads of 64 at 32/16/8 px), the
    LSUN LDM (heads of 32 at its 32/16/8 latent px) and Stable Diffusion (8
    heads at each of its four latent levels)."""
    shapes = {(256, 1, 256)}
    shapes |= {(s * s, c // 64, 64) for s, c in ((32, 384), (16, 576), (8, 768))}
    shapes |= {(s * s, c // 32, 32) for s, c in ((32, 448), (16, 672), (8, 896))}
    sd = TL.LDM_CONFIGS["ms_coco"]["unet"]
    for level, mult in enumerate(sd["channel_mult"]):
        ch, side = sd["model_channels"] * mult, sd["image_size"] // 2 ** level
        if 2 ** level in sd["attention_resolutions"] or level == len(sd["channel_mult"]) - 1:
            shapes.add((side * side, sd["num_heads"], ch // sd["num_heads"]))
    return sorted(shapes)


def test_route_agrees_with_the_jax_dispatcher_at_every_ported_shape():
    """``takes_flat_kernel`` is True exactly where the JAX ``sdpa`` takes its
    flat kernel: ``_mh_plan`` finds no multi-head plan and ``_fits_vmem``
    passes (``ops/pallas_attention.py:1364-1378``).  Of these shapes only SD's
    f32 64x64 level (T=4096, 8 heads of d=40) does."""
    shapes = _ported_attention_shapes()
    assert (4096, 8, 40) in shapes and (64, 8, 160) in shapes and len(shapes) == 11
    flat = []
    for t, h, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            itemsize = torch.empty((), dtype=dtype).element_size()
            jax_flat = (PA._mh_plan(t, h * d, h, itemsize) is None
                        and PA._fits_vmem(t, (d + 127) // 128 * 128, itemsize))
            jax_mh = PA._mh_plan(t, h * d, h, itemsize) is not None
            assert jax_flat or jax_mh, (t, h, d, dtype)
            assert A.takes_flat_kernel(t, h, d, dtype) == jax_flat, (t, h, d, dtype)
            if jax_flat:
                flat.append((t, h, d, dtype))
    assert flat == [(4096, 8, 40, torch.float32)]
