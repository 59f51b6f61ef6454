"""Kernels K1 (the CUDA flash-attention forward on the tensor cores: bf16,
and f32 in 3xTF32, each checked on every padded width and view layout), K2
(its backward on the tensor cores: bf16, and f32 in 3xTF32, each width and
view layout), K1c and K2c (the same on the flat layout) and K3 (the fused
GroupNorm) against their plain versions, on the card: K1 / K2 at the
CIFAR-10 shapes, at head dims below 128, where they stand in for the JAX
package's packed kernels (K1b, K2p), at ImageNet-64's three attention
levels at a small batch, at the LSUN LDM's 32x32 level on its legacy qkv
views, where the JAX package streams K2b, and at Stable Diffusion's head
dims 40 / 80 / 160, which the kernels pad; K1c
/ K2c at those head dims and ragged T, and the gradient of ``sdpa`` on the
route that takes them; K3 at odd group sizes and ragged H * W, on both of
its routes (the cluster slab at every cluster size, and the streamed
pass); K4 (the
direct 3x3 conv) at aligned, ragged and multi-image-tile shapes through both
entry points, and its bf16 and f32 kernels (wgmma on a TMA-loaded halo tile;
f32 in 3xTF32) at every patch plan, two runs bit-identical, with the f32
kernel's split of w bit-equal to ``split_tf32``; K1 / K2 at the ImageNet-256
classifier's attention pool (T = 65 on new-order views), and the refusal of a
second-order gradient through K2 / K2c (K3's is exact).

Marked ``cuda``: without a CUDA device each test skips.  The file imports no
jax package module, so it also runs where flax is not installed:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: f32 1e-5 max abs (both sides accumulate in f32, in other
orders); bf16 2^-5 * max|plain out| and at most 2^-5, a few bf16 steps of
the largest output (one step is 2^-8 to 2^-7 of it) for the rounding of the
output and of the softmax weights; lse (f32 on both sides) 1e-5.  K2, relative
to max|plain grad|: f32 1e-4 (at T = 1, where dq and dk are zero in exact
arithmetic, relative to the call's largest plain grad); bf16 2^-6 (both
sides round P, dS and the grads to bf16 from f32 values that may differ in
the last bit).  K4,
relative to max|plain out|: f32 1e-5 (both sum in f32, in other orders; the
kernel's 3xTF32 products lose ~2^-22 each); bf16 2^-7, one bf16 step of the
largest output for an element whose f32 sums straddle a rounding boundary.
"""

import pytest
import torch

from diff_sampler_tpu_torch.ops import attention as A
from diff_sampler_tpu_torch.ops import conv as C
from diff_sampler_tpu_torch.ops import groupnorm as G

# (B, T, H, d): the CIFAR-10 shapes and others, then ImageNet-64's levels at
# a small batch, d=32 with 5 heads and a ragged T at d=64
SHAPES = [(2, 64, 1, 32), (2, 256, 1, 256), (2, 200, 2, 64), (3, 100, 3, 128),
          (256, 64, 1, 256), (2, 1024, 6, 64), (3, 256, 9, 64), (4, 64, 12, 64),
          (2, 100, 5, 32), (2, 200, 3, 64),
          # Stable Diffusion's head dims (padded inside the kernels to 48, 80,
          # 160) at its 32x32 / 16x16 / 8x8 levels and ragged T, and d=8
          (2, 1024, 8, 80), (2, 256, 8, 160), (2, 64, 8, 160), (2, 77, 3, 40), (2, 130, 2, 8)]


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
    tol = 1e-5 if dt == torch.float32 else 2 ** -5 * min(1.0, ref_out.float().abs().max().item())
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-5


# bf16 K1, the tensor-core kernel: every padded width, T around the 64-key
# and 128-query tiles, on the tiers' three view layouts and an unaligned slice
TC_DIMS = [8, 16, 32, 40, 64, 80, 128, 160, 256]
TC_TS = [1, 63, 64, 65, 200, 1024]
TC_LAYOUTS = ["interleaved", "legacy", "separate", "unaligned"]


def _tc_views(layout, b, t, h, d, g, dtype=torch.bfloat16):
    """q, k, v as SongUNet / DhariwalUNet (the interleaved (head, c, qkv)
    split), the LDM (the legacy [N, T, heads, 3 ch] split) and SD (separate
    contiguous projections) hand them to sdpa, or contiguous views whose base
    lies one element past 16 bytes."""
    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    if layout == "interleaved":
        return randn(b, t, h * d * 3).reshape(b, t, h, d, 3).unbind(-1)
    if layout == "legacy":
        parts = randn(b, t, h, 3 * d)
        return parts[..., :d], parts[..., d:2 * d], parts[..., 2 * d:]
    if layout == "separate":
        return [randn(b, t, h * d).reshape(b, t, h, d) for _ in range(3)]
    return [randn(b * t * h * d + 1)[1:].reshape(b, t, h, d) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", TC_LAYOUTS)
@pytest.mark.parametrize("d", TC_DIMS)
def test_bf16_tensor_core_kernel_matches_plain_and_is_deterministic(cuda, layout, d):
    g = torch.Generator("cuda").manual_seed(d)
    for t in TC_TS:
        q, k, v = _tc_views(layout, 2, t, 3, d, g)
        route = A.fwd_route(q, k, v)
        assert route.kernel == "tensor_cores"
        if layout in ("legacy", "separate"):
            assert (route.load, route.span) == ("cp_async", False)
        else:
            span = layout == "interleaved" and route.padded_d in (32, 64, 128, 256)
            assert (route.load, route.span) == ("gather", span)
        before = A.flash_attention_mh.launches
        out, lse = A.flash_attention_mh(q, k, v, d ** -0.5)
        again = A.flash_attention_mh(q, k, v, d ** -0.5)
        ref_out, ref_lse = A.reference_sdpa(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        assert A.flash_attention_mh.launches == before + 2
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        tol = 2 ** -5 * min(1.0, ref_out.float().abs().max().item())
        assert (out.float() - ref_out.float()).abs().max().item() <= tol, (layout, d, t)
        assert (lse - ref_lse).abs().max().item() <= 1e-5, (layout, d, t)


# f32 K1, the 3xTF32 kernel: the same widths, T and layouts
@pytest.mark.cuda
@pytest.mark.parametrize("layout", TC_LAYOUTS)
@pytest.mark.parametrize("d", TC_DIMS)
def test_f32_tensor_core_kernel_matches_plain_and_is_deterministic(cuda, layout, d):
    g = torch.Generator("cuda").manual_seed(d)
    for t in TC_TS:
        q, k, v = _tc_views(layout, 2, t, 3, d, g, torch.float32)
        route = A.fwd_route(q, k, v)
        assert route.kernel == "tensor_cores_3xtf32"
        if layout in ("legacy", "separate"):
            assert (route.load, route.span) == ("cp_async", False)
        else:
            span = layout == "interleaved" and route.padded_d in (32, 64)
            assert (route.load, route.span) == ("gather", span)
        before = A.flash_attention_mh.launches
        out, lse = A.flash_attention_mh(q, k, v, d ** -0.5)
        again = A.flash_attention_mh(q, k, v, d ** -0.5)
        ref_out, ref_lse = A.reference_sdpa(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        assert A.flash_attention_mh.launches == before + 2
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert (out - ref_out).abs().max().item() <= 1e-5, (layout, d, t)
        assert (lse - ref_lse).abs().max().item() <= 1e-5, (layout, d, t)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 4096])
@pytest.mark.parametrize("layout", ["contiguous", "views", "unaligned"])
def test_f32_flat_kernel_matches_plain_and_is_deterministic(cuda, t, layout):
    """K1c in f32 at SD's d=40: contiguous [B * H, T, d] copies (sdpa's
    route), strided views of a [B, T, 3, d] tensor (cp.async) and an
    unaligned slice (the gather)."""
    g = torch.Generator("cuda").manual_seed(t)
    b, d = 6, 40
    if layout == "contiguous":
        q, k, v = (torch.randn(b, t, d, generator=g, device="cuda") for _ in range(3))
    elif layout == "views":
        q, k, v = torch.randn(b, t, 3, d, generator=g, device="cuda").unbind(2)
    else:
        q, k, v = (torch.randn(b * t * d + 1, generator=g, device="cuda")[1:].view(b, t, d)
                   for _ in range(3))
    route = A.fwd_route(q, k, v)
    assert route.kernel == "tensor_cores_3xtf32" and route.padded_d == 40
    assert route.load == ("gather" if layout == "unaligned" else "cp_async")
    before = A.flash_attention.launches
    out, lse = A.flash_attention(q, k, v, d ** -0.5)
    again = A.flash_attention(q, k, v, d ** -0.5)
    ref_out, ref_lse = A.reference_flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert (out - ref_out).abs().max().item() <= 1e-5
    assert (lse - ref_lse).abs().max().item() <= 1e-5


# K2 / K2c on the tensor cores, f32 (3xTF32) and bf16: the same widths, T
# and layouts, a non-contiguous dO.  At T = 1 the one key's softmax weight is
# 1 whatever the logits, so dq and dk are zero in exact arithmetic and both
# sides return rounding noise of dP - delta; there the gate's scale is the
# largest plain gradient of the call (dv = dO) for all three.
def _k2_tol(ref, t, rel=1e-4):
    tops = [y.float().abs().max().item() for y in ref]
    return [rel * (max(tops) if t == 1 else top) for top in tops]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", TC_LAYOUTS)
@pytest.mark.parametrize("d", TC_DIMS)
def test_f32_tensor_core_backward_matches_plain_and_is_deterministic(cuda, layout, d):
    g = torch.Generator("cuda").manual_seed(d)
    for t in TC_TS:
        q, k, v = _tc_views(layout, 2, t, 3, d, g, torch.float32)
        do = torch.randn(2, 3, t, d, generator=g, device="cuda").transpose(1, 2)
        route = A.bwd_route(q, k, v, do)
        aligned = layout in ("legacy", "separate") and route.padded_d <= 160
        load = "cp_async" if aligned else "gather"
        assert (route.kernel, route.load) == ("tensor_cores_3xtf32", load)
        out, lse = A.flash_attention_mh(q, k, v, d ** -0.5)
        before = (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches)
        got = A.flash_attention_mh_bwd(q, k, v, out, lse, do, d ** -0.5)
        again = A.flash_attention_mh_bwd(q, k, v, out, lse, do, d ** -0.5)
        ref = A.reference_sdpa_bwd(q, k, v, out, lse, do, d ** -0.5)
        torch.cuda.synchronize()
        assert (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches) == (
            before[0] + 2, before[1] + 2)
        for name, x, y, z, tol in zip("qkv", got, ref, again, _k2_tol(ref, t)):
            assert (x - y).abs().max().item() <= tol, (layout, d, t, name)
            assert torch.equal(x, z), (layout, d, t, name)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", TC_LAYOUTS)
@pytest.mark.parametrize("d", TC_DIMS)
def test_bf16_tensor_core_backward_matches_plain_and_is_deterministic(cuda, layout, d):
    """bf16 K2 at every padded width and T around its tiles: cp.async on the
    legacy split and separate projections, the qkv rows on the interleaved
    views at padded d 32 / 64 / 128 / 256 (the element gather at the other
    widths), the element gather on the unaligned views and wherever dO is
    the transpose of a [B, d, T] (element stride T)."""
    g = torch.Generator("cuda").manual_seed(d + 100)
    for t in TC_TS:
        q, k, v = _tc_views(layout, 2, t, 3, d, g)
        do = torch.randn(2, 3, t, d, generator=g, device="cuda").bfloat16().transpose(1, 2)
        do_t = torch.randn(2, 3, d, t, generator=g, device="cuda").bfloat16().permute(0, 3, 1, 2)
        route = A.bwd_route(q, k, v, do)
        span = layout == "interleaved" and route.padded_d in (32, 64, 128, 256)
        load = ("cp_async" if layout in ("legacy", "separate") else
                "qkv_span" if span else "gather")
        assert (route.kernel, route.load) == ("tensor_cores", load)
        assert A.bwd_route(q, k, v, do_t).load == "gather"
        out, lse = A.flash_attention_mh(q, k, v, d ** -0.5)
        for dout in (do, do_t):
            before = (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches)
            got = A.flash_attention_mh_bwd(q, k, v, out, lse, dout, d ** -0.5)
            again = A.flash_attention_mh_bwd(q, k, v, out, lse, dout, d ** -0.5)
            ref = A.reference_sdpa_bwd(q, k, v, out, lse, dout, d ** -0.5)
            torch.cuda.synchronize()
            assert (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches) == (
                before[0] + 2, before[1] + 2)
            for name, x, y, z, tol in zip("qkv", got, ref, again, _k2_tol(ref, t, 2 ** -6)):
                assert x.dtype == torch.bfloat16 and x.shape == q.shape
                assert (x.float() - y.float()).abs().max().item() <= tol, (layout, d, t, name)
                assert torch.equal(x, z), (layout, d, t, name)


@pytest.mark.cuda
@pytest.mark.parametrize("d", TC_DIMS)
def test_bf16_flat_backward_matches_plain_and_is_deterministic(cuda, d):
    """bf16 K2c at every padded width, a ragged and a whole T: contiguous
    [B, T, d] copies (cp.async) and a transposed dO (the element gather),
    one launch of each kernel a call."""
    g = torch.Generator("cuda").manual_seed(d + 200)
    counters = (A.flash_attention_flat_bwd_dq, A.flash_attention_flat_bwd_dkv)
    for t in (200, 1024):
        q, k, v = (torch.randn(6, t, d, generator=g, device="cuda").bfloat16() for _ in range(3))
        out, lse = A.flash_attention(q, k, v, d ** -0.5)
        for do in (torch.randn(6, t, d, generator=g, device="cuda").bfloat16(),
                   torch.randn(6, d, t, generator=g, device="cuda").bfloat16().transpose(1, 2)):
            load = "cp_async" if do.is_contiguous() else "gather"
            assert A.bwd_route(q, k, v, do)[:3] == ("tensor_cores", A.bwd_route(
                q, k, v, q).padded_d, load)
            before = [c.launches for c in counters]
            got = A.flash_attention_bwd(q, k, v, out, lse, do, d ** -0.5)
            assert [c.launches - n for c, n in zip(counters, before)] == [1, 1]
            again = A.flash_attention_bwd(q, k, v, out, lse, do, d ** -0.5)
            ref = A.reference_flash_attention_bwd(q, k, v, out, lse, do, d ** -0.5)
            torch.cuda.synchronize()
            for name, x, y, z, tol in zip("qkv", got, ref, again, _k2_tol(ref, t, 2 ** -6)):
                assert (x.float() - y.float()).abs().max().item() <= tol, (d, t, name)
                assert torch.equal(x, z), (d, t, name)


@pytest.mark.cuda
def test_bf16_backward_refuses_a_route_its_tables_do_not_hold(cuda):
    """The bf16 entries check the route they are given: other tiles, the
    qkv rows on views that are not one projection's, or cp.async on an
    unaligned dO are refused with an error; nothing runs in their place."""
    g = torch.Generator("cuda").manual_seed(3)
    q, k, v = _tc_views("legacy", 2, 64, 3, 64, g)
    do = torch.randn(2, 64, 3, 64, generator=g, device="cuda").bfloat16()
    out, lse = A.flash_attention_mh(q, k, v, 0.125)
    delta = A._delta(out, do)
    good = A.bwd_route(q, k, v, do)
    unaligned = torch.randn(do.numel() + 1, generator=g, device="cuda").bfloat16()[1:]
    for bad, dout in ((good._replace(tile_rows=32), do), (good._replace(load="qkv_span"), do),
                      (good, unaligned.view(do.shape))):
        with pytest.raises(RuntimeError, match="backward"):
            A._bwd_launch("flash attention backward (dQ)", (torch.empty_like(q),), q, k, v,
                          dout, lse, delta, 0.125, route=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 4096])
@pytest.mark.parametrize("layout", ["contiguous", "views", "unaligned"])
def test_f32_flat_backward_matches_plain_and_is_deterministic(cuda, t, layout):
    """K2c in f32 at SD's d=40 on the layouts of the K1c test above: the
    3xTF32 flat entries, one launch each; a contiguous dO beside contiguous
    q, k, v takes cp.async, the transpose of a [B, d, T] (element stride
    T) the element gather."""
    g = torch.Generator("cuda").manual_seed(t + 1)
    b, d = 6, 40
    if layout == "contiguous":
        q, k, v = (torch.randn(b, t, d, generator=g, device="cuda") for _ in range(3))
    elif layout == "views":
        q, k, v = torch.randn(b, t, 3, d, generator=g, device="cuda").unbind(2)
    else:
        q, k, v = (torch.randn(b * t * d + 1, generator=g, device="cuda")[1:].view(b, t, d)
                   for _ in range(3))
    if layout == "contiguous":
        do = torch.randn(b, t, d, generator=g, device="cuda")
    else:
        do = torch.randn(b, d, t, generator=g, device="cuda").transpose(1, 2)
    load = "cp_async" if layout == "contiguous" else "gather"
    assert A.bwd_route(q, k, v, do)[:3] == ("tensor_cores_3xtf32", 40, load)
    out, lse = A.flash_attention(q, k, v, d ** -0.5)
    counters = (A.flash_attention_flat_bwd_dq, A.flash_attention_flat_bwd_dkv)
    before = [c.launches for c in counters]
    got = A.flash_attention_bwd(q, k, v, out, lse, do, d ** -0.5)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1]
    again = A.flash_attention_bwd(q, k, v, out, lse, do, d ** -0.5)
    ref = A.reference_flash_attention_bwd(q, k, v, out, lse, do, d ** -0.5)
    torch.cuda.synchronize()
    for name, x, y, z, tol in zip("qkv", got, ref, again, _k2_tol(ref, t)):
        assert (x - y).abs().max().item() <= tol, name
        assert torch.equal(x, z), name


@pytest.mark.cuda
def test_kernel_rejects_unsupported_head_dim(cuda):
    for d in (36, 264):  # not a multiple of 8; past 256
        q = torch.zeros(1, 64, 1, d, device="cuda")
        with pytest.raises(ValueError, match=f"head dim {d}"):
            A.flash_attention_mh(q, q, q, 0.1)
        with pytest.raises(ValueError, match=f"head dim {d}"):
            A.flash_attention(q[:, :, 0], q[:, :, 0], q[:, :, 0], 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_and_is_deterministic(cuda, b, t, h, d, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(1)
    qkv = torch.randn(b, t, h * d * 3, generator=g, device="cuda").to(dt)
    q, k, v = qkv.reshape(b, t, h, d, 3).unbind(-1)
    do = torch.randn(b, h, t, d, generator=g, device="cuda").to(dt).transpose(1, 2)
    out, lse = A.flash_attention_mh(q, k, v, d ** -0.5)
    before = (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches)
    got = A.flash_attention_mh_bwd(q, k, v, out, lse, do, d ** -0.5)
    again = A.flash_attention_mh_bwd(q, k, v, out, lse, do, d ** -0.5)
    ref = A.reference_sdpa_bwd(q, k, v, out, lse, do, d ** -0.5)
    torch.cuda.synchronize()
    assert (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches) == (
        before[0] + 2, before[1] + 2)
    rel = 1e-4 if dt == torch.float32 else 2 ** -6
    for name, x, y, z in zip("qkv", got, ref, again):
        assert x.dtype == dt and x.shape == (b, t, h, d)
        bound = rel * y.float().abs().max().item()
        assert (x.float() - y.float()).abs().max().item() <= bound, name
        assert torch.equal(x, z), name


@pytest.mark.cuda
def test_sdpa_gradient_flows_through_the_kernels(cuda):
    """On a CUDA tensor the gradient of sum(sdpa(q, k, v) * g) reaches q, k
    and v through K2 and equals the plain one."""
    g = torch.Generator("cuda").manual_seed(2)
    leaves = [torch.randn(4, 256, 1, 256, generator=g, device="cuda").requires_grad_()
              for _ in range(3)]
    cot = torch.randn(4, 256, 1, 256, generator=g, device="cuda")
    before = A.flash_attention_bwd_dq.launches
    got = torch.autograd.grad((A.sdpa(*leaves) * cot).sum(), leaves, allow_unused=True)
    assert A.flash_attention_bwd_dq.launches == before + 1
    out, _ = A.reference_sdpa(*leaves, 256 ** -0.5)
    want = torch.autograd.grad((out * cot).sum(), leaves)
    for name, x, y in zip("qkv", got, want):
        assert x is not None, f"no gradient reaches {name}"
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_at_the_k2b_shape_on_legacy_views(cuda, dtype):
    """K2 where the JAX package streams K2b: the LSUN LDM's 32x32 level (T=1024,
    14 heads of d=32) on the legacy qkv layout, q / k / v strided views of
    [B, T, H, 3 * d] (head stride 96, token stride 1344), dO not contiguous."""
    dt = getattr(torch, dtype)
    b, t, h, d = 2, 1024, 14, 32
    g = torch.Generator("cuda").manual_seed(6)
    parts = torch.randn(b, t, h, 3 * d, generator=g, device="cuda").to(dt)
    q, k, v = parts[..., :d], parts[..., d:2 * d], parts[..., 2 * d:]
    assert q.stride() == (t * h * 3 * d, h * 3 * d, 3 * d, 1)
    do = torch.randn(b, h, t, d, generator=g, device="cuda").to(dt).transpose(1, 2)
    out, lse = A.flash_attention_mh(q, k, v, d ** -0.5)
    ref_out, ref_lse = A.reference_sdpa(q, k, v, d ** -0.5)
    tol = 1e-5 if dt == torch.float32 else 2 ** -5 * min(1.0, ref_out.float().abs().max().item())
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-5
    got = A.flash_attention_mh_bwd(q, k, v, out, lse, do, d ** -0.5)
    again = A.flash_attention_mh_bwd(q, k, v, out, lse, do, d ** -0.5)
    ref = A.reference_sdpa_bwd(q, k, v, out, lse, do, d ** -0.5)
    rel = 1e-4 if dt == torch.float32 else 2 ** -6
    for name, x, y, z in zip("qkv", got, ref, again):
        bound = rel * y.float().abs().max().item()
        assert (x.float() - y.float()).abs().max().item() <= bound, name
        assert torch.equal(x, z), name



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_at_the_attention_pool_on_new_order_views(cuda, dtype):
    """K1 and K2 at the ImageNet-256 classifier's attention pool: T = 8 * 8 +
    1 = 65 tokens (ragged against every tile), 8 heads of 64, q / k / v the
    new-order views of one [B, T, 3, H, d] projection (token stride 3Hd),
    dO not contiguous; two backward runs bit-identical."""
    dt = getattr(torch, dtype)
    b, t, h, d = 8, 65, 8, 64
    g = torch.Generator("cuda").manual_seed(7)
    q, k, v = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(dt).reshape(
        b, t, 3, h, d).unbind(2)
    assert q.stride() == (t * 3 * h * d, 3 * h * d, d, 1)
    do = torch.randn(b, h, t, d, generator=g, device="cuda").to(dt).transpose(1, 2)
    out, lse = A.flash_attention_mh(q, k, v, d ** -0.5)
    ref_out, ref_lse = A.reference_sdpa(q, k, v, d ** -0.5)
    tol = 1e-5 if dt == torch.float32 else 2 ** -5 * min(1.0, ref_out.float().abs().max().item())
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-5
    got = A.flash_attention_mh_bwd(q, k, v, out, lse, do, d ** -0.5)
    again = A.flash_attention_mh_bwd(q, k, v, out, lse, do, d ** -0.5)
    ref = A.reference_sdpa_bwd(q, k, v, out, lse, do, d ** -0.5)
    rel = 1e-4 if dt == torch.float32 else 2 ** -6
    for name, x, y, z in zip("qkv", got, ref, again):
        bound = rel * y.float().abs().max().item()
        assert (x.float() - y.float()).abs().max().item() <= bound, name
        assert torch.equal(x, z), name


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True], ids=["K2", "K2c"])
def test_a_second_order_gradient_through_the_kernels_raises(cuda, flat):
    """A backward through K1 / K2 (K1c / K2c) that autograd records for a
    second differentiation raises, naming the kernel, instead of returning
    a gradient without its second-order term; a first-order backward runs.
    On the CPU the same second order is exact (tests/test_torch_adm_tiers.py)."""
    g = torch.Generator("cuda").manual_seed(8)
    shape = (2, 4096, 8, 40) if flat else (2, 256, 2, 64)
    q, k, v = (torch.randn(*shape, generator=g, device="cuda").requires_grad_()
               for _ in range(3))
    assert A.takes_flat_kernel(shape[1], shape[2], shape[3], torch.float32) == flat
    out = A.sdpa(q, k, v)
    first, = torch.autograd.grad(out.square().sum(), q, retain_graph=True)
    assert torch.isfinite(first).all()
    with pytest.raises(RuntimeError, match="second-order gradient through attention kernel "
                                           + ("K2c" if flat else "K2") + ".*JAX package"):
        torch.autograd.grad(out.square().sum(), q, create_graph=True)


@pytest.mark.cuda
def test_groupnorm_second_order_gradient_is_the_plain_ones(cuda):
    """K3's backward is the plain VJP, recorded under ``create_graph``: the
    second derivative through K3 equals the plain version's."""
    x, scale, bias = _gn_inputs(2, 5, 7, 64, torch.float32, seed=9)
    cot = torch.randn_like(x)

    def second(fn):
        xv = x.clone().requires_grad_()
        gx, = torch.autograd.grad((fn(xv, scale, bias, groups=32) * cot).sum(), xv,
                                  create_graph=True)
        return torch.autograd.grad(gx.square().sum(), xv)[0]

    got, want = second(G.groupnorm_silu), second(G.reference_groupnorm_silu)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# GroupNorm (K3) at the group sizes of the LSUN LDM (7, 21, 49 channels per
# group over 32 groups) and of CIFAR-10 (8), on ragged H * W.  Tolerance
# against the plain version, relative to max(1, max|plain out|): f32 1e-5
# (K3's statistics are exact two-pass sums, the plain version's E[x^2] -
# E[x]^2 loses a few f32 ulps of E[x^2]); bf16 2^-7, one bf16 step of the
# largest output for an element whose f32 values straddle a rounding boundary.
# No group here holds fewer than 9 elements: in a group of 2 the plain
# version's E[x^2] - E[x]^2 can cancel to a few bits (6.8e-4 against K3's
# exact sums at [1, 1, 1, 64] on the card).
GN_CASES = [(2, 3, 5, 224), (3, 7, 9, 672), (2, 4, 4, 1568), (2, 33, 31, 256), (1, 3, 1, 96)]
GN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _gn_inputs(n, h, w, c, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g, device="cuda") * 3 + 1
    x = x + torch.randn(32, generator=g, device="cuda").repeat_interleave(c // 32)
    scale = 1 + 0.5 * torch.randn(c, generator=g, device="cuda")
    return x.to(dtype), scale, torch.randn(c, generator=g, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c", GN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)], ids=["silu", "no-silu"])
def test_groupnorm_kernel_matches_plain_and_is_deterministic(cuda, n, h, w, c, dtype, silu, eps):
    dt = getattr(torch, dtype)
    x, scale, bias = _gn_inputs(n, h, w, c, dt, seed=c)
    before = G.groupnorm_silu.launches
    got = G.groupnorm_silu(x, scale, bias, groups=32, eps=eps, apply_silu=silu)
    again = G.groupnorm_silu(x, scale, bias, groups=32, eps=eps, apply_silu=silu)
    ref = G.reference_groupnorm_silu(x, scale, bias, groups=32, eps=eps, apply_silu=silu)
    torch.cuda.synchronize()
    assert G.groupnorm_silu.launches == before + 2
    assert got.dtype == dt and got.shape == x.shape
    bound = GN_TOL[dt] * max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= bound
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_groupnorm_kernel_on_an_unaligned_view(cuda):
    """A tensor whose storage starts 4 bytes in takes the scalar (vec 1)
    kernels, which sum in the vector kernels' order: the same bits, on both
    routes."""
    x, scale, bias = _gn_inputs(2, 5, 5, 224, torch.float32, seed=1)
    flat = torch.empty(x.numel() + 1, device="cuda")
    view = flat[1:].view_as(x).copy_(x)
    assert view.data_ptr() % 16
    got = G.groupnorm_silu(view, scale, bias, groups=32)
    assert torch.equal(got, G.groupnorm_silu(x, scale, bias, groups=32))
    for cluster in (1, 3):
        slab = G._slab_route(2, 25, 224, 32, 4, 4, cluster)
        assert torch.equal(G._launch(view, scale, bias, 32, 1e-5, True, route=slab._replace(vec=1)),
                           G._launch(x, scale, bias, 32, 1e-5, True, route=slab))
    stream = G._stream_route(2, 25, 224, 4, 4)
    assert torch.equal(G._launch(view, scale, bias, 32, 1e-5, True, route=stream._replace(vec=1)),
                       G._launch(x, scale, bias, 32, 1e-5, True, route=stream))


# Both routes of K3 on the same data, and the slab route at every cluster
# size that holds the slab (1-16, ragged where H * W does not split evenly):
# (N, H, W, C, groups) at group sizes 4, 6, 7, 8, 14, 21, 49, H * W 1, 63,
# 1024 and 4096, N = 1, and C = 36 (not a multiple of 8: bf16 takes vec 1).
# In f32 at 64 x 64 x 224 no cluster holds the slab: the stream route alone.
GN_ROUTE_CASES = [(2, 32, 32, 128, 32), (2, 7, 9, 192, 32), (1, 64, 64, 224, 32),
                  (3, 1, 1, 256, 32), (2, 16, 16, 448, 32), (2, 8, 8, 672, 32),
                  (2, 8, 8, 1568, 32), (2, 5, 7, 36, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,groups", GN_ROUTE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)], ids=["silu", "no-silu"])
def test_groupnorm_routes_agree_with_plain_and_are_deterministic(cuda, n, h, w, c, groups,
                                                                 dtype, silu, eps):
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(c + h)
    x = (torch.randn(n, h, w, c, generator=g, device="cuda") * 3 + 1
         + torch.randn(groups, generator=g, device="cuda").repeat_interleave(c // groups)).to(dt)
    scale = 1 + 0.5 * torch.randn(c, generator=g, device="cuda")
    bias = torch.randn(c, generator=g, device="cuda")
    ref = G.reference_groupnorm_silu(x, scale, bias, groups=groups, eps=eps, apply_silu=silu)
    bound = GN_TOL[dt] * max(1.0, ref.float().abs().max().item())
    hw, elt, vec = h * w, x.element_size(), G._vec(c, dt)
    slabs = [G._slab_route(n, hw, c, groups, elt, vec, s) for s in range(1, min(16, hw) + 1)]
    routes = [r for r in slabs if r is not None] + [G._stream_route(n, hw, c, elt, vec)]
    assert G.gn_route(n, h, w, c, dt, groups=groups) in routes
    for route in routes:
        before = (G.groupnorm_silu.launches, G.groupnorm_silu.kernels)
        got = G._launch(x, scale, bias, groups, eps, silu, route=route)
        again = G._launch(x, scale, bias, groups, eps, silu, route=route)
        torch.cuda.synchronize()
        assert (G.groupnorm_silu.launches - before[0], G.groupnorm_silu.kernels - before[1]) \
            == (2, 2 * route.kernels)
        assert got.dtype == dt and got.shape == x.shape
        assert (got.float() - ref.float()).abs().max().item() <= bound, route
        assert torch.equal(got, again), route


@pytest.mark.cuda
def test_groupnorm_refuses_a_route_its_tables_do_not_hold(cuda):
    """A cluster above 16 blocks, or a shared-memory size that is not the
    kernel's layout, is refused with an error; nothing runs in its place."""
    x, scale, bias = _gn_inputs(2, 8, 8, 256, torch.bfloat16, seed=4)
    good = G._slab_route(2, 64, 256, 32, 2, 8, 4)
    for bad in (good._replace(cluster=17), good._replace(smem=good.smem + 16),
                G._stream_route(2, 64, 256, 2, 8)._replace(threads=128)):
        with pytest.raises(RuntimeError, match="GroupNorm failed"):
            G._launch(x, scale, bias, 32, 1e-5, True, route=bad)


@pytest.mark.cuda
def test_groupnorm_gradient_through_the_kernel(cuda):
    """The gradient by x, scale and bias through K3's autograd Function
    equals the plain version's autograd gradient (the Function's backward is
    that VJP, so they agree to f32 rounding of the saved forward)."""
    x, scale, bias = _gn_inputs(2, 16, 16, 672, torch.float32, seed=2)
    cot = torch.randn(x.shape, generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    before = G.groupnorm_silu.launches
    got = torch.autograd.grad((G.groupnorm_silu(*leaves, groups=32) * cot).sum(), leaves)
    assert G.groupnorm_silu.launches == before + 1
    want = torch.autograd.grad((G.reference_groupnorm_silu(*leaves, groups=32) * cot).sum(),
                               leaves)
    for name, a, b in zip(("x", "scale", "bias"), got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item(), name


@pytest.mark.cuda
def test_sdpa_at_d64_runs_k1_and_k2(cuda):
    """sdpa at d=64, where the JAX package takes its packed kernels, runs K1
    forward and K2 backward, and its gradient equals the plain one."""
    g = torch.Generator("cuda").manual_seed(5)
    leaves = [torch.randn(2, 256, 3, 64, generator=g, device="cuda").requires_grad_()
              for _ in range(3)]
    cot = torch.randn(2, 256, 3, 64, generator=g, device="cuda")
    counters = (A.flash_attention_mh, A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    got = torch.autograd.grad((A.sdpa(*leaves) * cot).sum(), leaves)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1]
    out, _ = A.reference_sdpa(*leaves, 64 ** -0.5)
    want = torch.autograd.grad((out * cot).sum(), leaves)
    for name, x, y in zip("qkv", got, want):
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item(), name


# (B, T, d) of K1c / K2c: Stable Diffusion's head dims at ragged T, and the
# 64x64 level's T=4096 at d=40
FLAT_SHAPES = [(3, 77, 40), (2, 200, 80), (2, 130, 160), (4, 256, 40), (2, 4096, 40)]


def _flat_inputs(b, t, d, dt, seed):
    """q, k, v as strided [B, T, d] views of one [B, T, 3, d] tensor, and a
    non-contiguous dO (the transpose of a [B, d, T])."""
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v = torch.randn(b, t, 3, d, generator=g, device="cuda").to(dt).unbind(2)
    do = torch.randn(b, d, t, generator=g, device="cuda").to(dt).transpose(1, 2)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", FLAT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_kernels_match_plain_and_are_deterministic(cuda, b, t, d, dtype):
    """K1c and K2c on strided views against the plain flat versions; two
    runs of each bit-identical; one launch each."""
    dt = getattr(torch, dtype)
    q, k, v, do = _flat_inputs(b, t, d, dt, seed=d + t)
    scale = d ** -0.5
    counters = (A.flash_attention, A.flash_attention_flat_bwd_dq,
                A.flash_attention_flat_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = A.flash_attention(q, k, v, scale)
    grads = A.flash_attention_bwd(q, k, v, out, lse, do, scale)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1]
    out2, lse2 = A.flash_attention(q, k, v, scale)
    again = A.flash_attention_bwd(q, k, v, out, lse, do, scale)
    ref_out, ref_lse = A.reference_flash_attention(q, k, v, scale)
    ref = A.reference_flash_attention_bwd(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    assert out.shape == (b, t, d) and lse.shape == (b, t) and out.dtype == dt
    tol = 1e-5 if dt == torch.float32 else 2 ** -5 * min(1.0, ref_out.float().abs().max().item())
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-5
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    rel = 1e-4 if dt == torch.float32 else 2 ** -6
    for name, x, y, z in zip("qkv", grads, ref, again):
        assert x.dtype == dt and x.shape == (b, t, d)
        assert (x.float() - y.float()).abs().max().item() <= rel * y.float().abs().max().item(), name
        assert torch.equal(x, z), name


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d", [(4096, 8, 40), (1024, 8, 80)])
def test_sdpa_at_sd_shapes_takes_the_route_of_the_jax_package(cuda, t, h, d):
    """sdpa on Stable Diffusion's f32 q / k / v (views of a [B, T, 3 * H * d]
    projection): at T=4096 it runs K1c and K2c on flat copies, at T=1024 K1
    and K2 on the views; the gradient equals the plain one either way."""
    g = torch.Generator("cuda").manual_seed(7)
    qkv = torch.randn(1, t, 3 * h * d, generator=g, device="cuda").requires_grad_()
    q, k, v = (x.reshape(1, t, h, d) for x in qkv.split(h * d, dim=-1))
    cot = torch.randn(1, t, h, d, generator=g, device="cuda")
    counters = (A.flash_attention, A.flash_attention_flat_bwd_dq,
                A.flash_attention_flat_bwd_dkv, A.flash_attention_mh, A.flash_attention_bwd_dq,
                A.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out = A.sdpa(q, k, v)
    (got,) = torch.autograd.grad((out * cot).sum(), qkv)
    flat = A.takes_flat_kernel(t, h, d, torch.float32)
    assert flat == (t == 4096)
    assert [c.launches - n for c, n in zip(counters, before)] == [flat] * 3 + [not flat] * 3
    ref_out, _ = A.reference_sdpa(q, k, v, d ** -0.5)
    (want,) = torch.autograd.grad((ref_out * cot).sum(), qkv)
    assert (out - ref_out).abs().max().item() <= 1e-5
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# (N, H, W, Cin, Cout) of K4: aligned 128-channel shapes, a 64x64 image (the
# 128-pixel tiles span image rows), tiles that span images (8x8 and 3x5
# images), ragged channel counts (multiples of 8 below and between 128s) and
# a pixel count that ends mid-tile
CONV_CASES = [(2, 8, 8, 128, 128), (3, 4, 4, 128, 256), (1, 8, 4, 256, 128),
              (2, 64, 64, 128, 128), (5, 3, 5, 128, 384), (3, 7, 5, 128, 384),
              (4, 9, 11, 24, 40), (2, 5, 6, 136, 72)]
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _conv_inputs(n, h, w, cin, cout, dtype, seed):
    """x, w at unit output scale, a bias, and a GroupNorm fold with b ~ 0.5,
    so a halo computed as silu(b) in place of 0 would show."""
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(dtype)
    wt = torch.randn(3, 3, cin, cout, generator=g, device="cuda") / (3 * cin ** 0.5)
    bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
    a = 1 + 0.1 * torch.randn(n, cin, generator=g, device="cuda")
    b = 0.5 + 0.1 * torch.randn(n, cin, generator=g, device="cuda")
    return x, wt.to(dtype), bias, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", CONV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True], ids=["conv3x3", "gn_silu_conv3x3"])
def test_conv_kernel_matches_plain(cuda, n, h, w, cin, cout, dtype, fused):
    dt = getattr(torch, dtype)
    x, wt, bias, a, b = _conv_inputs(n, h, w, cin, cout, dt, seed=cin + cout)
    before = C.conv3x3.launches
    if fused:
        got = C.gn_silu_conv3x3(x, a, b, wt, bias)
        ref = C.reference_conv3x3(x, wt, bias, a, b)
    else:
        got = C.conv3x3(x, wt, bias)
        ref = C.reference_conv3x3(x, wt, bias)
    torch.cuda.synchronize()
    assert C.conv3x3.launches == before + 1
    assert got.dtype == dt and got.shape == (n, h, w, cout)
    bound = CONV_TOL[dt] * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= bound


# The wgmma kernels (on a TMA-loaded halo tile) across their patch plans:
# W of one pixel, below, at and above the 32-column patch, and cut into
# 32-column patches up to W + 2 > 256; Cin below, between and above the
# chunk (64 bf16 or 32 f32 channels); Cout below, at and above the
# output-channel tile (128 bf16, 64 f32) and ending inside it, and inside a
# 32-channel epilogue pass (bf16)
WGMMA_WIDTHS = [1, 5, 8, 31, 32, 33, 64, 300]
WGMMA_CHANNELS = [(8, 120), (72, 384), (128, 8), (256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("w", WGMMA_WIDTHS)
@pytest.mark.parametrize("cin,cout", WGMMA_CHANNELS)
@pytest.mark.parametrize("fused", [False, True], ids=["conv3x3", "gn_silu_conv3x3"])
def test_conv_bf16_wgmma_kernel_matches_plain(cuda, w, cin, cout, fused):
    _wgmma_kernel_matches_plain(w, cin, cout, fused, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("w", WGMMA_WIDTHS)
@pytest.mark.parametrize("cin,cout", WGMMA_CHANNELS)
@pytest.mark.parametrize("fused", [False, True], ids=["conv3x3", "gn_silu_conv3x3"])
def test_conv_f32_wgmma_kernel_matches_plain(cuda, w, cin, cout, fused):
    """The 3xTF32 kernel; each call also launches the split of w once."""
    before = C.split_w.launches
    _wgmma_kernel_matches_plain(w, cin, cout, fused, torch.float32)
    assert C.split_w.launches == before + 2


def _wgmma_kernel_matches_plain(w, cin, cout, fused, dtype):
    n, h = 2, 9 if w <= 64 else 3
    x, wt, bias, a, b = _conv_inputs(n, h, w, cin, cout, dtype, seed=w + cin + cout)
    if fused:
        def run():
            return C.gn_silu_conv3x3(x, a, b, wt, bias)
        ref = C.reference_conv3x3(x, wt, bias, a, b)
    else:
        def run():
            return C.conv3x3(x, wt, bias)
        ref = C.reference_conv3x3(x, wt, bias)
    before = C.conv3x3.launches
    got = run()
    assert C.conv3x3.launches == before + 1
    again = run()
    torch.cuda.synchronize()
    assert C.conv3x3.launches == before + 2
    assert got.dtype == dtype and got.shape == (n, h, w, cout)
    bound = CONV_TOL[dtype] * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= bound
    assert torch.equal(got, again)  # a fixed order of sums, no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(8, 120), (72, 384), (256, 256)])
def test_conv_split_w_kernel_matches_split_tf32(cuda, cin, cout):
    """The split kernel is bit-equal to its plain version, ties (away from
    zero), negatives, subnormals, +-0 and large magnitudes included; the
    CPU tensor takes the plain version and counts no launch."""
    g = torch.Generator("cuda").manual_seed(cin + cout)
    w = torch.randn(3, 3, cin, cout, generator=g, device="cuda") / (3 * cin ** 0.5)
    special = torch.tensor([0.0, -0.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1e-40,
                            -3e-39, 2 ** -126, 3e38, -1e30, 65504.0, 1 - 2 ** -24], device="cuda")
    w.view(-1)[: special.numel()] = special
    before = C.split_w.launches
    hi, lo = C.split_w(w)
    torch.cuda.synchronize()
    assert C.split_w.launches == before + 1
    want_hi, want_lo = C.split_tf32(w.transpose(2, 3))
    assert hi.shape == lo.shape == (3, 3, cout, cin)
    for got, want in ((hi, want_hi), (lo, want_lo)):
        assert torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32))
    cpu = C.split_w(w.cpu())
    assert C.split_w.launches == before + 1
    assert torch.equal(cpu[0], want_hi.cpu()) and torch.equal(cpu[1], want_lo.cpu())


@pytest.mark.cuda
def test_conv_kernel_zero_halo_and_no_bias(cuda):
    """The padding is zero after the prologue: against a plain version that
    pads before it (silu(b) at the border), K4 differs, and only at the
    border; without a bias the output equals a zero bias's."""
    x, wt, _, a, b = _conv_inputs(2, 6, 7, 128, 128, torch.float32, seed=5)
    got = C.gn_silu_conv3x3(x, a, b, wt)
    assert torch.equal(got, C.gn_silu_conv3x3(x, a, b, wt, torch.zeros(128, device="cuda")))
    z = torch.nn.functional.silu(x * a[:, None, None] + b[:, None, None])
    zp = torch.nn.functional.silu(torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
                                  * a[:, None, None] + b[:, None, None])
    wrong = C.reference_conv3x3(zp, wt)[:, 1:-1, 1:-1]
    right = C.reference_conv3x3(z, wt)
    assert (got - right).abs().max().item() <= 1e-5 * right.abs().max().item()
    diff = (got - wrong).abs()
    assert diff[:, 1:-1, 1:-1].max().item() <= 1e-5 * right.abs().max().item()
    assert diff.max().item() > 0.1


@pytest.mark.cuda
def test_conv_kernel_raises_on_unsupported_input(cuda):
    x = torch.zeros(1, 4, 4, 12, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        C.conv3x3(x, torch.zeros(3, 3, 12, 16, device="cuda"))
    x = torch.zeros(1, 4, 4, 16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        C.conv3x3(x, torch.zeros(3, 3, 16, 20, device="cuda"))
    with pytest.raises(ValueError, match=r"w must be \[3, 3, 16"):
        C.conv3x3(x, torch.zeros(1, 1, 16, 16, device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        C.conv3x3(x.half(), torch.zeros(3, 3, 16, 16, device="cuda"))
    with pytest.raises(RuntimeError, match="forward only"):
        C.conv3x3(x.requires_grad_(), torch.zeros(3, 3, 16, 16, device="cuda"))
    with pytest.raises(RuntimeError, match="forward only"):
        C.gn_silu_conv3x3(torch.zeros(1, 4, 4, 16, device="cuda"), torch.ones(1, 16, device="cuda"),
                          torch.zeros(1, 16, device="cuda"),
                          torch.zeros(3, 3, 16, 16, device="cuda", requires_grad=True))
    with torch.no_grad():  # nothing is recorded: the kernel runs
        assert C.conv3x3(x, torch.zeros(3, 3, 16, 16, device="cuda")).abs().max().item() == 0


@pytest.mark.cuda
def test_conv_kernel_on_an_unaligned_view(cuda):
    """A view whose storage starts 4 bytes in is copied to an aligned
    buffer first: the result is the aligned input's."""
    x, wt, bias, _, _ = _conv_inputs(2, 5, 5, 128, 128, torch.float32, seed=6)
    flat = torch.empty(x.numel() + 1, device="cuda")
    view = flat[1:].view_as(x).copy_(x)
    assert view.data_ptr() % 16
    assert torch.equal(C.conv3x3(view, wt, bias), C.conv3x3(x, wt, bias))
