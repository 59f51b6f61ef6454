"""The route of the attention forward (``ops/attention.py::fwd_route``): which
kernel a call takes (bf16: ``csrc/flash_attn_fwd.cu``; f32, 3xTF32:
``csrc/flash_attn_fwd_tf32.cu``), at which padded head dim, with which load
mode and tiles, on the views that the five tiers' attention layers hand to
``sdpa``; and the profiler categories of the kernels' names.

The views are captured from the port's own attention functions on the CPU
(``layers.attention``: SongUNet and DhariwalUNet, the interleaved (head, c,
qkv) split; ``adm.legacy_attention``: the LSUN LDM's [N, T, heads, 3 ch]
split; ``ldm.CrossAttention``: Stable Diffusion's contiguous reshapes of
separate projections), at batch 1 and each tier's published widths.  No
kernel runs here: the card's tests (``test_torch_kernels_cuda.py``) hold
the kernels against the plain version on these layouts.
"""

import re
from pathlib import Path

import pytest
import torch

from diff_sampler_tpu_torch.models import adm, layers, ldm
from diff_sampler_tpu_torch.ops import attention as A
from diff_sampler_tpu_torch.utils.profiling import device_breakdown

# (tier, T, heads, d) of every attention level of the five tiers
INTERLEAVED = [("cifar10", 256, 1, 256), ("cifar10", 64, 1, 256),
               ("ffhq", 256, 1, 256), ("ffhq", 64, 1, 256),
               ("imagenet64", 1024, 6, 64), ("imagenet64", 256, 9, 64),
               ("imagenet64", 64, 12, 64)]
LEGACY = [("lsun_bedroom_ldm", 1024, 14, 32), ("lsun_bedroom_ldm", 256, 21, 32),
          ("lsun_bedroom_ldm", 64, 28, 32)]
SEPARATE = [("ms_coco", 4096, 8, 40), ("ms_coco", 1024, 8, 80), ("ms_coco", 256, 8, 160),
            ("ms_coco", 64, 8, 160)]
# the padded head dim of each tier's d, by kernel
TC_PADDED = {32: 32, 40: 48, 64: 64, 80: 80, 160: 160, 256: 256}
TF32_PADDED = {32: 32, 40: 40, 64: 64, 80: 80, 160: 160, 256: 256}
CSRC = Path(A.__file__).resolve().parent.parent / "csrc"


def _f32_keys(padded):
    """Keys per tile of the f32 kernel (``Tf::kBK``)."""
    return 64 if padded <= 40 else 32 if padded <= 128 else 16


def _captured(monkeypatch, module, call):
    """The (q, k, v) that ``call()`` hands to ``module.sdpa``."""
    seen = []

    def capture(q, k, v, scale=None):
        seen.append((q, k, v))
        return q.new_zeros(q.shape)

    monkeypatch.setattr(module, "sdpa", capture)
    call()
    assert len(seen) == 1
    return seen[0]


def _views(monkeypatch, layout, t, h, d, dtype):
    side = int(round(t ** 0.5))
    c = h * d
    if layout == "interleaved":  # the 1x1 qkv conv's NHWC output
        qkv = torch.zeros(1, side, side, 3 * c, dtype=dtype)
        return _captured(monkeypatch, layers, lambda: layers.attention(qkv, h))
    if layout == "legacy":  # AttentionBlock: qkv conv output, reshaped to [N, T, 3C]
        qkv = torch.zeros(1, side, side, 3 * c, dtype=dtype).reshape(1, t, 3 * c)
        return _captured(monkeypatch, adm, lambda: adm.legacy_attention(qkv, h))
    attn = ldm.CrossAttention(c, c, h, d, device="cpu").to(dtype)  # self-attention
    x = torch.zeros(1, t, c, dtype=dtype)
    with torch.no_grad():
        return _captured(monkeypatch, adm, lambda: attn(x))


CASES = ([("interleaved", *s) for s in INTERLEAVED] + [("legacy", *s) for s in LEGACY]
         + [("separate", *s) for s in SEPARATE])


@pytest.mark.parametrize("layout,tier,t,h,d", CASES)
def test_bf16_takes_the_tensor_cores_with_the_layouts_load_mode(monkeypatch, layout, tier, t,
                                                               h, d):
    q, k, v = _views(monkeypatch, layout, t, h, d, torch.bfloat16)
    assert q.shape == (1, t, h, d)
    route = A.fwd_route(q, k, v)
    assert route.kernel == "tensor_cores"
    assert route.padded_d == TC_PADDED[d]
    if layout == "interleaved":  # element stride 3: the gather, K / V from the qkv rows
        assert q.stride(-1) == 3
        assert (route.load, route.span) == ("gather", True)
    else:  # element stride 1, 16-byte aligned rows: cp.async
        assert q.stride(-1) == 1
        assert (route.load, route.span) == ("cp_async", False)
    assert route.block_q == 128 and route.block_k in (32, 64)
    assert route.block_q == 16 * route.warps * (2 if 48 <= route.padded_d <= 80 else 1)


@pytest.mark.parametrize("layout,tier,t,h,d", CASES)
def test_f32_stays_on_the_cuda_cores(monkeypatch, layout, tier, t, h, d):
    """Every f32 level of the five tiers takes the 3xTF32 tensor-core kernel
    (no f32 forward is left on the CUDA cores): the interleaved views the
    gather (from the qkv rows at ImageNet-64's d=64), the others cp.async."""
    q, k, v = _views(monkeypatch, layout, t, h, d, torch.float32)
    assert q.shape == (1, t, h, d) and q.stride(-1) == (3 if layout == "interleaved" else 1)
    route = A.fwd_route(q, k, v)
    padded = TF32_PADDED[d]
    assert padded == d  # every tier's d is one of the f32 kernel's padded dims
    load = ("gather", padded == 64) if layout == "interleaved" else ("cp_async", False)
    assert route == A.FwdRoute("tensor_cores_3xtf32", padded, *load, 128, _f32_keys(padded), 8)


def test_sd_f32_level_takes_the_flat_kernel_on_the_cuda_cores():
    """sdpa's flat route (K1c): [B * H, T, d] copies of SD's f32 64x64 level
    take the f32 kernel's flat entry on the tensor cores, with cp.async."""
    assert A.takes_flat_kernel(4096, 8, 40, torch.float32)
    assert not A.takes_flat_kernel(4096, 8, 40, torch.bfloat16)
    x = torch.zeros(8, 4096, 40)
    assert A.fwd_route(x, x, x) == A.FwdRoute("tensor_cores_3xtf32", 40, "cp_async", False, 128,
                                              64, 8)
    xb = x.bfloat16()
    assert A.fwd_route(xb, xb, xb).load == "cp_async"


def test_f32_flat_views_never_read_the_qkv_rows():
    # [B, T, d] views of one [B, T, d, 3] projection: bf16 reads the qkv rows
    # (its flat layout is the multi-head kernel with one head), f32 takes the
    # element gather, which its flat entry has
    for dtype, span in ((torch.bfloat16, True), (torch.float32, False)):
        q, k, v = torch.zeros(4, 200, 64, 3, dtype=dtype).unbind(-1)
        assert A.fwd_route(q, k, v)[2:4] == ("gather", span)
    # strided flat views of a [B, T, 3, d] tensor: 16-byte aligned rows
    q, k, v = torch.zeros(3, 77, 3, 40).unbind(2)
    assert A.fwd_route(q, k, v)[1:4] == (40, "cp_async", False)


@pytest.mark.parametrize("d,tc,cc", [(8, 16, 16), (16, 16, 16), (24, 32, 32), (40, 48, 40),
                                     (56, 64, 64), (72, 80, 80), (96, 128, 128),
                                     (136, 160, 160), (168, 256, 256), (256, 256, 256)])
def test_padded_head_dims(d, tc, cc):
    for dtype, padded in ((torch.bfloat16, tc), (torch.float32, cc)):
        x = torch.zeros(2, 5, 3, d, dtype=dtype)
        assert A.fwd_route(x, x, x).padded_d == padded
        assert padded in (A.TC_PADDED_DIMS if dtype == torch.bfloat16 else A.TF32_PADDED_DIMS)


def _launch_cases(source, launcher):
    return sorted(int(n) for n in re.findall(rf"case (\d+): err = {launcher}<\1>", source))


def test_padded_dims_mirror_the_kernels_tables():
    """The route's padded dims are the cases of the C entries' switches, and
    its f32 keys per tile follow ``Tf::kBK``."""
    bf16 = (CSRC / "flash_attn_fwd.cu").read_text()
    f32 = (CSRC / "flash_attn_fwd_tf32.cu").read_text()
    assert _launch_cases(bf16, "launch_tc") == list(A.TC_PADDED_DIMS)
    assert _launch_cases(f32, "launch_tf32") == list(A.TF32_PADDED_DIMS)
    assert "kBK = DP <= 40 ? 64 : DP <= 128 ? 32 : 16;" in f32
    assert "return dp == 32 || dp == 64;" in f32  # tf32_span_dim
    for d in range(8, 257, 8):
        x = torch.zeros(1, 3, 1, d)
        route = A.fwd_route(x, x, x)
        assert route.padded_d == min(p for p in A.TF32_PADDED_DIMS if p >= d)
        assert route.block_k == _f32_keys(route.padded_d)


def test_f32_cp_async_only_where_every_view_takes_16_byte_copies():
    shape = (2, 64, 3, 64)
    x = _unaligned(shape, torch.float32)  # the base 4 bytes past 16
    assert x.stride(-1) == 1 and x.data_ptr() % 16 == 4
    assert A.fwd_route(x, x, x)[2:4] == ("gather", False)
    # aligned base, a token stride that is not a multiple of 4 floats
    y = torch.zeros(2, 64, 3, 66)[..., :64]
    assert A.fwd_route(y, y, y)[2:4] == ("gather", False)
    # a head stride of 66 floats (rows of 3 heads side by side, padded)
    w = torch.zeros(2, 64, 3, 66)[..., 2:66]
    assert w.data_ptr() % 16 == 8 and A.fwd_route(w, w, w)[2:4] == ("gather", False)
    # element stride 2 (every other float)
    e = torch.zeros(2, 64, 3, 128)[..., ::2]
    assert A.fwd_route(e, e, e)[2:4] == ("gather", False)
    z = torch.zeros(shape)
    assert A.fwd_route(z, z, x)[2:4] == ("gather", False)  # all three must be aligned
    assert A.fwd_route(z, z, z)[2:4] == ("cp_async", False)
    # a token stride of 68 floats (17 16-byte units) is aligned too
    assert A.fwd_route(*(torch.zeros(2, 64, 3, 68)[..., :64],) * 3)[2:4] == ("cp_async", False)


@pytest.mark.parametrize("d,span", [(32, True), (64, True), (40, False), (80, False),
                                    (128, False), (256, False)])
def test_f32_qkv_row_gather_on_one_projections_aligned_rows(d, span):
    """The gather from the qkv rows in f32: k 4 bytes past q, v 4 past k
    (``_qkv_span`` is element-size aware), at the padded dims whose raw
    stage fits (32, 64)."""
    qkv = torch.zeros(2, 64, 3 * d * 3)
    q, k, v = qkv.reshape(2, 64, 3, d, 3).unbind(-1)
    assert k.data_ptr() == q.data_ptr() + 4 and v.data_ptr() == q.data_ptr() + 8
    assert A._qkv_span(q, k, v)
    assert A.fwd_route(q, k, v)[2:4] == ("gather", span)


def test_f32_qkv_row_gather_refuses_other_stride3_views():
    # element stride 3, but q, k, v not one projection's interleaved channels
    a, b, c = (torch.zeros(2, 64, 3, 64, 3).unbind(-1) for _ in range(3))
    assert not A._qkv_span(a[0], b[1], c[2])
    assert A.fwd_route(a[0], b[1], c[2])[2:4] == ("gather", False)
    # one projection's rows, 4 bytes off 16-byte alignment
    qkv = _unaligned((2, 64, 3 * 64 * 3), torch.float32)
    q, k, v = qkv.reshape(2, 64, 3, 64, 3).unbind(-1)
    assert not A._qkv_span(q, k, v)
    assert A.fwd_route(q, k, v)[2:4] == ("gather", False)
    # a token stride that is not a multiple of 4 floats
    qkv = torch.zeros(2, 64, 3 * 64 * 3 + 2)[..., :3 * 64 * 3]
    q, k, v = qkv.reshape(2, 64, 3, 64, 3).unbind(-1)
    assert not A._qkv_span(q, k, v)
    # q, k, v in another order
    qkv = torch.zeros(2, 64, 3 * 64 * 3)
    q, k, v = qkv.reshape(2, 64, 3, 64, 3).unbind(-1)
    assert not A._qkv_span(k, q, v)


def _unaligned(shape, dtype, offset=1):
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def test_unaligned_or_strided_views_take_the_gather():
    shape = (2, 64, 3, 64)
    # an unaligned slice: element stride 1, the base 2 bytes past 16
    x = _unaligned(shape, torch.bfloat16)
    assert x.stride(-1) == 1 and x.data_ptr() % 16 == 2
    assert A.fwd_route(x, x, x)[2:4] == ("gather", False)
    # aligned base, a token stride that is not a multiple of 8 elements
    y = torch.zeros(2, 64, 3, 68, dtype=torch.bfloat16)[..., :64]
    assert A.fwd_route(y, y, y)[2:4] == ("gather", False)
    # one aligned and contiguous view is not enough: all three must be
    z = torch.zeros(shape, dtype=torch.bfloat16)
    assert A.fwd_route(z, z, x)[2:4] == ("gather", False)
    assert A.fwd_route(z, z, z)[2:4] == ("cp_async", False)


def test_stride3_views_of_other_tensors_take_the_element_gather():
    # element stride 3, but q, k, v not one projection's interleaved channels
    a, b, c = (torch.zeros(2, 64, 3, 64, 3, dtype=torch.bfloat16).unbind(-1) for _ in range(3))
    assert A.fwd_route(a[0], b[1], c[2])[2:4] == ("gather", False)
    # the interleaved split of one projection whose rows are not 16-byte aligned
    qkv = _unaligned((2, 64, 3 * 64 * 3), torch.bfloat16)
    q, k, v = qkv.reshape(2, 64, 3, 64, 3).unbind(-1)
    assert A.fwd_route(q, k, v)[2:4] == ("gather", False)
    # aligned, but a padded dim whose rows do not split into 32-unit groups
    qkv = torch.zeros(2, 64, 3 * 40 * 3, dtype=torch.bfloat16)
    q, k, v = qkv.reshape(2, 64, 3, 40, 3).unbind(-1)
    assert A.fwd_route(q, k, v)[1:4] == (48, "gather", False)


def test_route_refuses_other_dtypes():
    x = torch.zeros(1, 4, 1, 8, dtype=torch.float16)
    with pytest.raises(TypeError, match="no forward kernel"):
        A.fwd_route(x, x, x)


def _ev(name):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": 0.0, "dur": 10.0}


@pytest.mark.parametrize("name, category", [
    ("void (anonymous namespace)::flash_fwd_tc_kernel<(int)64, (int)3>(const __nv_bfloat16 *, "
     "const __nv_bfloat16 *, const __nv_bfloat16 *, __nv_bfloat16 *, float *, int, int, int, "
     "Strides, Strides, Strides, float)", "K1"),
    ("void (anonymous namespace)::flash_fwd_tc_kernel<(int)48, (int)1>(const __nv_bfloat16 *)",
     "K1"),
    ("_ZN50_GLOBAL__N__bf986bba_17_flash_attn_fwd_cu_71e8d4a119flash_fwd_tc_kernelILi256ELi2EEEv"
     "PK13__nv_bfloat16S3_S3_PS1_PfiiiNS_7StridesES6_S6_f", "K1"),
    ("void (anonymous namespace)::flash_fwd_kernel<(int)64, (int)64>(const float *)", "K1"),
    ("void (anonymous namespace)::flash_fwd_flat_kernel<(int)48, (int)64>(const float *)",
     "K1c"),
    ("void (anonymous namespace)::flash_fwd_tf32_kernel<(int)64, (int)3>(const float *, "
     "const float *, const float *, float *, float *, int, int, int, Strides, Strides, "
     "Strides, float)", "K1"),
    ("_ZN52_GLOBAL__N__0a1b2c3d_22_flash_attn_fwd_tf32_cu_9d7e4aa921flash_fwd_tf32_kernelILi256E"
     "Li2EEEvPKfS2_S2_PfS3_iiiNS_7StridesES4_S4_f", "K1"),
    ("void (anonymous namespace)::flash_fwd_tf32_flat_kernel<(int)40, (int)1>(const float *)",
     "K1c"),
    ("_ZN52_GLOBAL__N__0a1b2c3d_22_flash_attn_fwd_tf32_cu_9d7e4aa926flash_fwd_tf32_flat_kernelILi"
     "40ELi2EEEvPKfS2_S2_PfS3_iiNS_7StridesES4_S4_f", "K1c"),
])
def test_profiling_files_both_forward_kernels(name, category):
    out = device_breakdown([_ev(name)])
    assert out["categories"][category]["calls"] == 1
    assert out["categories"]["convs and GEMMs"]["calls"] == 0
