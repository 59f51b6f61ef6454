"""The route of the attention forward (``ops/attention.py::fwd_route``): which
kernel of ``csrc/flash_attn_fwd.cu`` a call takes, at which padded head dim,
with which load mode and tiles, on the views that the five tiers' attention
layers hand to ``sdpa``; and the profiler categories of the kernels' names.

The views are captured from the port's own attention functions on the CPU
(``layers.attention``: SongUNet and DhariwalUNet, the interleaved (head, c,
qkv) split; ``adm.legacy_attention``: the LSUN LDM's [N, T, heads, 3 ch]
split; ``ldm.CrossAttention``: Stable Diffusion's contiguous reshapes of
separate projections), at batch 1 and each tier's published widths.  No
kernel runs here: the card's tests (``test_torch_kernels_cuda.py``) hold
the kernels against the plain version on these layouts.
"""

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
CC_PADDED = {32: 32, 40: 48, 64: 64, 80: 80, 160: 160, 256: 256}


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
    q, k, v = _views(monkeypatch, layout, t, h, d, torch.float32)
    route = A.fwd_route(q, k, v)
    assert route == A.FwdRoute("cuda_cores", CC_PADDED[d], "strided", False, 64,
                               32 if CC_PADDED[d] >= 128 else 64, 8)


def test_sd_f32_level_takes_the_flat_kernel_on_the_cuda_cores():
    # sdpa's flat route (K1c): [B * H, T, d] copies of SD's f32 64x64 level
    assert A.takes_flat_kernel(4096, 8, 40, torch.float32)
    assert not A.takes_flat_kernel(4096, 8, 40, torch.bfloat16)
    x = torch.zeros(8, 4096, 40)
    assert A.fwd_route(x, x, x) == A.FwdRoute("cuda_cores", 48, "strided", False, 64, 64, 8)
    xb = x.bfloat16()
    assert A.fwd_route(xb, xb, xb).load == "cp_async"


@pytest.mark.parametrize("d,tc,cc", [(8, 16, 32), (16, 16, 32), (24, 32, 32), (40, 48, 48),
                                     (56, 64, 64), (72, 80, 80), (96, 128, 128),
                                     (136, 160, 160), (168, 256, 256), (256, 256, 256)])
def test_padded_head_dims(d, tc, cc):
    for dtype, padded in ((torch.bfloat16, tc), (torch.float32, cc)):
        x = torch.zeros(2, 5, 3, d, dtype=dtype)
        assert A.fwd_route(x, x, x).padded_d == padded
        assert padded in (A.TC_PADDED_DIMS if dtype == torch.bfloat16 else A.CC_PADDED_DIMS)


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
])
def test_profiling_files_both_forward_kernels(name, category):
    out = device_breakdown([_ev(name)])
    assert out["categories"][category]["calls"] == 1
    assert out["categories"]["convs and GEMMs"]["calls"] == 0
