"""The route of the attention backward (``ops/attention.py::bwd_route``):
which kernels a call's dQ and dK/dV take (f32: the 3xTF32 tensor-core
kernels of ``csrc/flash_attn_bwd_tf32.cu``; bf16: the tensor-core kernels of
``csrc/flash_attn_bwd.cu``), at which padded head dim and with which tiles,
on the views that the five tiers' attention layers hand to ``sdpa`` and on
the flat copies of K2c; that the tables mirror the C sources; and the
profiler categories of the kernels' names.  No kernel runs here: the card's
tests (``test_torch_kernels_cuda.py``) hold the kernels against the plain
version on these layouts.
"""

import re
from pathlib import Path

import pytest
import torch

from diff_sampler_tpu_torch.ops import attention as A
from diff_sampler_tpu_torch.utils.profiling import device_breakdown
from test_torch_attention_tc import CASES, TC_PADDED, TF32_PADDED, _views

CSRC = Path(A.__file__).resolve().parent.parent / "csrc"


def _tiles(padded):
    """(resident rows per block, streamed rows per tile, warps per m-tile)
    of the f32 backward (``Bt`` in ``csrc/flash_attn_bwd_tf32.cu``)."""
    split = 2 if padded >= 128 else 1
    return 128 // split, 64 if padded <= 40 else 32 if padded <= 64 else 16, split


def _bf16_tiles(padded):
    """The same of the bf16 backward (``Bb`` in ``csrc/flash_attn_bwd.cu``)."""
    split = 2 if padded >= 128 else 1
    return 128 // split, 64 if padded <= 64 else 32, split


@pytest.mark.parametrize("layout,tier,t,h,d", CASES)
def test_f32_backward_takes_the_3xtf32_kernels(monkeypatch, layout, tier, t, h, d):
    """Every f32 attention level of the five tiers' AMED paths: the 3xTF32
    kernels at the tier's d (each one of their padded dims); with a
    non-contiguous dO of 16-byte rows, cp.async on the LDM's legacy split
    and SD's separate projections and the element gather on the
    interleaved qkv split (element stride 3), as with an unaligned dO."""
    q, k, v = _views(monkeypatch, layout, t, h, d, torch.float32)
    do = torch.zeros(1, h, t, d).transpose(1, 2)
    route = A.bwd_route(q, k, v, do)
    padded = TF32_PADDED[d]
    rows, tile, split = _tiles(padded)
    load = "gather" if layout == "interleaved" else "cp_async"
    assert route == A.BwdRoute("tensor_cores_3xtf32", padded, load, rows, tile, 8, split)
    assert route.block_rows * route.split_d == 16 * route.warps
    unaligned = torch.zeros(do.numel() + 1)[1:].view(do.shape)
    assert A.bwd_route(q, k, v, unaligned).load == "gather"


@pytest.mark.parametrize("layout,tier,t,h,d", CASES)
def test_bf16_backward_takes_the_tensor_cores(monkeypatch, layout, tier, t, h, d):
    """Every attention level of the five tiers in bf16: the tensor-core
    kernels at the tier's d padded to a multiple of 16 (SD's 40 to 48); with
    a contiguous dO (as autograd hands it), cp.async on the LDM's legacy
    split and SD's separate projections, the qkv rows on the interleaved
    split (SongUNet's d=256, DhariwalUNet's d=64); with an unaligned dO the
    element gather everywhere."""
    q, k, v = _views(monkeypatch, layout, t, h, d, torch.bfloat16)
    do = torch.zeros(q.shape, dtype=torch.bfloat16)
    route = A.bwd_route(q, k, v, do)
    padded = TC_PADDED[d]
    rows, tile, split = _bf16_tiles(padded)
    load = "qkv_span" if layout == "interleaved" else "cp_async"
    assert route == A.BwdRoute("tensor_cores", padded, load, rows, tile, 8, split)
    assert route.block_rows * route.split_d == 16 * route.warps
    unaligned = torch.zeros(do.numel() + 1, dtype=torch.bfloat16)[1:].view(do.shape)
    assert A.bwd_route(q, k, v, unaligned).load == "gather"


def test_flat_route_follows_k2c():
    """K2c: SD's f32 64x64 level goes flat (as the JAX ``sdpa``), and the
    [B * H, T, d] copies take the 3xTF32 kernels at d = 40 unpadded; a
    ragged flat shape too; bf16 flat copies take the tensor-core kernels
    with cp.async at d = 40 padded to 48, never the qkv rows."""
    assert A.takes_flat_kernel(4096, 8, 40, torch.float32)
    x = torch.zeros(128, 4096, 40)
    assert A.bwd_route(x, x, x, x) == A.BwdRoute("tensor_cores_3xtf32", 40, "cp_async", 128,
                                                  64, 8, 1)
    y = torch.zeros(24, 1000, 3, 40).unbind(2)
    assert A.bwd_route(*y, y[0])[:3] == ("tensor_cores_3xtf32", 40, "cp_async")
    do = torch.zeros(24, 40, 1000).transpose(1, 2)  # element stride 1000
    assert A.bwd_route(*y, do)[:3] == ("tensor_cores_3xtf32", 40, "gather")
    xb = x[:2].bfloat16()
    assert A.bwd_route(xb, xb, xb, xb) == A.BwdRoute("tensor_cores", 48, "cp_async", 128, 64,
                                                      8, 1)
    qkv = torch.zeros(2, 1000, 48 * 3, dtype=torch.bfloat16).view(2, 1000, 48, 3).unbind(-1)
    assert A.bwd_route(*qkv, qkv[0].contiguous())[:3] == ("tensor_cores", 48, "gather")


def test_backward_tables_mirror_the_kernels():
    """Each route's padded dims are the cases of its C entry's switch and
    its tiles follow ``Bt`` (f32) or ``Bb`` (bf16); the bf16 qkv rows take
    the span's padded dims (``flash_fwd.cuh::span_dim``); every d that is a
    multiple of 8 up to 256 takes the smallest padded dim that holds it."""
    f32 = (CSRC / "flash_attn_bwd_tf32.cu").read_text()
    bf16 = (CSRC / "flash_attn_bwd.cu").read_text()
    cases = sorted(int(n) for n in re.findall(r"case (\d+): err = launch_bwd_tf32<\1>", f32))
    assert cases == list(A.TF32_PADDED_DIMS)
    assert "kSplitD = DP >= 128 ? 2 : 1;" in f32
    assert "kRows = 16 * kWarps / kSplitD;" in f32 and "kWarps = 8;" in f32
    assert "kBC = DP <= 40 ? 64 : DP <= 64 ? 32 : 16;" in f32
    assert "kAsync = DP <= 160;" in f32
    cases = sorted(int(n) for n in re.findall(r"case (\d+): err = launch_bwd<\1>", bf16))
    assert cases == list(A.TC_PADDED_DIMS)
    assert "kSplitD = DP >= 128 ? 2 : 1;" in bf16
    assert "kRows = 16 * kWarps / kSplitD;" in bf16 and "kWarps = 8;" in bf16
    assert "kBC = DP <= 64 ? 64 : 32;" in bf16
    span = re.search(r"span_dim\(int dp\) \{\s*return ([^;]*);",
                     (CSRC / "flash_fwd.cuh").read_text())
    assert sorted(int(n) for n in re.findall(r"dp == (\d+)", span.group(1))) == list(
        A._SPAN_DIMS[torch.bfloat16])
    for d in range(8, 257, 8):
        x = torch.zeros(1, 3, 1, d)
        route = A.bwd_route(x, x, x, x)
        assert route.padded_d == min(p for p in A.TF32_PADDED_DIMS if p >= d)
        assert (route.block_rows, route.tile_rows, route.split_d) == _tiles(route.padded_d)
        assert route.load == ("cp_async" if route.padded_d <= 160 else "gather")
        xb = x.bfloat16()
        route = A.bwd_route(xb, xb, xb, xb)
        assert route.padded_d == min(p for p in A.TC_PADDED_DIMS if p >= d)
        assert (route.block_rows, route.tile_rows, route.split_d) == _bf16_tiles(route.padded_d)
        assert route.load == "cp_async"


def test_backward_route_refuses_other_dtypes():
    x = torch.zeros(1, 4, 1, 8, dtype=torch.float16)
    with pytest.raises(TypeError, match="no backward kernel"):
        A.bwd_route(x, x, x, x)


def _ev(name):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": 0.0, "dur": 10.0}


@pytest.mark.parametrize("name, category", [
    ("void (anonymous namespace)::flash_bwd_dq_tf32_kernel<(int)64>(const float *, "
     "const float *, const float *, const float *, const float *, const float *, float *, int, "
     "int, int, Strides, Strides, Strides, Strides, float)", "K2 dQ"),
    ("_ZN52_GLOBAL__N__0a1b2c3d_22_flash_attn_bwd_tf32_cu_9d7e4aa924flash_bwd_dq_tf32_kernelILi"
     "256EEEvPKfS2_S2_S2_S2_S2_PfiiiNS_7StridesES4_S4_S4_f", "K2 dQ"),
    ("void (anonymous namespace)::flash_bwd_dkv_tf32_kernel<(int)32>(const float *)",
     "K2 dK/dV"),
    ("_ZN52_GLOBAL__N__0a1b2c3d_22_flash_attn_bwd_tf32_cu_9d7e4aa925flash_bwd_dkv_tf32_kernelILi"
     "80EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiNS_7StridesES4_S4_S4_f", "K2 dK/dV"),
    ("void (anonymous namespace)::flash_bwd_dq_tf32_flat_kernel<(int)40>(const float *)",
     "K2c dQ"),
    ("void (anonymous namespace)::flash_bwd_dkv_tf32_flat_kernel<(int)40>(const float *)",
     "K2c dK/dV"),
    ("void (anonymous namespace)::flash_bwd_dq_bf16_kernel<(int)256, (int)3>(const "
     "__nv_bfloat16 *)", "K2 dQ"),
    ("_ZN52_GLOBAL__N__0a1b2c3d_17_flash_attn_bwd_cu_9d7e4aa925flash_bwd_dkv_bf16_kernelILi64E"
     "Li1EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiiNS_7StridesES7_S7_S7_f", "K2 dK/dV"),
])
def test_profiling_files_the_backward_kernels(name, category):
    out = device_breakdown([_ev(name)])
    assert out["categories"][category]["calls"] == 1
    assert sum(c["calls"] for c in out["categories"].values()) == 1
