"""The device-time breakdown of profiler traces (``utils.profiling``) and
the AMED profile CLI's guard, on synthetic Chrome-trace events."""

import pytest
import torch

from diff_sampler_tpu_torch.cli import profile_amed
from diff_sampler_tpu_torch.utils.profiling import device_breakdown


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.mark.parametrize("name, category", [
    ("void flash_fwd_kernel<float, 256>(FwdParams)", "K1"),
    ("void flash_bwd_dq_kernel<__nv_bfloat16, 256>(BwdParams)", "K2 dQ"),
    ("void flash_bwd_dkv_kernel<float, 64>(BwdParams)", "K2 dK/dV"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, (int)64, (int)64>(float)", "K1"),
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, (int)64, (int)64>"
     "(const T1 *)", "K1"),
    ("void flash_fwd_kernel<float, 32, 64>(const float *)", "K1"),
    ("_ZN50_GLOBAL__N__0_17flash_attn_bwd_cu20flash_bwd_dq_kernelIfLi64ELi64ELi64EEEvPKT_",
     "K2 dQ"),
    ("_ZN50_GLOBAL__N__0_17flash_attn_bwd_cu20flash_bwd_dq_kernelIfLi256ELi32ELi32EEEvPKT_",
     "K2 dQ"),
    ("void flash_bwd_dkv_kernel<__nv_bfloat16, (int)32, (int)64, (int)64>(const T1 *)",
     "K2 dK/dV"),
    ("void flash_bwd_dkv_kernel<float, (int)256, (int)32, (int)32>(const T1 *)",
     "K2 dK/dV"),
    ("void (anonymous namespace)::flash_fwd_flat_kernel<float, (int)48, (int)64>(const T1 *)",
     "K1c"),
    ("void (anonymous namespace)::flash_bwd_dq_flat_kernel<float, (int)48, (int)64, (int)64>"
     "(Args)", "K2c dQ"),
    ("void (anonymous namespace)::flash_bwd_dkv_flat_kernel<float, (int)48, (int)64, (int)64>"
     "(Args)", "K2c dK/dV"),
    ("void (anonymous namespace)::gn_slab_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int, float, int)", "K3"),
    ("_ZN45_GLOBAL__N__3f4b1bed_12_groupnorm_cu_424dcad322gn_stream_stats_kernelIfLi4EEEvPKT_"
     "PKfS5_PdS6_PfS7_Pjiiiif", "K3"),
    ("void (anonymous namespace)::gn_stream_apply_kernel<float, (int)4>(const T1 *, const float *)",
     "K3"),
    ("sm90_xmma_fprop_implicit_gemm_tf32f32_tf32f32_f32_nhwckrsc_nhwc", "convs and GEMMs"),
    ("void at::native::conv_depthwise2d_forward_kernel<1, float, int>", "convs and GEMMs"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reductions"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>",
     "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", "elementwise"),
    ("some_unknown_kernel", "other"),
])
def test_kernels_sort_by_name(name, category):
    out = device_breakdown([_ev(name, 0.0, 10.0)])
    assert out["categories"][category]["calls"] == 1
    assert out["categories"][category]["ms"] == pytest.approx(0.01)
    assert out["categories"][category]["share"] == 1.0


def test_shares_busy_and_idle():
    events = [
        _ev("flash_fwd_kernel", 0.0, 100.0),
        _ev("vectorized_elementwise_kernel", 50.0, 100.0),  # overlaps: busy 0-150
        _ev("Memcpy DtoH", 200.0, 50.0, cat="gpu_memcpy"),  # gap 150-200
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 1e6},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0.0},
    ]
    out = device_breakdown(events)
    assert out["device_ms"] == pytest.approx(0.25)
    assert out["span_ms"] == pytest.approx(0.25)
    assert out["busy_ms"] == pytest.approx(0.2)
    assert out["idle_share"] == pytest.approx(0.2)
    assert out["categories"]["memcpy / memset"]["share"] == pytest.approx(0.2)
    assert sum(c["share"] for c in out["categories"].values()) == pytest.approx(1.0)
    assert out["top"][0] == ("flash_fwd_kernel", pytest.approx(0.1))


def test_no_device_events_raises():
    with pytest.raises(ValueError, match="no device events"):
        device_breakdown([{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5}])


def test_profile_cli_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profile_amed.main()
