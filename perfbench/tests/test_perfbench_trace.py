"""The reduction of a device trace: class times by kernel name, the union
of busy intervals, and idle time by the host span the gap began in."""

import pytest

from perfbench import trace


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_union_classes_and_gaps():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "generate", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "decode", "ts": 300, "dur": 100},
        _k("flash_fwd_tf32_kernel<256, 3>", 10, 40),
        _k("sm90_xmma_fprop_implicit_gemm_tf32", 30, 50),     # overlaps the first
        _k("gn_slab_kernel<float>", 200, 100),
        _k("Memcpy DtoH", 350, 50, cat="gpu_memcpy"),         # gap 300-350 inside "decode"
        _k("vectorized_elementwise_kernel", 500, 100),        # gap 400-500 in "generate"
        _k("cpu op", 0, 5000, cat="cpu_op"),                  # not a device event
    ]
    r = trace.reduce(events, ("generate", "decode"))
    assert r["class_s"]["attention"] == pytest.approx(40e-6)
    assert r["class_s"]["conv_gemm"] == pytest.approx(50e-6)
    assert r["class_s"]["groupnorm"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((70 + 100 + 50 + 100) * 1e-6)
    assert r["span_s"] == pytest.approx(590e-6)
    gaps = dict(r["idle_gaps"])
    assert gaps["generate"] == pytest.approx((120 + 100) * 1e-6)
    assert gaps["decode"] == pytest.approx(50e-6)
    assert r["device_ops"][0][0] == "gn_slab_kernel<float>"


def test_reduce_without_device_events():
    r = trace.reduce([_k("cpu op", 0, 10, cat="cpu_op")])
    assert r["busy_s"] == 0.0 and r["span_s"] == 0.0 and r["idle_gaps"] == []
