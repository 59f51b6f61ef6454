"""Operations and bytes of each counted op, worked by hand on small shapes,
and the rooflines and shares built from them."""

import pytest
import torch

from perfbench import core
from perfbench.reference import ops
from perfbench.reference.ops import Work
from perfbench.work import call_work

F32 = 4


def test_conv_counts():
    # [2, 3, 5, 5] -> 4 channels, 3x3, padding 1: 2*4*5*5 outputs of 3*3*3 products
    w = call_work(lambda x, k, b: ops.conv2d(x, k, b, padding=1), (2, 3, 5, 5), (4, 3, 3, 3),
                  (4,))
    assert w.flops["conv_gemm"] == 2 * (2 * 4 * 5 * 5) * 27
    assert w.bytes["conv_gemm"] == F32 * (2 * 3 * 25 + 4 * 27 + 2 * 4 * 25 + 4)


def test_depthwise_and_transposed_conv_counts():
    w = call_work(lambda x, k: ops.conv2d(x, k, stride=2, groups=3), (1, 3, 4, 4), (3, 1, 2, 2))
    assert w.flops["conv_gemm"] == 2 * (3 * 2 * 2) * 4
    w = call_work(lambda x, k: ops.conv_transpose2d(x, k, stride=2, padding=0, groups=3),
                  (1, 3, 4, 4), (3, 1, 2, 2))
    assert w.flops["conv_gemm"] == 2 * (3 * 4 * 4) * 4  # each input feeds 2x2 outputs
    assert w.bytes["conv_gemm"] == F32 * (48 + 12 + 3 * 8 * 8)


def test_linear_counts():
    w = call_work(lambda x, k, b: ops.linear(x, k, b), (6, 5), (7, 5), (7,))
    assert w.flops["conv_gemm"] == 2 * 6 * 7 * 5
    assert w.bytes["conv_gemm"] == F32 * (30 + 35 + 42 + 7)


def test_attention_counts_and_class():
    w = call_work(lambda q, k, v: ops.softmax_attention(q, k, v, 0.5), (3, 8, 4), (3, 6, 4),
                  (3, 6, 4))
    assert w.flops["attention"] == 4 * 3 * 8 * 6 * 4  # q k^T and p v
    assert w.bytes["attention"] == F32 * (96 + 72 + 72 + 96)
    w = call_work(lambda q, k, v: ops.softmax_attention(q, k, v, 0.5, cls="conv_gemm"),
                  (3, 8, 4), (3, 6, 4), (3, 6, 4))
    assert w.flops["attention"] == 0 and w.flops["conv_gemm"] == 4 * 3 * 8 * 6 * 4


def test_groupnorm_counts_bytes_once():
    w = call_work(lambda x, g, b: ops.group_norm(x, 2, g, b, 1e-5), (2, 4, 3, 3), (4,), (4,))
    assert w.bytes["groupnorm"] == F32 * (72 + 72 + 4 + 4)


def test_softmax_attention_in_blocks_matches_whole():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(5, 7, 3, generator=g) for _ in range(3))
    whole = torch.softmax(q @ k.transpose(1, 2) * 0.3, dim=-1) @ v
    torch.testing.assert_close(ops.softmax_attention(q, k, v, 0.3, rows=2), whole)


def test_bound_takes_the_larger_side_per_op():
    w = Work()
    w.add("conv_gemm", 1000.0, 10.0)   # operations-bound at these peaks
    w.add("conv_gemm", 10.0, 1000.0)   # bytes-bound
    assert w.bound_s("conv_gemm", 100.0, 100.0) == pytest.approx(10.0 + 10.0)
    assert w.scaled(3).bound_s("conv_gemm", 100.0, 100.0) == pytest.approx(60.0)


def _trace(class_s, window_s=2.0, busy=1.5, span=1.8):
    w = Work()
    w.add("attention", 4.95e12, 1.0)   # 10 ms at 495 TFLOP/s
    w.add("groupnorm", 1.0, 3.35e10)   # 10 ms at 3.35 TB/s
    w.add("conv_gemm", 9.9e13, 1.0)    # 200 ms
    return {"class_s": class_s, "busy_s": busy, "span_s": span, "window_s": window_s,
            "work": w, "peaks": core.peaks("NVIDIA H100 80GB HBM3"), "decode_s": 0.5}


def test_metric_readers():
    t = _trace({"attention": 0.02, "groupnorm": 0.04, "conv_gemm": 0.4})
    read = {m: core.load_module("metrics", m).read(t) for m in (
        "attn_roofline.sample", "gn_roofline.sample", "conv_gemm_roofline.sample",
        "idle_share.sample", "mfu.sample", "decode_share.sample")}
    assert read["attn_roofline.sample"] == pytest.approx(50.0)
    assert read["gn_roofline.sample"] == pytest.approx(25.0)
    assert read["conv_gemm_roofline.sample"] == pytest.approx(50.0)
    assert read["idle_share.sample"] == pytest.approx(100 * (1 - 1.5 / 1.8))
    assert read["mfu.sample"] == pytest.approx(100 * (4.95e12 + 9.9e13) / 495e12 / 2.0)
    assert read["decode_share.sample"] == pytest.approx(25.0)


def test_roofline_reads_nothing_without_its_kernels():
    t = _trace({"attention": 0.0, "groupnorm": 0.04, "conv_gemm": 0.4})
    assert core.load_module("metrics", "attn_roofline.sample").read(t) is None
