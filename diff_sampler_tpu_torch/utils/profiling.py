"""Tick timing of training loops, and device-time breakdowns of profiles.

``Timer`` is the counterpart of ``diff_sampler_tpu/utils/profiling.py::Timer``.
The host clock measures whole ticks; the caller synchronises the device
first (the trainer reads its loss, which waits for the step).

``device_breakdown`` sorts the device events of a ``torch.profiler`` Chrome
trace into ``CATEGORIES`` by kernel name and computes the device's idle
share over the traced span.
"""

from __future__ import annotations

import re
import time
from typing import Dict, Iterable

__all__ = ["CATEGORIES", "Timer", "device_breakdown"]

# (category, pattern on the kernel name); the first match wins.  Kernels of
# this package by their CUDA names (K1: flash_fwd_tc_kernel in bf16,
# flash_fwd_tf32_kernel in f32, both on the tensor cores; K1c: the f32
# kernel's flat entry flash_fwd_tf32_flat_kernel, while bf16 K1c runs as
# flash_fwd_tc_kernel; the names of the earlier f32 kernels on the CUDA
# cores, flash_fwd_kernel and flash_fwd_flat_kernel, file the same way; K2 /
# K2c: flash_bwd_{dq,dkv}_bf16_kernel in bf16 (K2c as one head, so under K2)
# and flash_bwd_{dq,dkv}_tf32[_flat]_kernel in f32, both on the tensor cores,
# and the earlier CUDA-core names flash_bwd_{dq,dkv}[_flat]_kernel; K3: the
# one-kernel cluster slab gn_slab_kernel, or the streamed pass's
# gn_stream_stats_kernel and gn_stream_apply_kernel), then
# cuDNN / cuBLAS / CUTLASS GEMM and conv kernels, PyTorch's reductions, then
# its elementwise and copy kernels.
CATEGORIES = [
    ("K1c", r"flash_fwd_(tf32_)?flat_kernel"),
    ("K2c dQ", r"flash_bwd_dq_(tf32_)?flat_kernel"),
    ("K2c dK/dV", r"flash_bwd_dkv_(tf32_)?flat_kernel"),
    ("K1", r"flash_fwd_(tc_|tf32_)?kernel"),
    ("K2 dQ", r"flash_bwd_dq_(tf32_|bf16_)?kernel"),
    ("K2 dK/dV", r"flash_bwd_dkv_(tf32_|bf16_)?kernel"),
    ("K3", r"gn_slab_kernel|gn_stream_stats_kernel|gn_stream_apply_kernel"),
    ("convs and GEMMs", r"conv|cudnn|implicit|gemm|xmma|cutlass|winograd|fft"),
    ("reductions", r"reduce|Reduce|softmax"),
    ("elementwise", r"elementwise|Elementwise|CatArray|copy|index|where|fill"),
]
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Timer:
    """sec/tick and sec/kimg between ``tick`` calls."""

    def __init__(self):
        self.start_time = time.time()
        self.tick_start = self.start_time
        self.tick_start_nimg = 0

    def tick(self, cur_nimg: int) -> Dict[str, float]:
        now = time.time()
        out = {
            "total_sec": now - self.start_time,
            "sec_per_tick": now - self.tick_start,
            "sec_per_kimg": (now - self.tick_start) * 1000.0
            / max(cur_nimg - self.tick_start_nimg, 1),
        }
        self.tick_start = now
        self.tick_start_nimg = cur_nimg
        return out


def device_breakdown(trace_events: Iterable[dict]) -> Dict:
    """Device time of a Chrome trace's ``traceEvents`` (``ts``/``dur`` in us).

    Returns ``categories`` ({name: {"ms", "share", "calls"}}, shares of the
    summed device time, memcpy / memset and ``other`` included),
    ``device_ms`` (the sum), ``span_ms`` (first device start to last device
    end), ``busy_ms`` (the union of the device intervals), ``idle_share``
    (1 - busy / span) and ``top`` (the 15 costliest kernel names, ms).
    """
    rules = [(name, re.compile(pat)) for name, pat in CATEGORIES]
    names = [name for name, _ in CATEGORIES] + ["memcpy / memset", "other"]
    cats: Dict[str, Dict] = {name: {"ms": 0.0, "calls": 0} for name in names}
    by_name: Dict[str, float] = {}
    spans = []
    for ev in trace_events:
        if ev.get("ph") != "X" or ev.get("cat") not in _DEVICE_CATS:
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((start, start + dur))
        name = ev.get("name", "")
        if ev["cat"] != "kernel":
            cat = "memcpy / memset"
        else:
            cat = next((c for c, rule in rules if rule.search(name)), "other")
        cats[cat]["ms"] += dur / 1e3
        cats[cat]["calls"] += 1
        by_name[name] = by_name.get(name, 0.0) + dur / 1e3
    if not spans:
        raise ValueError("the trace holds no device events")
    spans.sort()  # the union of the intervals, merged in order of start
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in spans) - spans[0][0]
    total = sum(c["ms"] for c in cats.values())
    for c in cats.values():
        c["share"] = c["ms"] / total if total else 0.0
    return {"categories": cats, "device_ms": total, "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / span if span else 0.0,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:15]}
