"""The device trace of a traced window, reduced to what the per-layer
metrics read.

``reduce`` takes a ``torch.profiler`` Chrome trace and gives the device time
of each op class (kernel names matched against ``kernels/<op>/*.json`` in
the order attention, groupnorm, conv_gemm; a kernel no pattern names counts
in no class), the union of the device's busy intervals over the span from
its first start to its last end (the interval arithmetic of
``diff_sampler_tpu_torch/utils/profiling.py::device_breakdown``, frozen
here), the costliest device operations, and the device's idle time by the
benchmark span the host was in when each gap began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List

from .core import kernel_patterns

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def chrome_events(prof) -> List[dict]:
    """The trace events of a finished ``torch.profiler.profile``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _union(intervals):
    """Merged busy intervals, in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: List[dict], span_names=()) -> Dict:
    """``class_s`` {op class: device seconds}, ``busy_s``, ``span_s`` (first
    device start to last device end), ``device_ops`` (top 10 [name, s]) and
    ``idle_gaps`` (top 10 [host span, idle s]); times in seconds."""
    patterns = kernel_patterns()
    class_s = {op: 0.0 for op in patterns}
    by_name: Dict[str, float] = {}
    intervals = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        intervals.append((start, start + dur))
        name = ev.get("name", "")
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
        if ev["cat"] == "kernel":
            op = next((op for op, pats in patterns.items() if any(p.search(name) for p in pats)),
                      None)
            if op is not None:
                class_s[op] += dur * 1e-6
    if not intervals:
        return {"class_s": class_s, "busy_s": 0.0, "span_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    busy = _union(intervals)
    busy_us = sum(e - s for s, e in busy)
    span_us = busy[-1][1] - busy[0][0]
    spans = sorted(((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)), ev["name"])
                    for ev in events if ev.get("ph") == "X" and ev.get("name") in span_names),
                   key=lambda s: s[1] - s[0])
    calls = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)), ev["name"])
                   for ev in events if ev.get("ph") == "X" and ev.get("cat") == "cuda_runtime")
    starts = [c[0] for c in calls]

    def label(t):
        """The innermost benchmark span the host was in at ``t``; in a
        trace without them, the CUDA runtime call it was in."""
        if spans:
            return next((n for s, e, n in spans if s <= t < e), "outside the spans")
        i = bisect.bisect_right(starts, t) - 1
        return calls[i][2] if i >= 0 and calls[i][1] > t else "host, outside CUDA calls"

    idle: Dict[str, float] = {}
    for (_, gap_start), (gap_end, _) in zip(busy[:-1], busy[1:]):
        name = label(gap_start)
        idle[name] = idle.get(name, 0.0) + (gap_end - gap_start) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"class_s": class_s, "busy_s": busy_us * 1e-6, "span_s": span_us * 1e-6,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
