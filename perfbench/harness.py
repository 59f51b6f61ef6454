"""One run of one cell: set-up, the window, the per-layer readings, the
comparison with the reference, and the result line.

``run_cell`` is what ``run.py`` calls once it has found the card; the tests
call it on the CPU at a tiny size.  It times set-up by phase, hands the
traffic's driver a ``RunContext``, and turns what the driver returns into
the contract's last line.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Optional

import torch

from . import trace as trace_mod
from .core import cell as load_cell
from .core import load_module, loaded_forbidden, peaks

GIB = float(1 << 30)


class RunContext:
    """What a driver gets: the cell's files, the run's arguments, the
    device, set-up phases and the device calls that have no CPU
    counterpart."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device: str,
                 dtype: torch.dtype, started: float):
        self.cell = cell
        self.config, self.traffic, self.check = cell["config"], cell["traffic"], cell["check"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.dtype = device, dtype
        self.started = started
        self.setup = {}
        self.setup_s: Optional[float] = None
        self.cuda = torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        yield
        self.sync()
        self.setup[name] = self.setup.get(name, 0.0) + time.perf_counter() - t

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def window_start(self):
        """The timed work begins: the peak memory counts from here, and
        set-up up to here (a driver adds the batch that fills its pipeline)."""
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.perf_counter() - self.started

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def profiler_activities(self):
        """The profiler's activities: the host's operators and the
        benchmark's spans, and the device's."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    @contextlib.contextmanager
    def reference_precision(self):
        """The reference's f32 with TF32 off in cuBLAS and cuDNN, the flags
        restored after."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def device_info(device: str) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def _per_layer(cell: dict, t: dict, kind: str) -> dict:
    reading = dict(t)
    reading["peaks"] = peaks(kind)
    out = {}
    for m in cell["per_layer"]:
        value = load_module("metrics", m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(readings: dict, limits: dict, failed: int):
    """(correct, {name: {"value", "limit"}}): every limited reading at or
    under its limit, and no answer failed."""
    checks = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    correct = failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             dtype: torch.dtype = torch.float32, started: Optional[float] = None,
             cell: Optional[dict] = None, log=sys.stderr) -> dict:
    """Run cell ``name`` once; returns the result line as a dict (with
    ``readings``, every number the comparison computed, under a key of its
    own for the calibration)."""
    started = time.perf_counter() if started is None else started
    cell = load_cell(name) if cell is None else cell
    ctx = RunContext(cell, seed, seconds, trace, device, dtype, started)
    ctx.setup["imports"] = time.perf_counter() - started
    with ctx.phase("device"):
        torch.empty(1, device=device)
    with ctx.phase("library"):
        # the system's CUDA kernels, built at first use into a fixed
        # directory of the checkout: a build on a checkout's first run only
        from diff_sampler_tpu_torch import _build

        if ctx.cuda and hasattr(_build, "load_library"):
            _build.load_library()
    if trace:
        with ctx.phase("profiler"):
            # the profiler's first start costs seconds of host time (its
            # modules and CUPTI load): paid here, not in the traced window
            with torch.profiler.profile(activities=ctx.profiler_activities()):
                with torch.profiler.record_function("warm-up"):
                    torch.ones(8, device=device).sum().item()
    driver = load_module("drivers", cell["traffic"]["driver"])
    res = driver.run(ctx)
    dev = device_info(device)
    dev["memory_peak_bytes"] = int(res["peak_bytes"])
    bad = loaded_forbidden()
    if bad:
        raise RuntimeError(f"modules of {bad} are loaded: nothing the benchmark runs may "
                           f"import them")
    metrics = {}
    breakdown = None
    if trace:
        t = res["trace"]
        red = trace_mod.reduce(trace_mod.chrome_events(t.pop("prof")), t["spans"])
        t.update(red)
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = t["window_s"]
        metrics = _per_layer(cell, t, dev["kind"])
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        print("device s by op class: " + ", ".join(
            f"{k} {v:.4f}" for k, v in red["class_s"].items()) +
            f"; busy {red['busy_s']:.4f} of a {red['span_s']:.4f} span", file=log)
    else:
        values = dict(res["e2e"])
        values["peak_mem_gib"] = res["peak_bytes"] / GIB
        values["setup_s"] = ctx.setup_s
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    correct, checks = judge(res["readings"], cell["check"]["limits"], res["failed"])
    split = ", ".join(f"{k} {v:.3f} s" for k, v in ctx.setup.items())
    print(f"setup: {ctx.setup_s:.3f} s to the window ({split})", file=log)
    print(f"window: {res['units']} {cell['traffic'].get('unit', 'images')} in "
          f"{res['window_s']:.3f} s", file=log)
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in res["readings"].items()), file=log)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=log)
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["readings"] = res["readings"]
    line["checks"] = checks
    return line
