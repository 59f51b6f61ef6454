"""Device-time profile of one AMED training iteration on one GPU.

  python -m diff_sampler_tpu_torch.cli.profile_amed

Builds the CIFAR-10 net (random weights, f32) and the trainer with
``cli.train_amed.build_trainer`` at the CLI's defaults (batch 512, 4 steps),
runs two iterations, then one more under ``torch.profiler`` (CPU and CUDA
activities).  Prints the iteration's host clock and CUDA-event time,
sec/kimg, peak memory, the kernel launch counts of K1, K2 and K3, and the device
time by category (``utils.profiling.CATEGORIES``: kernels sorted by name),
with the idle share and the costliest kernels.  The last line is the same
as one JSON object.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from ..ops import attention as A
from ..ops import groupnorm as G
from ..training.amed import AMEDConfig
from ..utils.profiling import device_breakdown
from ..utils.rng import stacked_randn
from .train_amed import build_trainer

WARMUP = 2  # iterations before the profiled one: cuDNN plans, the allocator
# Idle seconds on each side of the profiled iteration: the profiler keeps only
# the device records inside its window on the host's clock, which its
# device-to-host clock conversion can miss by a few ms at either edge.
MARGIN_S = 0.05


def _launches():
    return {"K1": A.flash_attention_mh.launches, "K2 dQ": A.flash_attention_bwd_dq.launches,
            "K2 dK/dV": A.flash_attention_bwd_dkv.launches, "K3": G.groupnorm_silu.launches}


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_amed needs a CUDA device")
    device = torch.device("cuda")
    cfg = AMEDConfig(dataset_name="cifar10")
    module, cfg, _, train_step, _ = build_trainer(cfg, "random", device)
    shape = (module.img_resolution, module.img_resolution, module.img_channels)

    def iteration(it):
        seeds = np.arange(it * cfg.batch, (it + 1) * cfg.batch).tolist()
        return float(train_step(stacked_randn(seeds, shape, device=device))["loss"].cpu())

    for it in range(WARMUP):
        iteration(it)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _launches()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(MARGIN_S)
        t0 = time.perf_counter()
        start.record()
        loss = iteration(WARMUP)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        time.sleep(MARGIN_S)
    device_s = start.elapsed_time(end) / 1000
    launches = {k: v - before[k] for k, v in _launches().items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = device_breakdown(events)
    out.update(host_s=host_s, cuda_event_s=device_s,
               sec_per_kimg=device_s * 1000 / cfg.batch, loss=loss, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, batch=cfg.batch,
               batch_gpu=cfg.batch_gpu, device=torch.cuda.get_device_name(0))
    print(f"[profile] one AMED iteration, {cfg.dataset_name}, batch {cfg.batch}, batch_gpu "
          f"{cfg.batch_gpu}, {cfg.num_steps} steps, f32 net, under torch.profiler: host clock "
          f"{host_s:.4f} s, CUDA events {device_s:.4f} s ({out['sec_per_kimg']:.4f} s/kimg), "
          f"loss {loss:.6g}, peak {out['peak_gib']:.3f} GiB, launches {launches}")
    print(f"[profile] device time {out['device_ms']:.3f} ms over a span of "
          f"{out['span_ms']:.3f} ms, busy {out['busy_ms']:.3f} ms, idle share "
          f"{out['idle_share']:.4f}")
    for name, c in sorted(out["categories"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"[profile]   {name:<16} {c['ms']:>11.3f} ms  {c['share']:.4f}  "
              f"{c['calls']} calls")
    for name, ms in out["top"]:
        print(f"[profile]   top {ms:>11.3f} ms  {name[:160]}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
