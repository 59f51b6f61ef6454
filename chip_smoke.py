"""Smoke run of the PyTorch / CUDA port (``diff_sampler_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each printing as it goes:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, nvcc, whether triton imports.
2. Build kernel K1 (flash-attention forward) from ``csrc/`` with nvcc.
3. K1 against its plain PyTorch version at the main path's shapes, on the
   strided q/k/v views that ``attention()`` hands it: max abs error of the
   output and of the log-sum-exp against stated tolerances, and both times
   (CUDA events, after warm-up, in turns).
4. The full-width CIFAR-10 EDMPrecond, random weights redrawn at unit scale:
   D(x, sigma) in f32 with K1 against the plain attention, TF32 off; K1 runs
   6 times per forward.
5. The main path: ``generate`` on 256 seeds, batch 256, bf16 inner model,
   ipndm on the poly-7 schedule at NFE 5/10/35; finite output, per-seed
   rows, K1 launches = 6 x NFE x batches, images/sec; then the sampling CLI
   on the same seeds, whose PNGs must encode the NFE-5 images exactly.

The last two lines are a JSON object on the kernels and
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero with no result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from diff_sampler_tpu_torch import _build
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.models import layers
from diff_sampler_tpu_torch.models.factory import create_model
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.ops import attention as A
from diff_sampler_tpu_torch.sampling import SolverConfig, generate, to_uint8
from diff_sampler_tpu_torch.utils.image import encode_png
from diff_sampler_tpu_torch.utils.rng import stacked_randn

# Tolerances of K1 against the plain version on identical inputs.  f32: both
# accumulate in f32 in other orders.  bf16: the output is rounded to bf16 on
# both sides, so they may differ by one bf16 step at |out| < 4 (2^-6), and
# the softmax weights by one bf16 rounding each; the lse is f32 on both.
OUT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -5}
LSE_TOL = 1e-5
# (B, T, H, d, dtype): the CIFAR-10 path's two attention shapes at batch 256
# in both dtypes, a later slice's d=64 multi-head shape, and a ragged T.
K1_SHAPES = [
    (256, 256, 1, 256, torch.bfloat16),
    (256, 256, 1, 256, torch.float32),
    (256, 64, 1, 256, torch.bfloat16),
    (256, 64, 1, 256, torch.float32),
    (8, 1024, 4, 64, torch.bfloat16),
    (16, 200, 2, 64, torch.bfloat16),
    (16, 200, 2, 64, torch.float32),
]
ATTENTION_SITES = 6  # per CIFAR-10 SongUNet forward (models/unets.py layout)
BATCH = 256
NFE_STEPS = [(5, 6), (10, 11), (35, 36)]  # (NFE, num_steps) for ipndm


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _run(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment() -> str:
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0] if smi else "nvidia-smi printed nothing"
    print(smi)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"python {sys.version.split()[0]}")
    print(f"[env] nvcc: {_run([_build.find_nvcc(), '--version']).splitlines()[-1]}")
    try:
        import triton
        print(f"[env] triton {triton.__version__} imports")
    except ImportError as e:
        print(f"[env] triton does not import: {e}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    if _build.build_seconds is None:
        print(f"[build] K1 library already built, loaded in {time.perf_counter() - t0:.3f} s")
    else:
        print(f"[build] K1 built with nvcc in {_build.build_seconds:.2f} s "
              f"({' '.join(_build.NVCC_FLAGS)})")
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


def _qkv_views(b, t, h, d, dtype, g):
    """q, k, v as attention() takes them: strided views of one [B, T, 3*H*d]
    projection whose channels factor as (head, c, qkv)."""
    qkv = torch.randn(b, t, h * d * 3, generator=g, device="cuda").to(dtype)
    return qkv.reshape(b, t, h, d, 3).unbind(-1)


def phase_kernel() -> dict:
    g = torch.Generator("cuda").manual_seed(0)
    main = None
    for b, t, h, d, dtype in K1_SHAPES:
        q, k, v = _qkv_views(b, t, h, d, dtype, g)
        scale = d ** -0.5
        out, lse = A.flash_attention_mh(q, k, v, scale)
        ref_out, ref_lse = A.reference_sdpa(q, k, v, scale)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        kernel = lambda: A.flash_attention_mh(q, k, v, scale)  # noqa: E731
        plain = lambda: A.reference_sdpa(q, k, v, scale)  # noqa: E731
        k1, p1, p2, k2 = _time_ms(kernel), _time_ms(plain), _time_ms(plain), _time_ms(kernel)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        name = str(dtype).replace("torch.", "")
        print(f"[K1] B={b} T={t} H={h} d={d} {name}: out err {err_out:.3g} "
              f"(tol {OUT_TOL[dtype]:.3g}), lse err {err_lse:.3g} (tol {LSE_TOL:.3g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        _check(err_out <= OUT_TOL[dtype] and err_lse <= LSE_TOL,
               f"K1 disagrees with the plain version at {(b, t, h, d, name)}")
        if main is None:  # the first shape is the main path's
            main = dict(max_abs_err=err_out, ms=ms, plain_ms=plain_ms)
    return main


@torch.no_grad()
def _redraw_unit_scale(module, seed: int) -> None:
    """Replace every parameter by a seeded draw of unit scale (weights over
    sqrt(fan_in)): a random-init EDM net outputs ~1e-5 through its zero-init
    convs, which would hide the attention from D(x, sigma)."""
    g = torch.Generator().manual_seed(seed)
    for p in module.parameters():
        fan_in = p[0].numel() if p.dim() > 1 else 1
        p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))


def phase_denoiser_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[D f32] torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    module, _ = create_model("cifar10", "random", device="cuda")
    _redraw_unit_scale(module, seed=1)
    den = bind(module)
    sigma = torch.tensor([80.0, 10.0, 1.0, 0.1] * 2, device="cuda")
    x = stacked_randn(range(8), (32, 32, 3), device="cuda") * sigma[:, None, None, None]

    before = A.flash_attention_mh.launches
    d_kernel = den(x, sigma)
    launched = A.flash_attention_mh.launches - before
    real_sdpa = layers.sdpa
    layers.sdpa = lambda q, k, v, scale=None: A.reference_sdpa(q, k, v, scale)[0]
    try:
        d_plain = den(x, sigma)
    finally:
        layers.sdpa = real_sdpa
    torch.cuda.synchronize()
    err = (d_kernel - d_plain).abs().max().item()
    bound = 1e-4 * d_plain.abs().max().item()
    print(f"[D f32] full-width CIFAR-10 EDMPrecond, sigma {sigma.tolist()}: max|D| "
          f"{d_plain.abs().max().item():.4g}, K1 vs plain attention max abs err {err:.3g} "
          f"(tol 1e-4 * max|D| = {bound:.3g}), K1 launches per forward {launched}")
    _check(torch.isfinite(d_kernel).all().item(), "D(x, sigma) is not finite")
    _check(launched == ATTENTION_SITES, f"{launched} K1 launches in one forward")
    _check(err <= bound, "D(x, sigma) with K1 disagrees with the plain attention")


def phase_main_path() -> int:
    module, _ = create_model("cifar10", "random", dtype=torch.bfloat16, device="cuda")
    den = bind(module)
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    seeds = list(range(BATCH))
    # warm-up: first-call costs (cuDNN plans, allocator) stay out of the timing
    generate(den, seeds, shape, SolverConfig(solver="ipndm", num_steps=6),
             max_batch_size=BATCH, device="cuda")
    torch.cuda.synchronize()

    A.flash_attention_mh.launches = 0
    expected = 0
    images = {}
    for nfe, steps in NFE_STEPS:
        cfg = SolverConfig(solver="ipndm", num_steps=steps, schedule_type="polynomial",
                           schedule_rho=7.0)
        _check(cfg.nfe() == nfe, f"ipndm at {steps} steps is NFE {cfg.nfe()}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        images[nfe] = generate(den, seeds, shape, cfg, max_batch_size=BATCH, device="cuda")
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        device_s = start.elapsed_time(end) / 1000
        expected += ATTENTION_SITES * nfe * math.ceil(len(seeds) / BATCH)
        print(f"[main] ipndm NFE {nfe}, batch {BATCH}, bf16: {BATCH / device_s:.2f} images/s "
              f"(CUDA events, {device_s:.4f} s; host clock {host_s:.4f} s); "
              f"K1 launches so far {A.flash_attention_mh.launches}, expected {expected}")
    launches = A.flash_attention_mh.launches
    _check(launches == expected, f"K1 launched {launches} times on the main path, "
                                 f"expected {expected}")
    for nfe, x in images.items():
        _check(x.shape == (BATCH, *shape) and np.isfinite(x).all(),
               f"NFE {nfe} output is not finite or has shape {x.shape}")

    few = generate(den, seeds[:8], shape, SolverConfig(solver="ipndm", num_steps=6),
                   max_batch_size=8, device="cuda")
    err = np.abs(few - images[5][:8]).max()
    bound = 1e-2 * np.abs(images[5][:8]).max()
    print(f"[main] seeds 0-7 at batch 8 vs batch 256, NFE 5: max abs diff {err:.3g} "
          f"(tol 1e-2 * max|x| = {bound:.3g}; cuDNN may pick other bf16 conv algorithms)")
    _check(err <= bound, "per-seed rows depend on the batch")

    # the CLI, as a user runs it: same seeds, weights and config as the NFE-5
    # run, so its PNGs must be byte for byte the encoding of that run's images
    with tempfile.TemporaryDirectory() as outdir:
        cli_sample.main(["--dataset_name=cifar10", "--model_path=random", "--solver=ipndm",
                         "--num_steps=6", f"--seeds=0-{BATCH - 1}", f"--batch={BATCH}",
                         "--bf16=True", "--device=cuda", f"--outdir={outdir}"])
        want = to_uint8(images[5])
        same = 0
        for i, seed in enumerate(seeds):
            with open(os.path.join(outdir, f"{seed - seed % 1000:06d}", f"{seed:06d}.png"),
                      "rb") as f:
                same += f.read() == encode_png(want[i])
        print(f"[main] CLI wrote {same} of {BATCH} PNGs identical to the NFE-5 run's images")
        _check(same == BATCH, "CLI PNGs differ from generate's images")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = phase_environment()
    phase_build()
    k1 = phase_kernel()
    phase_denoiser_f32()
    launches = phase_main_path()
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_mh (K1, multi-head flash-attention forward)",
        "route": "cuda",
        "source": "diff_sampler_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "diff_sampler_tpu/ops/pallas_attention.py:157",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
