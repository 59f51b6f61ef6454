"""Smoke run of the PyTorch / CUDA port (``diff_sampler_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each printing as it goes:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, nvcc, whether triton imports.
2. Build kernels K1 (flash-attention forward) and K2 (its backward) from
   ``csrc/`` with nvcc, one process per source; print each kernel's
   registers and spills.
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
6. Kernel K2 (flash-attention backward: the dQ and the dK/dV kernels)
   against its plain PyTorch version at the AMED path's shapes (batch 512,
   T=256 and T=64, H=1, d=256) in f32 and bf16, a d=64 multi-head shape and
   a ragged T, on the strided q/k/v views and a non-contiguous dO: max abs
   error of dq, dk and dv against stated tolerances, both times (CUDA
   events, in turns), and bit-identical results from two runs.
7. The gradient of sum(D(x, sigma) * g) with respect to x and sigma through
   the full-width f32 CIFAR-10 EDMPrecond (unit-scale weights, TF32 off),
   with K1 + K2 against the plain attention; K2 runs 6 times per backward.
8. The AMED path: ``cli.train_amed`` at the CLI defaults (batch 512 at
   once, f32 net, 4 steps, student amed, teacher heun) for two iterations,
   with peak memory and sec/kimg; the loss is finite, the predictor moves,
   its files are written, and K1 / K2 launch exactly as predicted.  Then
   ``cli.sample --predictor`` on 256 seeds from the saved predictor: finite
   images, K1 launches = 6 x NFE, images/sec.

The last two lines are a JSON object on the kernels (K1's launches are
those of phase 5, K2's those of phase 8) and
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero with no result; so does a machine without CUDA.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from diff_sampler_tpu_torch import _build
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed as cli_train_amed
from diff_sampler_tpu_torch.models import layers
from diff_sampler_tpu_torch.models.convert import params_to_jax
from diff_sampler_tpu_torch.models.factory import create_model, init_params
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.ops import attention as A
from diff_sampler_tpu_torch.sampling import SolverConfig, generate, to_uint8
from diff_sampler_tpu_torch.training.amed import AMEDConfig, predictor_from_config
from diff_sampler_tpu_torch.utils import checkpoint as ckpt
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
# (B, T, H, d, dtype) of K2: the AMED path's two attention shapes at the CLI's
# batch 512 in both dtypes, a later slice's d=64 multi-head shape, a ragged T.
K2_SHAPES = [
    (512, 256, 1, 256, torch.float32),
    (512, 256, 1, 256, torch.bfloat16),
    (512, 64, 1, 256, torch.float32),
    (512, 64, 1, 256, torch.bfloat16),
    (8, 1024, 4, 64, torch.bfloat16),
    (8, 1024, 4, 64, torch.float32),
    (16, 200, 2, 64, torch.float32),
    (16, 200, 2, 64, torch.bfloat16),
]
# Tolerance of K2 against the plain version, relative to max|plain grad|.
# f32: both sum in f32 in other orders.  bf16: both round P, dS and the
# grads to bf16 from f32 values that may differ in the last f32 bit, so a
# grad may land one bf16 step (2^-7 of its scale) away, plus the rare P or
# dS term rounded the other way: 2^-6.
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# The AMED path (cli/train_amed.py defaults): 4 steps, student amed (one
# net call with a gradient per segment), teacher heun with M=1 inserted
# step per segment.
AMED_BATCH = 512  # fits at once: no --batch_gpu accumulation (57 GiB, PERF.md)
AMED_STEPS = 4
AMED_KIMG = 1
AMED_ITERS = math.ceil(AMED_KIMG * 1000 / AMED_BATCH)  # 2


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
        print(f"[build] K1/K2 library already built, loaded in {time.perf_counter() - t0:.3f} s")
        return
    print(f"[build] K1 and K2 built with nvcc in {_build.build_seconds:.2f} s, one process "
          f"per source ({' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_log.splitlines():
        # ptxas names each kernel by its mangled name: print it as
        # flash_<...>_kernel<dtype, D>, then its registers and spills
        entry = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(13__nv_bfloat16|f)Li(\d+)E",
                          line)
        if entry and "Compiling entry function" in line:
            dtype = "bf16" if entry.group(2) != "f" else "f32"
            print(f"[build] {entry.group(1)}<{dtype}, d={entry.group(3)}>:")
        elif "registers" in line or "spill" in line:
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


def _strided_do(b, t, h, d, dtype, g):
    """A non-contiguous dO: the [B, T, H, d] transpose of a [B, H, T, d]."""
    return torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype).transpose(1, 2)


def phase_backward_kernel() -> dict:
    g = torch.Generator("cuda").manual_seed(2)
    main = None
    for b, t, h, d, dtype in K2_SHAPES:
        q, k, v = _qkv_views(b, t, h, d, dtype, g)
        do = _strided_do(b, t, h, d, dtype, g)
        scale = d ** -0.5
        out, lse = A.flash_attention_mh(q, k, v, scale)
        grads = A.flash_attention_mh_bwd(q, k, v, out, lse, do, scale)
        again = A.flash_attention_mh_bwd(q, k, v, out, lse, do, scale)
        ref = A.reference_sdpa_bwd(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        errs = [(x.float() - y.float()).abs().max().item() for x, y in zip(grads, ref)]
        tols = [K2_TOL[dtype] * y.float().abs().max().item() for y in ref]
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        delta = torch.einsum("bthd,bthd->bht", do.float(), out.float()).contiguous()
        do_c = do.to(dtype)
        times = {}
        for name, kernel, plain in (
                ("dq", lambda: A.flash_attention_bwd_dq(q, k, v, do_c, lse, delta, scale),
                 lambda: A.reference_sdpa_bwd_dq(q, k, v, do_c, lse, delta, scale)),
                ("dkv", lambda: A.flash_attention_bwd_dkv(q, k, v, do_c, lse, delta, scale),
                 lambda: A.reference_sdpa_bwd_dkv(q, k, v, do_c, lse, delta, scale)),
                ("bwd", lambda: A.flash_attention_mh_bwd(q, k, v, out, lse, do, scale),
                 lambda: A.reference_sdpa_bwd(q, k, v, out, lse, do, scale))):
            k1, p1, p2, k2 = (_time_ms(kernel, reps=5), _time_ms(plain, reps=5),
                              _time_ms(plain, reps=5), _time_ms(kernel, reps=5))
            times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        name = str(dtype).replace("torch.", "")
        print(f"[K2] B={b} T={t} H={h} d={d} {name}: max abs err dq {errs[0]:.3g} "
              f"(tol {tols[0]:.3g}), dk {errs[1]:.3g} (tol {tols[1]:.3g}), dv {errs[2]:.3g} "
              f"(tol {tols[2]:.3g}); two runs bit-identical: {same}; kernel vs plain ms: "
              f"dQ {times['dq'][0]:.4f} vs {times['dq'][1]:.4f}, dK/dV {times['dkv'][0]:.4f} "
              f"vs {times['dkv'][1]:.4f}, whole backward {times['bwd'][0]:.4f} vs "
              f"{times['bwd'][1]:.4f}")
        _check(all(e <= tol for e, tol in zip(errs, tols)),
               f"K2 disagrees with the plain version at {(b, t, h, d, name)}")
        _check(same, f"K2 is not deterministic at {(b, t, h, d, name)}")
        if main is None:  # the first shape is the AMED path's
            main = dict(dq=dict(max_abs_err=errs[0], ms=times["dq"][0], plain_ms=times["dq"][1]),
                        dkv=dict(max_abs_err=max(errs[1:]), ms=times["dkv"][0],
                                 plain_ms=times["dkv"][1]))
    return main


def phase_gradient_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    module, _ = create_model("cifar10", "random", device="cuda")
    _redraw_unit_scale(module, seed=1)
    module.requires_grad_(False)
    sigma0 = torch.tensor([80.0, 10.0, 1.0, 0.1] * 2, device="cuda")
    x0 = stacked_randn(range(8), (32, 32, 3), device="cuda") * sigma0[:, None, None, None]
    cot = stacked_randn(range(100, 108), (32, 32, 3), device="cuda")

    def grads():
        x, sigma = x0.clone().requires_grad_(), sigma0.clone().requires_grad_()
        (module(x, sigma) * cot).sum().backward()
        return x.grad, sigma.grad

    before = (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches)
    gx, gs = grads()
    launched = (A.flash_attention_bwd_dq.launches - before[0],
                A.flash_attention_bwd_dkv.launches - before[1])
    real_sdpa = layers.sdpa
    layers.sdpa = lambda q, k, v, scale=None: A.reference_sdpa(q, k, v, scale)[0]
    try:
        px, ps = grads()
    finally:
        layers.sdpa = real_sdpa
    torch.cuda.synchronize()
    for name, got, want in (("x", gx, px), ("sigma", gs, ps)):
        err = (got - want).abs().max().item()
        bound = 1e-4 * want.abs().max().item()
        print(f"[grad f32] full-width CIFAR-10 EDMPrecond, batch 8: d sum(D * g) / d{name}: "
              f"max|grad| {want.abs().max().item():.4g}, K1+K2 vs plain attention max abs "
              f"err {err:.3g} (tol 1e-4 * max|grad| = {bound:.3g})")
        _check(torch.isfinite(got).all().item(), f"the gradient in {name} is not finite")
        _check(err <= bound, f"the gradient in {name} with K2 disagrees with the plain one")
    print(f"[grad f32] K2 launches per backward: dQ {launched[0]}, dK/dV {launched[1]}")
    _check(launched == (ATTENTION_SITES, ATTENTION_SITES),
           f"K2 launched {launched} times in one backward")


def _reset_counts() -> None:
    A.flash_attention_mh.launches = 0
    A.flash_attention_bwd_dq.launches = 0
    A.flash_attention_bwd_dkv.launches = 0


def phase_amed(workdir: str) -> dict:
    # the trainer as a user runs it: torch's default precision flags
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[AMED] torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    outdir = os.path.join(workdir, "exps")
    argv = ["--dataset_name=cifar10", "--model_path=random", f"--batch={AMED_BATCH}",
            f"--num_steps={AMED_STEPS}", f"--total_kimg={AMED_KIMG}", "--device=cuda",
            f"--outdir={outdir}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run_dir = cli_train_amed.main(argv)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1000
    launches = dict(k1=A.flash_attention_mh.launches, dq=A.flash_attention_bwd_dq.launches,
                    dkv=A.flash_attention_bwd_dkv.launches)
    peak = torch.cuda.max_memory_allocated()
    # per iteration and microbatch (one: batch / batch_gpu = 1): the heun
    # teacher makes 2 calls per fine step, M + 1 = 2 fine steps per segment;
    # the amed student 2 calls per segment, the second one differentiated
    segments = AMED_STEPS - 1
    want_k1 = ATTENTION_SITES * (2 * 2 * segments + 2 * segments) * AMED_ITERS
    want_k2 = ATTENTION_SITES * segments * AMED_ITERS
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    kimg = AMED_ITERS * AMED_BATCH / 1000
    print(f"[AMED] train_amed: batch {AMED_BATCH}, no batch_gpu, f32 net, "
          f"{AMED_ITERS} iterations: whole CLI call {host_s:.3f} s host clock, "
          f"{device_s:.3f} s CUDA events ({device_s / kimg:.3f} s/kimg); per-tick sec/kimg "
          f"(host clock) {[round(tk['sec_per_kimg'], 3) for tk in ticks]}; "
          f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB")
    print(f"[AMED] launches: K1 {launches['k1']} (expected {want_k1}), K2 dQ {launches['dq']}, "
          f"K2 dK/dV {launches['dkv']} (expected {want_k2} each)")
    losses = [tk["Loss/loss"]["mean"] for tk in ticks]
    _check(len(ticks) == AMED_ITERS and all(math.isfinite(x) for x in losses),
           f"AMED losses {losses} are not finite")
    for name in ("predictor_config.json", "stats.jsonl", "predictor.npz"):
        _check(os.path.isfile(os.path.join(run_dir, name)), f"train_amed wrote no {name}")
    _check(launches["k1"] == want_k1, "K1 launch count of the AMED training")
    _check(launches["dq"] == want_k2 and launches["dkv"] == want_k2,
           "K2 launch count of the AMED training")
    # the predictor moved: its saved weights differ from a fresh init's
    cfg = AMEDConfig(**ckpt.load_config(os.path.join(run_dir, "predictor_config.json")))
    fresh = init_params(predictor_from_config(cfg), seed=0)
    saved = ckpt.load_params(os.path.join(run_dir, "predictor.npz"))["params"]
    moved = max(float(np.abs(saved[layer][leaf] - ref).max())
                for layer, leaves in params_to_jax(fresh.state_dict()).items()
                for leaf, ref in leaves.items())
    print(f"[AMED] losses per tick {losses}; predictor moved by max abs {moved:.4g}")
    _check(moved > 0, "the predictor did not move")

    # sampling from the saved predictor, through the CLI
    nfe = 2 * (AMED_STEPS - 1)
    seen = []
    real_to_uint8 = cli_sample.to_uint8

    def checked_to_uint8(x):
        seen.append(bool(np.isfinite(x).all()) and x.shape[1:] == (32, 32, 3))
        return real_to_uint8(x)

    _reset_counts()
    cli_sample.to_uint8 = checked_to_uint8
    out = os.path.join(workdir, "amed_samples")
    t0 = time.perf_counter()
    try:
        cli_sample.main(["--dataset_name=cifar10", f"--predictor={run_dir}",
                         f"--seeds=0-{BATCH - 1}", f"--batch={BATCH}", "--device=cuda",
                         f"--outdir={out}"])
    finally:
        cli_sample.to_uint8 = real_to_uint8
    cli_s = time.perf_counter() - t0
    k1 = A.flash_attention_mh.launches
    pngs = glob.glob(os.path.join(out, "*", "*.png"))
    print(f"[AMED] sample --predictor: {len(pngs)} PNGs, finite batches {seen}, K1 launches "
          f"{k1} (expected {ATTENTION_SITES * nfe}), whole CLI call {cli_s:.3f} s host clock")
    _check(len(pngs) == BATCH and seen and all(seen), "AMED samples are missing or not finite")
    _check(k1 == ATTENTION_SITES * nfe, "K1 launch count of the AMED sampling")
    # images/sec of the sampler alone, after a warm-up call
    module, _ = create_model("cifar10", "random", device="cuda")
    fn, _ = cli_sample.build_amed_sample_fn(module, run_dir, "cuda")
    lat = stacked_randn(range(BATCH), (32, 32, 3), device="cuda")
    fn(lat)
    start.record()
    t0 = time.perf_counter()
    x = fn(lat)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1000
    print(f"[AMED] AMED sampling, NFE {nfe}, batch {BATCH}, f32 net: {BATCH / device_s:.2f} "
          f"images/s (CUDA events, {device_s:.4f} s; host clock {host_s:.4f} s)")
    _check(torch.isfinite(x).all().item(), "AMED samples are not finite")
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
    k2 = phase_backward_kernel()
    phase_gradient_f32()
    with tempfile.TemporaryDirectory() as workdir:
        amed = phase_amed(workdir)
    print(smi)
    source = "diff_sampler_tpu_torch/csrc/flash_attn_bwd.cu"
    print(json.dumps({"kernels": [{
        "name": "flash_attention_mh (K1, multi-head flash-attention forward)",
        "route": "cuda",
        "source": "diff_sampler_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "diff_sampler_tpu/ops/pallas_attention.py:157",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }, {
        "name": "flash_attention_bwd_dq (K2, flash-attention backward, dQ)",
        "route": "cuda",
        "source": source,
        "replaces": "diff_sampler_tpu/ops/pallas_attention.py:406",
        "launches": amed["dq"],
        **k2["dq"],
    }, {
        "name": "flash_attention_bwd_dkv (K2, flash-attention backward, dK/dV)",
        "route": "cuda",
        "source": source,
        "replaces": "diff_sampler_tpu/ops/pallas_attention.py:554",
        "launches": amed["dkv"],
        **k2["dkv"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
