"""Smoke run of the PyTorch / CUDA port (``diff_sampler_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each printing as it goes:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, nvcc, whether triton imports.
2. Build kernels K1 (flash-attention forward) and K2 (its backward) from
   ``csrc/`` with nvcc, one process per source; print each kernel's
   registers and spills.  At head dims below 128 the same kernels stand in
   for the JAX package's packed twins (K1b, K2p).
3. K1 against its plain PyTorch version at the CIFAR-10 path's shapes, on
   the strided q/k/v views that ``attention()`` hands it: max abs error of
   the output and of the log-sum-exp against stated tolerances (bf16 out:
   relative to max|plain out|), and the
   times of K1, the plain version and ``F.scaled_dot_product_attention``
   (CUDA events, after warm-up, in turns).
4. The full-width CIFAR-10 EDMPrecond, random weights redrawn at unit scale:
   D(x, sigma) in f32 with K1 against the plain attention, TF32 off; K1 runs
   6 times per forward.
5. The CIFAR-10 sampling path: ``generate`` on 256 seeds, batch 256, bf16
   inner model, ipndm on the poly-7 schedule at NFE 5/10/35; finite output,
   per-seed rows, K1 launches = 6 x NFE x batches, images/sec; then the
   sampling CLI on the same seeds, whose PNGs must encode the NFE-5 images
   exactly.
6. Kernel K2 (the dQ and the dK/dV kernels) against its plain PyTorch
   version at the AMED path's shapes (batch 512, T=256 and T=64, H=1,
   d=256) in f32 and bf16, a d=64 multi-head shape and a ragged T, on the
   strided q/k/v views and a non-contiguous dO: max abs error of dq, dk and
   dv against stated tolerances, the times of K2, the plain version and the
   backward of ``F.scaled_dot_product_attention``, and bit-identical results
   from two runs.
7. The gradient of sum(D(x, sigma) * g) with respect to x and sigma through
   the full-width f32 CIFAR-10 EDMPrecond (unit-scale weights, TF32 off),
   with K1 + K2 against the plain attention; K2 runs 6 times per backward.
8. The CIFAR-10 AMED path: ``cli.train_amed`` at the CLI defaults (batch 512
   at once, f32 net, 4 steps, student amed, teacher heun) for two
   iterations, with peak memory and sec/kimg; the loss is finite, the
   predictor moves, its files are written, and K1 / K2 launch exactly as
   predicted.  Then ``cli.sample --predictor`` on 256 seeds from the saved
   predictor: finite images, K1 launches = 6 x NFE, images/sec.
9. K1 against its plain version at the ImageNet-64 shapes (d=64, where the
   JAX package takes the packed K1b: T=1024 H=6, T=256 H=9, T=64 H=12) at
   sampling batch 256 in bf16 and at the AMED microbatch in f32, and one
   d=32 shape: errors against the tolerances of phase 3, and the times of
   K1, the plain version and ``F.scaled_dot_product_attention``.
10. K2 against its plain version at the ImageNet-64 AMED shapes (the packed
   K2p's) in f32 and bf16 with a non-contiguous dO: errors against K2's
   tolerances, two runs bit-identical, and the times of K2, the plain
   version and the library backward.
11. The full-width ImageNet-64 EDMPrecond (DhariwalUNet, 296M parameters),
   f32, unit-scale weights, TF32 off, batch 8 with one-hot labels: D with
   K1, and d sum(D g) / d(x, sigma) with K1 + K2, against the plain
   attention; exactly 22 K1 launches per forward and 22 K2 pairs per
   backward.
12. The ImageNet-64 sampling path: ``generate`` on 256 seeds, batch 256,
   bf16, ipndm, poly-7, NFE 5/10/35, per-seed labels: finite images, K1
   launches = 22 x NFE, per-seed rows, the sampling CLI's PNGs, images/sec.
13. The ImageNet-64 AMED path: ``cli.train_amed --dataset_name=imagenet64
   --afs=True`` at batch 512 with ``--batch_gpu`` accumulation for two
   iterations (finite losses, the predictor moves, launches as predicted,
   sec/kimg, peak memory), then ``cli.sample --predictor`` at NFE 5 on 256
   seeds (launches, images/sec).
14. A ``torch.profiler`` breakdown of one batch-256 bf16 ImageNet-64
   forward by ``utils/profiling.py::CATEGORIES`` (K1 its own line).

The last three lines are the card's name and power limit, a JSON object on
the kernels and ``{"ok": true, "device": {...}}``.  The JSON lists K1 and
K2 twice: at the CIFAR-10 paths (d=256, launches of phases 5 and 8) and at
the ImageNet-64 paths (d=64, in place of K1b and K2p, launches of phases 12
and 13), each with its error and times at that path's main shape and its
bound on this card.
Any failed check raises, so the script
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
import torch.nn.functional as F

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
from diff_sampler_tpu_torch.utils.profiling import device_breakdown
from diff_sampler_tpu_torch.utils.rng import stacked_randn

# Tolerances of K1 against the plain version on identical inputs.  f32: both
# accumulate in f32 in other orders.  bf16: the output is rounded to bf16 on
# both sides, from f32 values that differ in where the softmax weights are
# rounded to bf16, so an element may land a bf16 step (2^-8 to 2^-7 of
# max|out|) or two away: 2^-5 of max|plain out|, and at most 2^-5.  The lse
# is f32 on both.
LSE_TOL = 1e-5


def _out_tol(dtype, ref_out) -> float:
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** -5 * min(1.0, ref_out.float().abs().max().item())


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

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
# the tensor cores in bf16 and the CUDA cores in f32, and HBM3.  A kernel's
# bound is the larger of its operations over the rate of its input type and
# its bytes (each input read once, each output written once) over HBM's.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# The ImageNet-64 path (EDM_ARCHS["imagenet64"], DhariwalUNet, d=64): 22
# attention sites per forward, 7 at 32x32 (T=1024, 6 heads), 7 at 16x16
# (T=256, 9 heads) and 8 at 8x8 (T=64, 12 heads).
IN64_SITES = 22
IN64_LEVELS = [(1024, 6), (256, 9), (64, 12)]  # (T, H)
# AMED on ImageNet-64 at the CLI's batch 512 accumulates microbatches of 128
IN64_BATCH_GPU = 128
IN64_AMED_AFS = True  # NFE 5 at 4 steps, as BASELINE config 3 samples
# K1 where the JAX package takes the packed K1b: at the sampling batch in
# bf16 and the AMED microbatch in f32, plus a d=32 shape
IN64_K1_SHAPES = ([(BATCH, t, h, 64, torch.bfloat16) for t, h in IN64_LEVELS]
                  + [(IN64_BATCH_GPU, t, h, 64, torch.float32) for t, h in IN64_LEVELS]
                  + [(BATCH, 256, 6, 32, torch.bfloat16)])
# K2 where the JAX package takes the packed K2p: at the AMED microbatch in
# f32 (the path's dtype) and bf16
IN64_K2_SHAPES = ([(IN64_BATCH_GPU, t, h, 64, torch.float32) for t, h in IN64_LEVELS]
                  + [(IN64_BATCH_GPU, 1024, 6, 64, torch.bfloat16)])


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


def _turns(fns: dict, reps: int = 20, warmup: int = 3) -> dict:
    """Mean ms per call of each function, timed in turns forwards then
    backwards (a, b, c, c, b, a) so that drift between them cancels."""
    order = list(fns) + list(reversed(list(fns)))
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(_time_ms(fns[name], reps=reps, warmup=warmup))
    return {name: sum(v) / len(v) for name, v in times.items()}


def _attention_bound(kind: str, b: int, t: int, h: int, d: int, dtype) -> tuple:
    """(bound_ms, bound_by) of one attention kernel on this card's published
    peaks.  kind: "fwd" (S = QK^T, O = PV: out and lse from q, k, v), "dq"
    (S, dP = dO V^T, dQ = dS K, from q, k, v, dO, lse, delta) or "dkv" (S,
    dP, dV = P^T dO, dK = dS^T Q); 2 flops per multiply-add."""
    elt = torch.empty((), dtype=dtype).element_size()
    tensor, stats = b * t * h * d * elt, b * h * t * 4
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = products * 2 * b * h * t * t * d
    nbytes = {"fwd": 4 * tensor + stats, "dq": 5 * tensor + 2 * stats,
              "dkv": 6 * tensor + 2 * stats}[kind]
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _library_fwd(q, k, v, scale):
    """``F.scaled_dot_product_attention`` on contiguous [B, H, T, d] copies
    of q, k, v, made here, outside the timing."""
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)


def _library_bwd(q, k, v, do, scale):
    """The backward of ``F.scaled_dot_product_attention`` (dq, dk and dv in
    one call) on contiguous copies, its forward run here, outside the
    timing."""
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    g = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)


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
        print(f"[build] K1/K2 library already built, loaded in "
              f"{time.perf_counter() - t0:.3f} s")
        return
    print(f"[build] K1 and K2 built with nvcc in {_build.build_seconds:.2f} s, one "
          f"process per source ({' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_log.splitlines():
        # ptxas names each kernel by its mangled name: print it as
        # flash_<...>_kernel<dtype, d>, then its registers and spills
        entry = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(13__nv_bfloat16|f)"
                          r"((?:Li\d+E)+)E", line)
        if entry and "Compiling entry function" in line:
            dtype = "bf16" if entry.group(2) != "f" else "f32"
            ints = re.findall(r"Li(\d+)E", entry.group(3))
            print(f"[build] {entry.group(1)}<{dtype}, d={ints[0]}>:")
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
        tol = _out_tol(dtype, ref_out)
        times = _turns({"kernel": lambda: A.flash_attention_mh(q, k, v, scale),
                        "plain": lambda: A.reference_sdpa(q, k, v, scale),
                        "library": _library_fwd(q, k, v, scale)})
        bound_ms, bound_by = _attention_bound("fwd", b, t, h, d, dtype)
        name = str(dtype).replace("torch.", "")
        print(f"[K1] B={b} T={t} H={h} d={d} {name}: out err {err_out:.3g} "
              f"(tol {tol:.3g}), lse err {err_lse:.3g} (tol {LSE_TOL:.3g}); "
              f"kernel {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
              f"F.scaled_dot_product_attention {times['library']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        _check(err_out <= tol and err_lse <= LSE_TOL,
               f"K1 disagrees with the plain version at {(b, t, h, d, name)}")
        if main is None:  # the first shape is the main path's
            main = dict(max_abs_err=err_out, ms=times["kernel"], plain_ms=times["plain"],
                        library_ms=times["library"], bound_ms=bound_ms, bound_by=bound_by)
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


_COUNTED = {"k1": A.flash_attention_mh, "dq": A.flash_attention_bwd_dq,
            "dkv": A.flash_attention_bwd_dkv}


def _reset_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _only(**launches) -> dict:
    """The counts of a run that launched these kernels and no other."""
    return {**dict.fromkeys(_COUNTED, 0), **launches}


def _drive_sampling(tag: str, den, shape, sites: int, kernel: str, label_dim: int = 0):
    """A sampling path as ``generate`` runs it: after a warm-up call (cuDNN
    plans and the allocator stay out of the timing), 256 seeds at batch 256
    with ipndm on the poly-7 schedule at NFE 5/10/35, with the counts set to
    0 just before.  Checks finite images, ``sites`` launches of ``kernel``
    per net call and no other kernel, and seeds 0-7 at batch 8 against the
    batch-256 rows.  Returns (the NFE-5 images, the launches of ``kernel``)."""
    seeds = list(range(BATCH))
    kw = dict(max_batch_size=BATCH, device="cuda", label_dim=label_dim)
    generate(den, seeds, shape, SolverConfig(solver="ipndm", num_steps=6), **kw)
    torch.cuda.synchronize()

    _reset_counts()
    expected = 0
    images = {}
    for nfe, steps in NFE_STEPS:
        cfg = SolverConfig(solver="ipndm", num_steps=steps, schedule_type="polynomial",
                           schedule_rho=7.0)
        _check(cfg.nfe() == nfe, f"ipndm at {steps} steps is NFE {cfg.nfe()}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        images[nfe] = generate(den, seeds, shape, cfg, **kw)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        device_s = start.elapsed_time(end) / 1000
        expected += sites * nfe * math.ceil(len(seeds) / BATCH)
        print(f"[{tag}] ipndm NFE {nfe}, batch {BATCH}, bf16"
              f"{', per-seed labels' if label_dim else ''}: {BATCH / device_s:.2f} images/s "
              f"(CUDA events, {device_s:.4f} s; host clock {host_s:.4f} s); {kernel} launches "
              f"so far {_counts()[kernel]}, expected {expected}")
    counts = _counts()
    _check(counts == _only(**{kernel: expected}),
           f"{tag}: launches {counts}, expected {expected} of {kernel} and no other")
    for nfe, x in images.items():
        _check(x.shape == (BATCH, *shape) and np.isfinite(x).all(),
               f"{tag}: NFE {nfe} output is not finite or has shape {x.shape}")

    few = generate(den, seeds[:8], shape, SolverConfig(solver="ipndm", num_steps=6),
                   **dict(kw, max_batch_size=8))
    err = np.abs(few - images[5][:8]).max()
    bound = 1e-2 * np.abs(images[5][:8]).max()
    print(f"[{tag}] seeds 0-7 at batch 8 vs batch 256, NFE 5: max abs diff {err:.3g} "
          f"(tol 1e-2 * max|x| = {bound:.3g}; cuDNN may pick other bf16 conv algorithms)")
    _check(err <= bound, f"{tag}: per-seed rows depend on the batch")
    return images[5], counts[kernel]


def _check_cli_pngs(tag: str, argv: list, images: np.ndarray) -> None:
    """The sampling CLI as a user runs it, on the seeds, weights and config of
    ``images`` (seeds 0-255): its PNGs must be byte for byte their encoding."""
    with tempfile.TemporaryDirectory() as outdir:
        cli_sample.main([*argv, f"--seeds=0-{BATCH - 1}", f"--batch={BATCH}", "--device=cuda",
                         f"--outdir={outdir}"])
        want = to_uint8(images)
        same = 0
        for seed in range(BATCH):
            with open(os.path.join(outdir, f"{seed - seed % 1000:06d}", f"{seed:06d}.png"),
                      "rb") as f:
                same += f.read() == encode_png(want[seed])
    print(f"[{tag}] CLI wrote {same} of {BATCH} PNGs identical to the NFE-5 run's images")
    _check(same == BATCH, f"{tag}: CLI PNGs differ from generate's images")


def phase_main_path() -> int:
    module, _ = create_model("cifar10", "random", dtype=torch.bfloat16, device="cuda")
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    images, launches = _drive_sampling("main", bind(module), shape, ATTENTION_SITES, "k1")
    _check_cli_pngs("main", ["--dataset_name=cifar10", "--model_path=random", "--solver=ipndm",
                             "--num_steps=6", "--bf16=True"], images)
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
        times = _backward_times(
            A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv, A.flash_attention_mh_bwd,
            q, k, v, out, lse, do, do_c, delta, scale)
        name = str(dtype).replace("torch.", "")
        print(f"[K2] B={b} T={t} H={h} d={d} {name}: max abs err dq {errs[0]:.3g} "
              f"(tol {tols[0]:.3g}), dk {errs[1]:.3g} (tol {tols[1]:.3g}), dv {errs[2]:.3g} "
              f"(tol {tols[2]:.3g}); two runs bit-identical: {same}; {_fmt_times(times)}")
        _check(all(e <= tol for e, tol in zip(errs, tols)),
               f"K2 disagrees with the plain version at {(b, t, h, d, name)}")
        _check(same, f"K2 is not deterministic at {(b, t, h, d, name)}")
        if main is None:  # the first shape is the AMED path's
            main = _backward_main(errs, times, b, t, h, d, dtype)
    return main


def _backward_times(dq_fn, dkv_fn, bwd_fn, q, k, v, out, lse, do, do_c, delta, scale) -> dict:
    """ms of the dQ and dK/dV kernels and of the whole backward (delta
    included), each beside its plain version, and of the library backward."""
    times = {}
    for name, kernel, plain in (
            ("dq", lambda: dq_fn(q, k, v, do_c, lse, delta, scale),
             lambda: A.reference_sdpa_bwd_dq(q, k, v, do_c, lse, delta, scale)),
            ("dkv", lambda: dkv_fn(q, k, v, do_c, lse, delta, scale),
             lambda: A.reference_sdpa_bwd_dkv(q, k, v, do_c, lse, delta, scale)),
            ("bwd", lambda: bwd_fn(q, k, v, out, lse, do, scale),
             lambda: A.reference_sdpa_bwd(q, k, v, out, lse, do, scale))):
        got = _turns({"kernel": kernel, "plain": plain}, reps=5)
        times[name] = (got["kernel"], got["plain"])
    times["library"] = _turns({"library": _library_bwd(q, k, v, do, scale)}, reps=5)["library"]
    return times


def _fmt_times(times: dict) -> str:
    return (f"kernel vs plain ms: dQ {times['dq'][0]:.4f} vs {times['dq'][1]:.4f}, dK/dV "
            f"{times['dkv'][0]:.4f} vs {times['dkv'][1]:.4f}, whole backward "
            f"{times['bwd'][0]:.4f} vs {times['bwd'][1]:.4f}; backward of "
            f"F.scaled_dot_product_attention {times['library']:.4f} ms")


def _backward_main(errs, times, b, t, h, d, dtype) -> dict:
    """The kernels-line fields of the dQ and dK/dV kernels at one shape; the
    library time is the library's whole backward (dq, dk and dv)."""
    out = {}
    for key, err in (("dq", errs[0]), ("dkv", max(errs[1:]))):
        bound_ms, bound_by = _attention_bound(key, b, t, h, d, dtype)
        out[key] = dict(max_abs_err=err, ms=times[key][0], plain_ms=times[key][1],
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=times["library"])
    return out


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


def _train_amed(tag: str, argv: list, batch_gpu) -> tuple:
    """``cli.train_amed`` as a user runs it, with torch's default precision
    flags, the counts set to 0 and the peak memory cleared just before.
    Prints its times and peak memory; checks finite losses, the run dir's
    files and that the predictor moved.  Returns (run dir, its config,
    launches)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
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
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    kimg = AMED_ITERS * AMED_BATCH / 1000
    print(f"[{tag}] train_amed: batch {AMED_BATCH}, batch_gpu {batch_gpu}, f32 net, "
          f"{AMED_ITERS} iterations (torch.backends.cudnn.allow_tf32=True): whole CLI call "
          f"{host_s:.3f} s host clock, {device_s:.3f} s CUDA events ({device_s / kimg:.3f} "
          f"s/kimg); per-tick sec/kimg (host clock) "
          f"{[round(tk['sec_per_kimg'], 3) for tk in ticks]}; torch.cuda.max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    losses = [tk["Loss/loss"]["mean"] for tk in ticks]
    _check(len(ticks) == AMED_ITERS and all(math.isfinite(x) for x in losses),
           f"{tag}: losses {losses} are not finite")
    for name in ("predictor_config.json", "stats.jsonl", "predictor.npz"):
        _check(os.path.isfile(os.path.join(run_dir, name)), f"train_amed wrote no {name}")
    # the predictor moved: its saved weights differ from a fresh init's
    cfg = AMEDConfig(**ckpt.load_config(os.path.join(run_dir, "predictor_config.json")))
    fresh = init_params(predictor_from_config(cfg), seed=0)
    saved = ckpt.load_params(os.path.join(run_dir, "predictor.npz"))["params"]
    moved = max(float(np.abs(saved[layer][leaf] - ref).max())
                for layer, leaves in params_to_jax(fresh.state_dict()).items()
                for leaf, ref in leaves.items())
    print(f"[{tag}] losses per tick {losses}; predictor moved by max abs {moved:.4g}")
    _check(moved > 0, f"{tag}: the predictor did not move")
    return run_dir, cfg, counts


def _sample_with_predictor(tag: str, dataset: str, run_dir: str, outdir: str, shape,
                           nfe: int, sites: int, kernel: str) -> None:
    """``cli.sample --predictor`` on 256 seeds (finite batches, a PNG per
    seed, ``sites`` launches of ``kernel`` per net call and no other kernel),
    then the AMED sampler alone after a warm-up call, for images/sec."""
    seen = []
    real_to_uint8 = cli_sample.to_uint8

    def checked_to_uint8(x):
        seen.append(bool(np.isfinite(x).all()) and x.shape[1:] == tuple(shape))
        return real_to_uint8(x)

    _reset_counts()
    cli_sample.to_uint8 = checked_to_uint8
    t0 = time.perf_counter()
    try:
        cli_sample.main([f"--dataset_name={dataset}", f"--predictor={run_dir}",
                         f"--seeds=0-{BATCH - 1}", f"--batch={BATCH}", "--device=cuda",
                         f"--outdir={outdir}"])
    finally:
        cli_sample.to_uint8 = real_to_uint8
    cli_s = time.perf_counter() - t0
    counts = _counts()
    pngs = glob.glob(os.path.join(outdir, "*", "*.png"))
    print(f"[{tag}] sample --predictor: NFE {nfe}, {len(pngs)} PNGs, finite batches {seen}, "
          f"launches {counts} (expected {sites * nfe} {kernel}), whole CLI call {cli_s:.3f} s "
          f"host clock")
    _check(len(pngs) == BATCH and seen and all(seen), f"{tag}: samples missing or not finite")
    _check(counts == _only(**{kernel: sites * nfe}), f"{tag}: launch counts of the sampling")

    module, _ = create_model(dataset, "random", device="cuda")
    fn, _ = cli_sample.build_amed_sample_fn(module, run_dir, "cuda")
    lat = stacked_randn(range(BATCH), shape, device="cuda")
    fn(lat)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    x = fn(lat)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1000
    print(f"[{tag}] AMED sampling, NFE {nfe}, batch {BATCH}, f32 net: {BATCH / device_s:.2f} "
          f"images/s (CUDA events, {device_s:.4f} s; host clock {host_s:.4f} s)")
    _check(torch.isfinite(x).all().item(), f"{tag}: AMED samples are not finite")
    del module, fn
    torch.cuda.empty_cache()


def phase_amed(workdir: str) -> dict:
    argv = ["--dataset_name=cifar10", "--model_path=random", f"--batch={AMED_BATCH}",
            f"--num_steps={AMED_STEPS}", f"--total_kimg={AMED_KIMG}", "--device=cuda",
            f"--outdir={os.path.join(workdir, 'exps')}"]
    run_dir, _, counts = _train_amed("AMED", argv, batch_gpu=None)
    # per iteration and microbatch (one: batch / batch_gpu = 1): the heun
    # teacher makes 2 calls per fine step, M + 1 = 2 fine steps per segment;
    # the amed student 2 calls per segment, the second one differentiated
    segments = AMED_STEPS - 1
    want = _only(k1=ATTENTION_SITES * (2 * 2 * segments + 2 * segments) * AMED_ITERS,
                 dq=ATTENTION_SITES * segments * AMED_ITERS,
                 dkv=ATTENTION_SITES * segments * AMED_ITERS)
    print(f"[AMED] launches {counts}, expected {want}")
    _check(counts == want, "launch counts of the AMED training")
    _sample_with_predictor("AMED", "cifar10", run_dir, os.path.join(workdir, "amed_samples"),
                           (32, 32, 3), nfe=2 * segments, sites=ATTENTION_SITES, kernel="k1")
    return counts


def phase_in64_kernel() -> dict:
    g = torch.Generator("cuda").manual_seed(3)
    main = None
    for b, t, h, d, dtype in IN64_K1_SHAPES:
        q, k, v = _qkv_views(b, t, h, d, dtype, g)
        scale = d ** -0.5
        out, lse = A.flash_attention_mh(q, k, v, scale)
        ref_out, ref_lse = A.reference_sdpa(q, k, v, scale)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol = _out_tol(dtype, ref_out)
        del out, lse, ref_out, ref_lse
        times = _turns({"kernel": lambda: A.flash_attention_mh(q, k, v, scale),
                        "plain": lambda: A.reference_sdpa(q, k, v, scale),
                        "library": _library_fwd(q, k, v, scale)}, reps=5, warmup=2)
        bound_ms, bound_by = _attention_bound("fwd", b, t, h, d, dtype)
        name = str(dtype).replace("torch.", "")
        print(f"[IN64 K1] B={b} T={t} H={h} d={d} {name}: out err {err_out:.3g} (tol "
              f"{tol:.3g}), lse err {err_lse:.3g} (tol {LSE_TOL:.3g}); K1 "
              f"{times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
              f"F.scaled_dot_product_attention {times['library']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); "
              f"{2 * 2 * b * h * t * t * d / times['kernel'] / 1e9:.2f} TFLOP/s")
        _check(err_out <= tol and err_lse <= LSE_TOL,
               f"K1 disagrees with the plain version at {(b, t, h, d, name)}")
        if main is None:  # the first shape is the sampling path's costliest
            main = dict(max_abs_err=err_out, ms=times["kernel"], plain_ms=times["plain"],
                        library_ms=times["library"], bound_ms=bound_ms, bound_by=bound_by)
    torch.cuda.empty_cache()
    return main


def phase_in64_backward_kernel() -> dict:
    g = torch.Generator("cuda").manual_seed(4)
    main = None
    for b, t, h, d, dtype in IN64_K2_SHAPES:
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
        del grads, again, ref
        delta = torch.einsum("bthd,bthd->bht", do.float(), out.float()).contiguous()
        times = _backward_times(
            A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv, A.flash_attention_mh_bwd,
            q, k, v, out, lse, do, do.to(dtype), delta, scale)
        name = str(dtype).replace("torch.", "")
        print(f"[IN64 K2] B={b} T={t} H={h} d={d} {name}: max abs err dq {errs[0]:.3g} (tol "
              f"{tols[0]:.3g}), dk {errs[1]:.3g} (tol {tols[1]:.3g}), dv {errs[2]:.3g} (tol "
              f"{tols[2]:.3g}); two runs bit-identical: {same}; {_fmt_times(times)}")
        _check(all(e <= tol for e, tol in zip(errs, tols)),
               f"K2 disagrees with the plain version at {(b, t, h, d, name)}")
        _check(same, f"K2 is not deterministic at {(b, t, h, d, name)}")
        if main is None:  # the first shape is the AMED path's costliest
            main = _backward_main(errs, times, b, t, h, d, dtype)
    torch.cuda.empty_cache()
    return main


def _in64_inputs(n: int, device="cuda"):
    """x at sigma 80, 10, 1, 0.1 in turn, those sigmas, one-hot labels."""
    sigma = torch.tensor([80.0, 10.0, 1.0, 0.1] * (n // 4), device=device)
    x = stacked_randn(range(n), (64, 64, 3), device=device) * sigma[:, None, None, None]
    labels = F.one_hot(torch.arange(n, device=device) * 97 % 1000, 1000).float()
    return x, sigma, labels


def phase_in64_denoiser_and_gradient() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    module, _ = create_model("imagenet64", "random", device="cuda")
    _redraw_unit_scale(module, seed=1)
    module.requires_grad_(False)
    x0, sigma0, labels = _in64_inputs(8)
    cot = stacked_randn(range(100, 108), (64, 64, 3), device="cuda")

    def forward():
        with torch.no_grad():
            return module(x0, sigma0, labels)

    def grads():
        x, sigma = x0.clone().requires_grad_(), sigma0.clone().requires_grad_()
        (module(x, sigma, labels) * cot).sum().backward()
        return x.grad, sigma.grad

    real_sdpa = layers.sdpa
    plain_sdpa = lambda q, k, v, scale=None: A.reference_sdpa(q, k, v, scale)[0]  # noqa: E731
    _reset_counts()
    d_kernel = forward()
    fwd_counts = _counts()
    _reset_counts()
    gx, gs = grads()
    bwd_counts = _counts()
    layers.sdpa = plain_sdpa
    try:
        d_plain = forward()
        px, ps = grads()
    finally:
        layers.sdpa = real_sdpa
    torch.cuda.synchronize()
    err = (d_kernel - d_plain).abs().max().item()
    bound = 1e-4 * d_plain.abs().max().item()
    print(f"[IN64 D f32] full-width ImageNet-64 EDMPrecond (DhariwalUNet, "
          f"{sum(p.numel() for p in module.parameters()) / 1e6:.1f}M parameters), batch 8 with "
          f"labels, sigma {sigma0.tolist()}: max|D| {d_plain.abs().max().item():.4g}, K1 vs "
          f"plain attention max abs err {err:.3g} (tol 1e-4 * max|D| = {bound:.3g}); launches "
          f"per forward {fwd_counts}")
    _check(torch.isfinite(d_kernel).all().item(), "ImageNet-64 D is not finite")
    _check(err <= bound, "ImageNet-64 D with K1 disagrees with the plain attention")
    _check(fwd_counts == _only(k1=IN64_SITES),
           f"launches in one ImageNet-64 forward: {fwd_counts}")
    for name, got, want in (("x", gx, px), ("sigma", gs, ps)):
        err = (got - want).abs().max().item()
        bound = 1e-4 * want.abs().max().item()
        print(f"[IN64 grad f32] d sum(D * g) / d{name}: max|grad| {want.abs().max().item():.4g}, "
              f"K1+K2 vs plain attention max abs err {err:.3g} (tol 1e-4 * max|grad| = "
              f"{bound:.3g})")
        _check(torch.isfinite(got).all().item(), f"the ImageNet-64 gradient in {name} is not "
                                                 "finite")
        _check(err <= bound, f"the ImageNet-64 gradient in {name} with K2 disagrees")
    print(f"[IN64 grad f32] launches in one forward + backward: {bwd_counts}")
    _check(bwd_counts == _only(k1=IN64_SITES, dq=IN64_SITES, dkv=IN64_SITES),
           f"launches in one ImageNet-64 forward + backward: {bwd_counts}")
    del module
    torch.cuda.empty_cache()


def phase_in64_sampling():
    """Returns (K1 launches of the path, the bf16 module)."""
    module, _ = create_model("imagenet64", "random", dtype=torch.bfloat16, device="cuda")
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    images, launches = _drive_sampling("IN64 main", bind(module), shape, IN64_SITES, "k1",
                                       label_dim=module.label_dim)
    _check_cli_pngs("IN64 main", ["--dataset_name=imagenet64", "--model_path=random",
                                  "--solver=ipndm", "--num_steps=6", "--bf16=True"], images)
    return launches, module


def phase_in64_amed(workdir: str) -> dict:
    argv = ["--dataset_name=imagenet64", "--model_path=random", f"--batch={AMED_BATCH}",
            f"--batch_gpu={IN64_BATCH_GPU}", f"--num_steps={AMED_STEPS}",
            f"--total_kimg={AMED_KIMG}", f"--afs={IN64_AMED_AFS}", "--device=cuda",
            f"--outdir={os.path.join(workdir, 'exps')}"]
    run_dir, cfg, counts = _train_amed("IN64 AMED", argv, batch_gpu=IN64_BATCH_GPU)
    # per iteration and microbatch: the heun teacher 2 calls per fine step, M
    # + 1 = 2 fine steps per segment; the amed student 2 calls per segment,
    # less the first segment's first (AFS), the second one differentiated
    segments = AMED_STEPS - 1
    micro = AMED_ITERS * AMED_BATCH // IN64_BATCH_GPU
    calls = 2 * 2 * segments + 2 * segments - (1 if IN64_AMED_AFS else 0)
    want = _only(k1=IN64_SITES * calls * micro, dq=IN64_SITES * segments * micro,
                 dkv=IN64_SITES * segments * micro)
    print(f"[IN64 AMED] launches {counts}, expected {want}")
    _check(counts == want, "launch counts of the ImageNet-64 AMED training")
    _sample_with_predictor("IN64 AMED", "imagenet64", run_dir,
                           os.path.join(workdir, "in64_amed_samples"), (64, 64, 3),
                           nfe=2 * segments - (1 if cfg.afs else 0), sites=IN64_SITES,
                           kernel="k1")
    return counts


def phase_in64_profile(module) -> None:
    """torch.profiler over one batch-256 bf16 forward of the sampling net."""
    sigma = torch.full((BATCH,), 2.5, device="cuda")
    x = stacked_randn(range(BATCH), (64, 64, 3), device="cuda") * 2.5
    labels = F.one_hot(torch.arange(BATCH, device="cuda") % 1000, 1000).float()
    with torch.no_grad():
        module(x, sigma, labels)  # warm-up
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            start.record()
            module(x, sigma, labels)
            end.record()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out = device_breakdown(json.load(f)["traceEvents"])
    print(f"[IN64 profile] one batch-{BATCH} bf16 forward under torch.profiler: CUDA events "
          f"{start.elapsed_time(end):.3f} ms, host clock {host_s * 1e3:.3f} ms; device time "
          f"{out['device_ms']:.3f} ms over a span of {out['span_ms']:.3f} ms, busy "
          f"{out['busy_ms']:.3f} ms, idle share {out['idle_share']:.4f}")
    for name, c in sorted(out["categories"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"[IN64 profile]   {name:<16} {c['ms']:>10.3f} ms  {c['share']:.4f}  "
              f"{c['calls']} calls")
    for name, ms in out["top"][:8]:
        print(f"[IN64 profile]   top {ms:>10.3f} ms  {name[:140]}")
    _check(out["categories"]["K1"]["calls"] == IN64_SITES,
           f"the profile holds {out['categories']['K1']['calls']} K1 kernels")


def _kernel_entry(name, source, replaces, launches, fields) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: fields[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


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
    in64_k1 = phase_in64_kernel()
    in64_k2 = phase_in64_backward_kernel()
    phase_in64_denoiser_and_gradient()
    in64_launches, module = phase_in64_sampling()
    phase_in64_profile(module)
    del module
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        in64_amed = phase_in64_amed(workdir)
    for name, n in (("K1", launches), ("K2 dQ", amed["dq"]), ("K2 dK/dV", amed["dkv"]),
                    ("K1 on ImageNet-64", in64_launches),
                    ("K2 dQ on ImageNet-64", in64_amed["dq"]),
                    ("K2 dK/dV on ImageNet-64", in64_amed["dkv"])):
        _check(n > 0, f"{name} was not launched on its path")
    print(smi)
    fwd, bwd = ("diff_sampler_tpu_torch/csrc/flash_attn_fwd.cu",
                "diff_sampler_tpu_torch/csrc/flash_attn_bwd.cu")
    tpu = "diff_sampler_tpu/ops/pallas_attention.py"
    print(json.dumps({"kernels": [
        _kernel_entry("flash_attention_mh (K1, multi-head flash-attention forward)", fwd,
                      f"{tpu}:157", launches, k1),
        _kernel_entry("flash_attention_bwd_dq (K2, flash-attention backward, dQ)", bwd,
                      f"{tpu}:406", amed["dq"], k2["dq"]),
        _kernel_entry("flash_attention_bwd_dkv (K2, flash-attention backward, dK/dV)", bwd,
                      f"{tpu}:554", amed["dkv"], k2["dkv"]),
        _kernel_entry("flash_attention_mh at d=64 (K1 in place of K1b, ImageNet-64 path)",
                      fwd, f"{tpu}:227", in64_launches, in64_k1),
        _kernel_entry("flash_attention_bwd_dq at d=64 (K2 dQ in place of K2p, ImageNet-64 "
                      "path)", bwd, f"{tpu}:441", in64_amed["dq"], in64_k2["dq"]),
        _kernel_entry("flash_attention_bwd_dkv at d=64 (K2 dK/dV in place of K2p, ImageNet-64 "
                      "path)", bwd, f"{tpu}:491", in64_amed["dkv"], in64_k2["dkv"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
