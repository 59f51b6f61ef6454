"""Kernel K4 beside variants of its own source, on one GPU.

  python -m diff_sampler_tpu_torch.cli.conv_variants [--dtype bf16|f32] [--parent CSRC_DIR]

At CIFAR-10's [256, 32, 32, 256] -> 256 and FFHQ's [256, 64, 64, 128] ->
128, through both entry points, times in turns (CUDA events; the median of
rounds run in both orders) K4 as built from ``csrc/``, copies of
``csrc/conv3x3.cu`` changed as ``VARIANTS`` (bf16) or ``F32_VARIANTS`` says
(each built with nvcc into its own library under ``csrc/build/variants/``),
``F.conv2d`` (cuDNN, TF32 off; after the SiLU pass for the fused entry)
and, with ``--parent``, the ``conv3x3.cu`` of another checkout's ``csrc/``
directory, through whichever entry its library has: ``dst_conv3x3_bf16``
or ``dst_conv3x3_f32`` on a patch plan (this tree's), or an f32
``dst_conv3x3_f32`` without one (w as [3, 3, Cin, Cout]: the CUDA-core
kernel before 3xTF32).  The variants are called without the wrapper (no w
copy, no split).  Each kernel's error against the plain version is printed
first: in bf16 at a small batch, in f32 at the f32 shapes of
``chip_smoke.py``'s K4 phase, as a fraction of max|plain out|.  The
variants ask what bounds the kernel:

  bf16
  noprologue  the fused entry without the prologue's arithmetic (its output
              is not the conv of silu(x * a + b): timed, its error is not)
  nostore     no output stores (timed only)
  tanh        the prologue's silu through tanh.approx, one MUFU op a value
              in place of two (not an f32 silu: its error is printed)
  ilp4        four pixels in flight per prologue thread in place of two

  f32
  nofold      every product of a tile in one run of accumulators: what the
              tensor cores' truncation costs in error, and the folds in time
  fold1, fold3, fold5
              fresh accumulators folded every 1, 3 or 5 taps (12, 36, 60
              products) in place of every chunk's 9 taps (108)
  noprologue  as in bf16
  nostore     no output stores, the sums kept live (timed only)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import _build
from ..ops import conv as C

SHAPES = [(256, 32, 32, 256, 256), (256, 64, 64, 128, 128)]
PEAK_BF16 = 989e12  # H100 SXM, dense
VARIANTS = {
    "noprologue": [("        if (ch < g.cin) {  // channels past Cin stay 0",
                    "        if (false) {")],
    "nostore": [("            if (orow[i] != nullptr && col + 8 * t4 < g.cout)",
                 "            if (false)")],
    "tanh": [("                e[i] = pack_rn(silu_fast(z.x * av[2 * i] + bv[2 * i]),\n"
              "                               silu_fast(z.y * av[2 * i + 1] + bv[2 * i + 1]));",
              "                e[i] = pack_rn(silu_tanh(z.x * av[2 * i] + bv[2 * i]),\n"
              "                               silu_tanh(z.y * av[2 * i + 1] + bv[2 * i + 1]));"),
             ("__device__ __forceinline__ float silu_fast(float z) {",
              "__device__ __forceinline__ float silu_tanh(float z) {\n"
              "  const float h = 0.5f * z;\n  float t;\n"
              "  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(t) : \"f\"(h));\n"
              "  return fmaf(h, t, h);\n}\n"
              "__device__ __forceinline__ float silu_fast(float z) {")],
    "ilp4": [("constexpr int kProloguePixels = 2;", "constexpr int kProloguePixels = 4;")],
}
F32_VARIANTS = {
    "nofold": [("          const bool starts = tap % kFoldTaps == 0;\n"
                "          const bool ends = tap % kFoldTaps == kFoldTaps - 1 || tap == 8;",
                "          const bool starts = tap == 0 && c == 0;\n"
                "          const bool ends = tap == 8 && c == g.kc - 1;")],
    "fold1": [("constexpr int kFoldTaps = 9;", "constexpr int kFoldTaps = 1;")],
    "fold3": [("constexpr int kFoldTaps = 9;", "constexpr int kFoldTaps = 3;")],
    "fold5": [("constexpr int kFoldTaps = 9;", "constexpr int kFoldTaps = 5;")],
    "noprologue": [("        if (ch < g.cin) {  // all four channels inside Cin, or all past it",
                    "        if (false) {")],
    # a condition the compiler cannot decide, so that the sums stay live
    "nostore": [("              if (t.n0 + 8 * jn < g.cout)  // Cout may end inside the tile",
                 "              if (g.cout < 0)")],
}
CHECKED = ("tree", "tanh", "ilp4", "nofold", "fold1", "fold3", "fold5", "parent")
# the f32 shapes of chip_smoke.py's K4 phase, where the fold lengths are held
# to the tolerance (1e-5 of max|plain out|)
F32_CHECK_SHAPES = SHAPES + [(3, 7, 5, 128, 384)]
PEAK_TF32 = 495e12  # H100 SXM, dense; 3xTF32 takes three products


def _start_build(name: str, src_dir: Path, patches) -> tuple:
    """Copy ``src_dir``'s sources, patch conv3x3.cu, start nvcc on it."""
    out = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for p in src_dir.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, out / p.name)
    src = (out / "conv3x3.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    (out / "conv3x3.cu").write_text(src)
    lib = out / "libconv.so"
    proc = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                             str(out / "conv3x3.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, proc


def _finish_build(name: str, lib: Path, proc):
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-4000:]}")
    spills = sorted({line.strip() for line in log.splitlines() if "spill" in line})
    print(f"[build] {name}: {'; '.join(spills)}", flush=True)
    return ctypes.CDLL(str(lib))


def _caller(so, dtype, x, w, bias, a, b, out, fuse: bool):
    """A call of a library's K4 entry (this tree's, a variant's or a
    parent's, whichever of the entries named in the module's docstring the
    library has) on these tensors, w as [3, 3, Cin, Cout].  The call holds
    the copies of w it makes (the entries see only their addresses)."""
    n, h, wd, cin = x.shape
    cout = out.shape[-1]
    plan = C.conv_plan(n, h, wd, cin, cout, dtype)
    p, i = ctypes.c_void_p, ctypes.c_int
    ab = (a.data_ptr() if fuse else None, b.data_ptr() if fuse else None)
    shape = (n, h, wd, cin, cout, int(fuse))
    held = ()
    if dtype == torch.bfloat16 and hasattr(so, "dst_conv3x3_bf16"):
        entry, wt = so.dst_conv3x3_bf16, w.permute(0, 1, 3, 2).contiguous()
        held = (wt,)
        entry.argtypes = [p] * 6 + [i] * 8 + [p]
        args = (x.data_ptr(), *ab, wt.data_ptr(), bias.data_ptr(), out.data_ptr(), *shape,
                plan.tile_h, plan.tile_w)
    elif dtype == torch.float32 and hasattr(so, "dst_conv3x3_split_w"):
        entry, (w_hi, w_lo) = so.dst_conv3x3_f32, C.split_w(w)
        held = (w_hi, w_lo)
        entry.argtypes = [p] * 7 + [i] * 8 + [p]
        args = (x.data_ptr(), *ab, w_hi.data_ptr(), w_lo.data_ptr(), bias.data_ptr(),
                out.data_ptr(), *shape, plan.tile_h, plan.tile_w)
    else:
        entry = so.dst_conv3x3_f32
        entry.argtypes = [p] * 6 + [i] * 6 + [p]
        args = (x.data_ptr(), *ab, w.data_ptr(), bias.data_ptr(), out.data_ptr(), *shape)
    entry.restype = i

    def run(held=held):  # the default holds the copies of w as long as run lives
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"conv3x3 variant failed: CUDA error {err}")
        return out
    return run


def _inputs(n, h, w, cin, cout, seed, dtype=torch.bfloat16):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(dtype)
    wt = (torch.randn(3, 3, cin, cout, generator=g, device="cuda") / (3 * cin ** 0.5)).to(dtype)
    bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
    a = 1 + 0.1 * torch.randn(n, cin, generator=g, device="cuda")
    b = 0.5 + 0.1 * torch.randn(n, cin, generator=g, device="cuda")
    return x, wt, bias, a, b


def _turns(fns: dict, reps: int = 20, rounds: int = 3) -> dict:
    """Median ms per call of each fn, timed in turns, in order and reversed."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for k, fn in list(fns.items()) + list(reversed(fns.items())):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end) / reps)
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier checkout's csrc/ directory, whose K4 is timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_variants needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = args.dtype == "f32"
    dtype = torch.float32 if f32 else torch.bfloat16
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    variants = F32_VARIANTS if f32 else VARIANTS
    builds = {name: _start_build(name, _build.CSRC, patches) for name, patches in variants.items()}
    if args.parent is not None:
        builds["parent"] = _start_build("parent", args.parent, [])
    _build.load_library()
    libs = {name: _finish_build(name, lib, proc) for name, (lib, proc) in builds.items()}

    def kernels(x, wt, bias, a, b, out, fuse):
        fns = {"tree": (lambda: C.gn_silu_conv3x3(x, a, b, wt, bias)) if fuse
               else (lambda: C.conv3x3(x, wt, bias))}
        for name, so in libs.items():
            fns[name] = _caller(so, dtype, x, wt, bias, a, b, out, fuse)
        return fns

    result = {"device": smi, "dtype": args.dtype, "errors": {}, "ms": {}}
    # errors: bf16 at a small batch (2^-7 of max|plain out|), f32 at the
    # smoke run's f32 shapes (1e-5), as fractions of max|plain out|
    tol = 1e-5 if f32 else 2.0 ** -7
    for shape in (F32_CHECK_SHAPES if f32 else [(8,) + s[1:] for s in SHAPES]):
        x, wt, bias, a, b = _inputs(*shape, seed=3, dtype=dtype)
        for fuse in (False, True):
            ref = C.reference_conv3x3(x, wt, bias, *((a, b) if fuse else ())).float()
            scale = ref.abs().max().item()
            out = torch.empty(*shape[:3], shape[4], dtype=dtype, device="cuda")
            for name, fn in kernels(x, wt, bias, a, b, out, fuse).items():
                if name not in CHECKED:
                    continue
                err = (fn().float() - ref).abs().max().item() / scale
                entry = "gn_silu_conv3x3" if fuse else "conv3x3"
                result["errors"][f"{entry} {list(shape)} {name}"] = err
                print(f"[check] {entry} {list(shape)} {args.dtype} {name}: max abs err / max|plain "
                      f"out| {err:.4g} (tol {tol:.4g})", flush=True)
            del ref, out
        del x, wt
        torch.cuda.empty_cache()
    peak = PEAK_TF32 / 3 if f32 else PEAK_BF16
    for shape in SHAPES:
        n, h, w, cin, cout = shape
        x, wt, bias, a, b = _inputs(*shape, seed=1, dtype=dtype)
        out = torch.empty(n, h, w, cout, dtype=dtype, device="cuda")
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as cuDNN takes it
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        a4, b4 = a[:, :, None, None], b[:, :, None, None]
        flops = 2 * n * h * w * cout * 9 * cin
        for fuse in (False, True):
            fns = kernels(x, wt, bias, a, b, out, fuse)
            if fuse:
                fns["cudnn"] = lambda: F.conv2d(F.silu(x_nchw.float() * a4 + b4).to(dtype),
                                                w_oihw, bias.to(dtype), padding=1)
            else:
                fns["cudnn"] = lambda: F.conv2d(x_nchw, w_oihw, bias.to(dtype), padding=1)
            times = _turns(fns)
            entry = "gn_silu_conv3x3" if fuse else "conv3x3"
            result["ms"][f"{entry} {list(shape)}"] = times
            print(f"[time] {entry} {list(shape)} {args.dtype}, ms (TFLOP/s; bound "
                  f"{flops / peak * 1e3:.4f} ms): " + ", ".join(
                      f"{k} {v:.4f} ({flops / v / 1e9:.1f})" for k, v in times.items()),
                  flush=True)
        del x, wt, out
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
