"""Kernel K4 in bf16 beside variants of its own source, on one GPU.

  python -m diff_sampler_tpu_torch.cli.conv_variants [--parent CSRC_DIR]

At CIFAR-10's [256, 32, 32, 256] -> 256 and FFHQ's [256, 64, 64, 128] ->
128, through both entry points, times in turns (CUDA events; the median of
rounds run in both orders) K4 as built from ``csrc/``, copies of
``csrc/conv3x3.cu`` changed as ``VARIANTS`` says (each built with nvcc into
its own library under ``csrc/build/variants/``), ``F.conv2d`` (cuDNN, TF32
off; after the SiLU pass for the fused entry) and, with ``--parent``, the
``conv3x3.cu`` of another checkout's ``csrc/`` directory: an earlier
commit's K4 through its entry ``dst_conv3x3(x, a, b, w, bias, out, n, h, w,
cin, cout, fuse, dtype, stream)`` (w as [3, 3, Cin, Cout]).  Each kernel's
error against the plain version is printed first, at a small batch.  The
variants ask what bounds the kernel:

  noprologue  the fused entry without the prologue's arithmetic (its output
              is not the conv of silu(x * a + b): timed, its error is not)
  nostore     no output stores (timed only)
  tanh        the prologue's silu through tanh.approx, one MUFU op a value
              in place of two (not an f32 silu: its error is printed)
  ilp4        four pixels in flight per prologue thread in place of two
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
CHECKED = ("tree", "tanh", "ilp4", "parent")


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


def _finish_build(name: str, lib: Path, proc, parent: bool):
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-4000:]}")
    spills = sorted({line.strip() for line in log.splitlines() if "spill" in line})
    print(f"[build] {name}: {'; '.join(spills)}", flush=True)
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    entry = so.dst_conv3x3 if parent else so.dst_conv3x3_bf16
    entry.argtypes = [p] * 6 + [i] * (7 if parent else 8) + [p]
    entry.restype = i
    return entry


def _caller(entry, parent: bool, x, w, wt, bias, a, b, out, fuse: bool):
    """A call of a variant's (or the parent's) entry on these tensors."""
    n, h, wd, cin = x.shape
    cout = out.shape[-1]
    plan = C.conv_plan(n, h, wd, cin, cout)
    ab = (a.data_ptr() if fuse else None, b.data_ptr() if fuse else None)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if parent:
            err = entry(x.data_ptr(), *ab, w.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h,
                        wd, cin, cout, int(fuse), 1, stream)
        else:
            err = entry(x.data_ptr(), *ab, wt.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h,
                        wd, cin, cout, int(fuse), plan.tile_h, plan.tile_w, stream)
        if err:
            raise RuntimeError(f"conv3x3 variant failed: CUDA error {err}")
        return out
    return run


def _inputs(n, h, w, cin, cout, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g, device="cuda").bfloat16()
    wt = (torch.randn(3, 3, cin, cout, generator=g, device="cuda") / (3 * cin ** 0.5)).bfloat16()
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
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier checkout's csrc/ directory, whose K4 is timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_variants needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    builds = {name: _start_build(name, _build.CSRC, patches) for name, patches in VARIANTS.items()}
    if args.parent is not None:
        builds["parent"] = _start_build("parent", args.parent, [])
    _build.load_library()
    entries = {name: _finish_build(name, lib, proc, name == "parent")
               for name, (lib, proc) in builds.items()}

    def kernels(x, wt, bias, a, b, out, fuse):
        wtt = wt.permute(0, 1, 3, 2).contiguous()
        fns = {"tree": (lambda: C.gn_silu_conv3x3(x, a, b, wt, bias)) if fuse
               else (lambda: C.conv3x3(x, wt, bias))}
        for name, entry in entries.items():
            fns[name] = _caller(entry, name == "parent", x, wt, wtt, bias, a, b, out, fuse)
        return fns

    result = {"device": smi, "errors": {}, "ms": {}}
    for shape in SHAPES:
        small = (8,) + shape[1:]
        x, wt, bias, a, b = _inputs(*small, seed=3)
        for fuse in (False, True):
            ref = C.reference_conv3x3(x, wt, bias, *((a, b) if fuse else ())).float()
            tol = 2.0 ** -7 * ref.abs().max().item()
            out = torch.empty(*small[:3], small[4], dtype=torch.bfloat16, device="cuda")
            for name, fn in kernels(x, wt, bias, a, b, out, fuse).items():
                if name not in CHECKED:
                    continue
                err = (fn().float() - ref).abs().max().item()
                entry = "gn_silu_conv3x3" if fuse else "conv3x3"
                result["errors"][f"{entry} {list(small)} {name}"] = err
                print(f"[check] {entry} {list(small)} {name}: max abs err {err:.4g} (tol "
                      f"{tol:.4g})", flush=True)
    for shape in SHAPES:
        n, h, w, cin, cout = shape
        x, wt, bias, a, b = _inputs(*shape, seed=1)
        out = torch.empty(n, h, w, cout, dtype=torch.bfloat16, device="cuda")
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as cuDNN takes it
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        a4, b4 = a[:, :, None, None], b[:, :, None, None]
        flops = 2 * n * h * w * cout * 9 * cin
        for fuse in (False, True):
            fns = kernels(x, wt, bias, a, b, out, fuse)
            if fuse:
                fns["cudnn"] = lambda: F.conv2d(F.silu(x_nchw.float() * a4 + b4).bfloat16(),
                                                w_oihw, bias.bfloat16(), padding=1)
            else:
                fns["cudnn"] = lambda: F.conv2d(x_nchw, w_oihw, bias.bfloat16(), padding=1)
            times = _turns(fns)
            entry = "gn_silu_conv3x3" if fuse else "conv3x3"
            result["ms"][f"{entry} {list(shape)}"] = times
            print(f"[time] {entry} {list(shape)} bf16, ms (TFLOP/s; bound "
                  f"{flops / PEAK_BF16 * 1e3:.4f} ms): " + ", ".join(
                      f"{k} {v:.4f} ({flops / v / 1e9:.1f})" for k, v in times.items()),
                  flush=True)
        del x, wt, out
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
