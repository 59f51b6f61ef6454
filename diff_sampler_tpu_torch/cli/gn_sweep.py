"""Kernel K3 (the fused GroupNorm) on every route it could take, on one GPU.

  python -m diff_sampler_tpu_torch.cli.gn_sweep

At each shape of ``SHAPES`` (the U-Net levels of the CIFAR-10, ImageNet-64,
LSUN LDM and SD paths and the VQ decoder's largest, at their batches), runs
the slab route at every cluster size of ``ops.groupnorm.CLUSTER_SIZES`` that
holds the slab and the stream route, in turns, on the same data, and prints
each one's device time per kernel (``torch.profiler``, kernels only, so host
overhead is left out), its share of the bytes bound (x read once, out written
once, at 3.35 TB/s), how many of its clusters the card holds at once, and its
error against the plain version; then which route ``gn_route`` picks.  This
is the sweep that ``gn_route``'s rule rests on.

  python -m diff_sampler_tpu_torch.cli.gn_sweep --phases

instead times the phases of each slab block at the shapes whose route is
the slab (copy, first pass, cluster exchange, second pass, exchange, apply),
by building a copy of ``csrc/groupnorm.cu`` with a ``%globaltimer`` stamp at
each phase boundary into its own library under ``csrc/build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from .. import _build
from ..ops import groupnorm as G

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM
# (N, H, W, C, dtype, silu): CIFAR-10's 32x32 level (the main path), the LDM
# U-Net's 64x64 level, ImageNet-64's 64x64 level, the LDM's 8x8 level, the
# CIFAR-10 AMED batch in f32, CIFAR-10's 8x8 and 16x16 levels, SD's 64x64
# level, the f32 D gradient's batch 8, and the VQ decoder's 256x256 level
SHAPES = [(256, 32, 32, 256, torch.bfloat16, False), (64, 64, 64, 224, torch.bfloat16, True),
          (256, 64, 64, 192, torch.bfloat16, False), (64, 8, 8, 1568, torch.bfloat16, True),
          (512, 32, 32, 256, torch.float32, False), (256, 8, 8, 256, torch.bfloat16, False),
          (256, 16, 16, 256, torch.bfloat16, False), (16, 64, 64, 320, torch.bfloat16, True),
          (8, 32, 32, 256, torch.float32, False), (16, 256, 256, 128, torch.float32, True)]
REPS = 10
GROUPS = 32


def _routes(n, h, w, c, dtype) -> dict:
    hw, elt, vec = h * w, torch.empty((), dtype=dtype).element_size(), G._vec(c, dtype)
    out = {}
    for size in G.CLUSTER_SIZES:
        route = G._slab_route(n, hw, c, GROUPS, elt, vec, size) if size <= hw else None
        if route is not None:
            out[f"slab{size}"] = route
    out["stream"] = G._stream_route(n, hw, c, elt, vec)
    return out


def _device_ms(fn) -> dict:
    """Device ms per call of each of K3's kernels over REPS calls.  A trace
    that holds none of them (the profiler drops a window now and then) is
    taken again, up to three times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            for kernel in ("gn_slab_kernel", "gn_stream_stats_kernel", "gn_stream_apply_kernel"):
                if kernel in e.key:
                    out[kernel] = out.get(kernel, 0.0) + e.device_time_total / 1e3 / REPS
        if out:
            return out
    raise RuntimeError("three traces held none of K3's kernels")


def sweep() -> list:
    g = torch.Generator("cuda").manual_seed(0)
    results = []
    for n, h, w, c, dtype, silu in SHAPES:
        x = (torch.randn(n, h, w, c, generator=g, device="cuda") * 3 + 1).to(dtype)
        scale = 1 + 0.5 * torch.randn(c, generator=g, device="cuda")
        bias = torch.randn(c, generator=g, device="cuda")
        ref = G.reference_groupnorm_silu(x, scale, bias, groups=GROUPS, apply_silu=silu).float()
        routes = _routes(n, h, w, c, dtype)
        errs = {name: (G._launch(x, scale, bias, GROUPS, 1e-5, silu, route=r).float() - ref)
                .abs().max().item() for name, r in routes.items()}
        del ref
        runs = {name: [] for name in routes}
        for name in list(routes) + list(reversed(list(routes))):  # in turns
            runs[name].append(_device_ms(
                lambda r=routes[name]: G._launch(x, scale, bias, GROUPS, 1e-5, silu, route=r)))
        bound_ms = 2 * x.numel() * x.element_size() / PEAK_BYTES_PER_S * 1e3
        chosen = G.gn_route(n, h, w, c, dtype)
        for name, route in routes.items():
            kernels = {k: sum(r.get(k, 0.0) for r in runs[name]) / len(runs[name])
                       for k in runs[name][0]}
            ms = sum(kernels.values())
            row = dict(shape=[n, h, w, c], dtype=str(dtype).replace("torch.", ""), silu=silu,
                       route=name, chosen=route == chosen, ms=ms, kernels=kernels,
                       bound_ms=bound_ms, share_of_bound=bound_ms / ms, smem=route.smem,
                       clusters_at_once=G.active_clusters(route, dtype)
                       if route.kind == "slab" else None, max_abs_err=errs[name])
            results.append(row)
            print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()
    return results


# The phase stamps of --phases: (anchor in gn_slab_kernel, stamp before, stamp
# after); stamp i is block b's %globaltimer (ns) into slot b * 8 + i.
_STAMPS = [("  cg::cluster_group cluster = cg::this_cluster();\n", None, 0),
           ("    cp_async_wait<0>();\n  }\n", None, 1),
           ("  group_partials(lane, psum, c, groups, lanes);\n  cluster.sync();\n", None, 2),
           ("  // pass 2: the centred squares\n", 3, None),
           ("  group_partials(lane, pm2, c, groups, lanes);\n  cluster.sync();\n", None, 4),
           ('  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");\n', 5,
            None),
           ('  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n', 6, 7)]
PHASES = ["copy (each warp its own vectors, then a block barrier)", "first pass + block sums "
          "+ cluster barrier", "cluster means", "second pass + block sums + cluster barrier",
          "cluster variances", "apply", "exit wait"]


def _phase_library():
    src = (_build.CSRC / "groupnorm.cu").read_text()
    head = ("__device__ long long* g_stamps;\n"
            "#define STAMP(i) do { if (threadIdx.x == 0) { long long t; asm volatile("
            "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); g_stamps[blockIdx.x * 8 + (i)] = t; } "
            "} while (0)\n")
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n" + head)
    k0, k1 = src.index("gn_slab_kernel(const T*"), src.index("gn_stream_stats_kernel(const T*")
    body = src[k0:k1]
    for anchor, before, after in _STAMPS:
        if body.count(anchor) != 1:
            raise RuntimeError(f"the slab kernel no longer holds {anchor!r}")
        sync = "  __syncthreads();\n" if after == 1 else ""
        body = body.replace(anchor, (f"  STAMP({before});\n" if before is not None else "")
                            + anchor + sync
                            + (f"  STAMP({after});\n" if after is not None else ""))
    src = src[:k0] + body + src[k1:]
    src += ('\nextern "C" int dst_gn_stamps(void* p) { return static_cast<int>('
            'cudaMemcpyToSymbol(g_stamps, &p, sizeof(p))); }\n')
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _build.BUILD_DIR / "gn_phases.cu", _build.BUILD_DIR / "libgn_phases.so"
    cu.write_text(src)
    built = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-shared", "-o", str(so), str(cu)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{built.stdout}{built.stderr}")
    lib, real = ctypes.CDLL(str(so)), _build.load_library()
    lib.dst_groupnorm_silu.argtypes = real.dst_groupnorm_silu.argtypes
    lib.dst_groupnorm_silu.restype = ctypes.c_int
    lib.dst_gn_stamps.argtypes = [ctypes.c_void_p]
    lib.dst_error_string = real.dst_error_string
    return lib


def phases() -> list:
    lib, real = _phase_library(), _build.load_library()
    results = []
    for n, h, w, c, dtype, silu in SHAPES:
        route = G.gn_route(n, h, w, c, dtype)
        if route.kind != "slab":
            continue
        x = torch.randn(n, h, w, c, device="cuda").to(dtype)
        scale, bias = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        stamps = torch.zeros(route.cluster * n * 8, dtype=torch.int64, device="cuda")
        lib.dst_gn_stamps(stamps.data_ptr())
        _build._lib = lib  # the wrapper's launches go to the stamped copy
        try:
            for _ in range(3):
                G._launch(x, scale, bias, GROUPS, 1e-5, silu, route=route)
            torch.cuda.synchronize()
        finally:
            _build._lib = real
        t = stamps.view(-1, 8).cpu().numpy().astype(np.float64)
        d = np.diff(t, axis=1) / 1e3
        row = dict(shape=[n, h, w, c], dtype=str(dtype).replace("torch.", ""),
                   cluster=route.cluster, blocks=len(t),
                   median_us={p: float(np.median(d[:, k])) for k, p in enumerate(PHASES)},
                   block_life_us=float(np.median(d.sum(axis=1))))
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", action="store_true",
                        help="time the phases of each slab block instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gn_sweep needs a CUDA device")
    print(f"[gn_sweep] {torch.cuda.get_device_name(0)}", flush=True)
    return phases() if args.phases else sweep()


if __name__ == "__main__":
    main()
