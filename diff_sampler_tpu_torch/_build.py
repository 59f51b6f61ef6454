"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

The kernels have a plain C interface, so they build in seconds, with no
PyTorch headers: one ``nvcc -c`` per source, all started together, then one
``nvcc -shared`` link.  The library is built at first use
into ``csrc/build/`` (listed in ``.gitignore``) and named after a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "check", "find_nvcc", "library_path", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None
# Seconds the last build took (None: the library was already built) and
# nvcc's report of registers and shared memory per kernel.
build_seconds = None
build_log = ""


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library of the current sources and flags is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdst_kernels_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [proc.communicate()[0] for proc in procs]
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = [link.returncode] if link.returncode != 0 else []
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed}):\n{build_log}")
    path.with_suffix(".log").write_text(build_log)
    os.replace(tmp, path)  # atomic: a concurrent process sees all or nothing


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # q, k, v, out, lse; B, T, H, d; 12 strides; scale, dtype; the route
    # (padded d, load mode, block_q, block_k); stream
    lib.dst_flash_attn_fwd.argtypes = ([p] * 5 + [i] * 4 + [ll] * 12
                                       + [ctypes.c_float] + [i] * 5 + [p])
    lib.dst_flash_attn_fwd.restype = i
    # the flat layout: q, k, v, out, lse; B, T, d; 9 strides
    lib.dst_flash_attn_fwd_flat.argtypes = ([p] * 5 + [i] * 3 + [ll] * 9
                                            + [ctypes.c_float] + [i] * 5 + [p])
    lib.dst_flash_attn_fwd_flat.restype = i
    # the f32 kernels' entries take the same arguments
    lib.dst_flash_attn_fwd_tf32.argtypes = lib.dst_flash_attn_fwd.argtypes
    lib.dst_flash_attn_fwd_tf32.restype = i
    lib.dst_flash_attn_fwd_tf32_flat.argtypes = lib.dst_flash_attn_fwd_flat.argtypes
    lib.dst_flash_attn_fwd_tf32_flat.restype = i
    # the backward, bf16 and f32 (_tf32) alike: q, k, v, dO, lse, delta, then
    # dq (or dk, dv); B, T, H, d (the flat layout: B, T, d); 16 strides (flat:
    # 12); scale, dtype; the route (padded d, load mode, block rows, tile
    # rows); stream
    for kernel, outs in (("dq", 1), ("dkv", 2)):
        for layout, dims in (("", 4), ("_flat", 3)):
            for dtype in ("", "_tf32"):
                entry = getattr(lib, f"dst_flash_attn_bwd_{kernel}{dtype}{layout}")
                entry.argtypes = ([p] * (6 + outs) + [i] * dims + [ll] * (4 * dims)
                                  + [ctypes.c_float] + [i] * 5 + [p])
                entry.restype = i
    # x, scale, bias, out, scratch, arrivals; n, hw, c, groups; eps; silu, vec,
    # dtype, then the route (kind, cluster, threads, rows, smem)
    lib.dst_groupnorm_silu.argtypes = [p] * 6 + [i] * 4 + [ctypes.c_float] + [i] * 8 + [p]
    lib.dst_groupnorm_silu.restype = i
    # dtype, vec, cluster, threads, smem
    lib.dst_groupnorm_active_clusters.argtypes = [i] * 5
    lib.dst_groupnorm_active_clusters.restype = i
    # x, a, b, w (f32: w_hi, w_lo), bias, out; n, h, w, cin, cout, fuse, then
    # the patch (tile_h, tile_w)
    lib.dst_conv3x3_f32.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.dst_conv3x3_f32.restype = i
    lib.dst_conv3x3_bf16.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.dst_conv3x3_bf16.restype = i
    # w, w_hi, w_lo; cin, cout
    lib.dst_conv3x3_split_w.argtypes = [p] * 3 + [i] * 2 + [p]
    lib.dst_conv3x3_split_w.restype = i
    lib.dst_error_string.argtypes = [i]
    lib.dst_error_string.restype = ctypes.c_char_p


def load_library():
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
    return _lib


def check(lib, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib.dst_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
