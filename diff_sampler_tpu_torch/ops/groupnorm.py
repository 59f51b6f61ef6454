"""GroupNorm (+ affine) (+ SiLU) over NHWC: the plain version and the
wrapper of kernel K3.

Counterpart of ``diff_sampler_tpu/ops/pallas_groupnorm.py``.
``reference_groupnorm_silu`` is the plain version, the function of the JAX
package's default path ``_jnp_gn``: f32 statistics in one sum /
sum-of-squares pass, the variance clamped at 0, the per-(sample, channel)
affine folded into one multiply-add, optional SiLU, and the result cast back
to the input dtype.

``groupnorm_silu`` is what every layer calls.  On a CUDA tensor it launches
kernel K3 (``csrc/groupnorm.cu``, which replaces the Pallas ``_gn_kernel``)
or raises; only a tensor on the CPU takes the plain version.  K3 computes its
statistics in exact two-pass sums (the plain version's E[x^2] - E[x]^2 in f32
is the less precise of the two), so the two agree to f32 rounding, not bit for
bit.  Under autograd K3 runs inside ``_GroupNormK3``, whose backward is the
plain version's VJP recomputed from the saved x, scale and bias: the JAX
package's ``_gn_bwd``, which has no kernel either.  That backward is itself
differentiable, so a second-order gradient through K3 is exact.

``gn_route`` picks K3's design for a shape, mirroring the constants of the C
source: ``slab`` (one kernel, one thread-block cluster of 1-16 blocks per
sample holding the sample's [H*W, C] slab in shared memory, x read once)
wherever a cluster holds the slab, else ``stream`` (a statistics kernel that
also finalizes a and b, then an apply kernel; x read twice).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["GnRoute", "active_clusters", "cluster_rows", "gn_route", "groupnorm_silu",
           "reference_groupnorm_silu"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"slab": 0, "stream": 1}
# Mirrors of csrc/groupnorm.cu: blocks per cluster (non-portable above 8),
# the shared memory a block may opt into, and the threads of a block.
MAX_CLUSTER = 16
SMEM_LIMIT = 232448
SLAB_THREADS = 256
STREAM_THREADS = 256
# The route's choice, from a timed sweep of every cluster size against the
# stream route on an H100 (PERF.md §6, K3): cluster sizes that pack whole
# into the card's GPCs, the smallest whose blocks fit two to an SM (each
# block's copy, sums and stores run in turn, so a second block is what
# overlaps them), else the smallest of at most 8 blocks that fits at all;
# where only 16 blocks of one to an SM would hold the slab (7 clusters at
# once, 112 of 132 SMs), the stream route was faster at every such shape.
# The stream route cuts each sample into chunks so that the batch gives
# about _STREAM_BLOCKS[element bytes] blocks: 3 per SM of the 132 in bf16,
# 8 in f32 (the same sweep's best over 396-1056 blocks).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
_SM_SMEM = 233472       # shared memory of an SM
_BLOCK_RESERVED = 1024  # of it, reserved per resident block
_STREAM_BLOCKS = {2: 3 * 132, 4: 8 * 132}


def reference_groupnorm_silu(x, scale, bias, *, groups: int, eps: float = 1e-5,
                             apply_silu: bool = True):
    """The plain version.  x: [N, H, W, C]; scale, bias: [C]."""
    n, h, w, c = x.shape
    cg = c // groups
    xf = x.float()  # cast once: both passes read it
    xg = xf.reshape(n, h * w, groups, cg)
    cnt = h * w * cg
    mean = xg.sum(dim=(1, 3)) / cnt                              # [n, g]
    var = (xg.square().sum(dim=(1, 3)) / cnt - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    a = inv[:, :, None] * scale.float().reshape(groups, cg)      # [n, g, cg]
    b = bias.float().reshape(groups, cg) - mean[:, :, None] * a
    out = torch.addcmul(b.reshape(n, 1, 1, c), xf, a.reshape(n, 1, 1, c))  # x * a + b
    if apply_silu:
        out = F.silu(out)
    return out.to(x.dtype)


class GnRoute(NamedTuple):
    kind: str      # "slab" or "stream"
    cluster: int   # blocks per cluster (slab), 0 on the stream route
    rows: int      # most rows of x a block takes
    smem: int      # dynamic shared memory of a block (stream: of its statistics kernel)
    kernels: int   # CUDA kernels a launch runs
    threads: int   # threads of a block
    vec: int       # channels per 16-byte vector, or 1


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def _lanes(threads: int, c: int, elt: int) -> int:
    """``lanes_of``: threads per column of 16 bytes of channels."""
    return max(1, threads // -(-c * elt // 16))


def _vec(c: int, dtype) -> int:
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return vec if c % vec == 0 else 1


def _slab_smem(hw: int, c: int, groups: int, cluster: int, threads: int, elt: int) -> int:
    """``slab_layout(...).bytes`` of the C source: the block's rows of x, the
    lanes' f32 partials, then per group two f64 and two f32 values."""
    lane = _align(-(-hw // cluster) * c * elt, 16)
    return _align(lane + _lanes(threads, c, elt) * c * 4, 8) + 24 * groups


def _slab_route(n: int, hw: int, c: int, groups: int, elt: int, vec: int,
                cluster: int):
    """The slab route at this cluster size, or None where its block does not
    fit."""
    smem = _slab_smem(hw, c, groups, cluster, SLAB_THREADS, elt)
    if smem > SMEM_LIMIT:
        return None
    return GnRoute("slab", cluster, -(-hw // cluster), smem, 1, SLAB_THREADS, vec)


def _stream_route(n: int, hw: int, c: int, elt: int, vec: int) -> GnRoute:
    chunks = min(max(1, math.ceil(_STREAM_BLOCKS[elt] / max(n, 1))), hw)
    return GnRoute("stream", 0, -(-hw // chunks), 8 * _lanes(STREAM_THREADS, c, elt) * c, 2,
                   STREAM_THREADS, vec)


@functools.lru_cache(maxsize=4096)
def gn_route(n: int, h: int, w: int, c: int, dtype, *, groups: int = 32,
             vec: int | None = None) -> GnRoute:
    """K3's route for x [n, h, w, c] of ``dtype`` (``vec``: channels per
    vector, by default 16 bytes' worth where c allows; the wrapper passes 1
    for an unaligned x)."""
    hw, elt = h * w, torch.empty((), dtype=dtype).element_size()
    vec = _vec(c, dtype) if vec is None else vec
    fits = [r for r in (_slab_route(n, hw, c, groups, elt, vec, s) for s in CLUSTER_SIZES
                        if s <= hw) if r is not None]
    two = [r for r in fits if 2 * (r.smem + _BLOCK_RESERVED) <= _SM_SMEM]
    one = [r for r in fits if r.cluster <= 8]
    return (two or one or [_stream_route(n, hw, c, elt, vec)])[0]


def active_clusters(route: GnRoute, dtype) -> int:
    """How many clusters of a slab route the card holds at once (the C
    entry refuses a route at 0), by ``cudaOccupancyMaxActiveClusters``."""
    lib = _build.load_library()
    got = lib.dst_groupnorm_active_clusters(_DTYPE_CODES[dtype], route.vec, route.cluster,
                                            route.threads, route.smem)
    if got < 0:
        _build.check(lib, -got, "GroupNorm cluster query")
    return got


def cluster_rows(hw: int, cluster: int) -> list:
    """[(first row, end row)] of each rank of a slab cluster, as the kernel
    splits H*W: rank r takes [r * hw // cluster, (r + 1) * hw // cluster)."""
    return [(r * hw // cluster, (r + 1) * hw // cluster) for r in range(cluster)]


# Per-sample arrival counters of the stream route, zeroed once and left
# zeroed by each launch's last blocks, per (device, stream).
_ARRIVALS = {}


def _arrivals(device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    got = _ARRIVALS.get(key)
    if got is None or got.numel() < n:
        got = _ARRIVALS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return got


def _launch(x, scale, bias, groups, eps, apply_silu, route=None):
    """K3 on a CUDA tensor: returns out, [N, H, W, C] in x's dtype.  ``route``
    (private, for the card's tests) replaces ``gn_route``'s choice."""
    if x.device.type != "cuda":
        raise ValueError(f"no GroupNorm kernel for device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be a float32 or bfloat16 [N, H, W, C], got "
                        f"{tuple(x.shape)} {x.dtype}")
    n, h, w, c = x.shape
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be [{c}], got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if not (scale.device == bias.device == x.device):
        raise ValueError("x, scale and bias lie on different devices")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    hw = h * w
    vec = _vec(c, x.dtype)
    if x.data_ptr() % 16:
        vec = 1
    if route is None:
        route = gn_route(n, h, w, c, x.dtype, groups=groups, vec=vec)
    if route.vec != vec:
        raise ValueError(f"route for {route.vec} channels a vector, x takes {vec}")
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        scratch = arrivals = None
        if route.kind == "stream":
            chunks = -(-hw // route.rows)
            scratch = torch.empty(16 * n * chunks * groups + 8 * n * c, dtype=torch.uint8,
                                  device=x.device)
            arrivals = _arrivals(x.device, stream, n)
        err = lib.dst_groupnorm_silu(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if arrivals is None else arrivals.data_ptr(),
            n, hw, c, groups, float(eps), int(bool(apply_silu)), vec, _DTYPE_CODES[x.dtype],
            _KINDS[route.kind], route.cluster, route.threads, route.rows, route.smem, stream)
    _build.check(lib, err, "GroupNorm")
    groupnorm_silu.launches += 1
    groupnorm_silu.kernels += route.kernels
    return out


class _GroupNormK3(torch.autograd.Function):
    """K3 forward; backward: the plain version's VJP, recomputed."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = dict(groups=groups, eps=eps, apply_silu=apply_silu)
        return _launch(x, scale, bias, groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        # a backward that autograd records (create_graph) recomputes from the
        # saved tensors themselves, so that its result is differentiable
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            leaves = [t if create else t.detach().requires_grad_(n)
                      for t, n in zip((x, scale, bias), need)]
            out = reference_groupnorm_silu(*leaves, **ctx.args)
            wrt = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(out, wrt, g, create_graph=create))
        return (*(next(got) if n else None for n in need), None, None, None)


def groupnorm_silu(x, scale, bias, *, groups: int, eps: float = 1e-5,
                   apply_silu: bool = True):
    """GroupNorm + affine (+ SiLU).  x: [N, H, W, C]; scale, bias: [C].
    Kernel K3 on a CUDA tensor (differentiable), the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return reference_groupnorm_silu(x, scale, bias, groups=groups, eps=eps,
                                        apply_silu=apply_silu)
    return _GroupNormK3.apply(x, scale, bias, groups, eps, apply_silu)


groupnorm_silu.launches = 0  # K3 launches since the last reset
groupnorm_silu.kernels = 0  # CUDA kernels of those launches (gn_route's ``kernels`` each)
