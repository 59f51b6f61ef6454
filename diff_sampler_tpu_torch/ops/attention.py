"""Scaled-dot-product attention: the plain versions, the wrappers of kernels
K1 and K1c (forward) and K2 and K2c (backward), and the route between them.

``flash_attention_mh`` (K1) wraps the hand-written CUDA kernels of
``csrc/flash_attn_fwd.cu`` on the multi-head [B, T, H, d] layout, which
replaces ``diff_sampler_tpu/ops/pallas_attention.py::_attn_kernel_mh`` and,
at head dims below 128, its packed twin ``_attn_kernel_mh_packed`` (K1b).
``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` (K2) wrap the
kernels of ``csrc/flash_attn_bwd.cu`` (bf16) and ``csrc/flash_attn_bwd_tf32.cu``
(f32), which replace ``_bwd_dq_kernel_mh``, ``_bwd_dkv_kernel_mh`` and
their packed and streamed twins (K2p, K2b).  The
TPU packs 128 // d heads into one matmul to fill the MXU's lanes; here every
head dim takes one head per block.

``flash_attention`` (K1c) and ``flash_attention_flat_bwd_dq`` /
``flash_attention_flat_bwd_dkv`` (K2c) are the same kernels' entries on the
flat [B, T, d] layout (B folds batch * heads), the counterparts of the JAX
``flash_attention`` (``_attn_kernel``) and its VJP ``_flash_bwd``
(``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).

On a CUDA tensor each wrapper launches its kernel or raises; only a tensor
on the CPU takes the plain version (``reference_sdpa`` and its backward
pieces, ``reference_flash_attention`` and its).  The kernels take any head
dim that is a multiple of 8 up to 256 (padded inside the kernel, see the
sources).  They read q, k and v once per tile and never write the [T, T]
logits, which the plain versions materialise in f32.  ``fwd_route`` picks
the forward kernel of a call: both dtypes run on the tensor cores (mma.sync;
bf16 in ``csrc/flash_attn_fwd.cu``, f32 in 3xTF32 in
``csrc/flash_attn_fwd_tf32.cu``), with 16-byte cp.async copies where the
views allow them and a gather elsewhere, 16 bytes at a time from the
interleaved qkv rows.  ``bwd_route`` picks the backward kernels of a call:
both dtypes on the tensor cores (bf16 in ``csrc/flash_attn_bwd.cu``, f32 in
3xTF32 in ``csrc/flash_attn_bwd_tf32.cu``), with cp.async where the four
views allow it, in bf16 from the interleaved qkv rows, and the element
gather elsewhere.

``sdpa`` is differentiable: it runs the ``torch.autograd.Function``
``_FlashAttentionMH`` (K1 forward, K2 backward; the JAX
``flash_attention_mh`` is a ``jax.custom_vjp``), or ``_FlashAttention`` (K1c,
K2c) where ``takes_flat_kernel`` says the JAX ``sdpa`` takes its flat
kernel.  Under ``torch.no_grad``, or on inputs that need no gradient, a
Function records no graph, so what it saves is freed with its output's
context.  The kernels' backward is not itself differentiable: on the card a
backward that autograd records (``torch.autograd.grad(...,
create_graph=True)`` through attention whose inputs need a gradient, as an
AMED step through classifier guidance takes it) raises rather than drop the
second-order term, as the JAX package has no second-order path through its
Pallas attention either.  On the CPU such a backward is the plain forward's
own VJP, recorded, so the second order is exact there.

Layout: q, k, v are [B, T, H, d] (the token layout of the U-Nets); they may
be strided views, such as the interleaved split of the qkv projection.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import _build

__all__ = ["MAX_HEAD_DIM", "TC_PADDED_DIMS", "TF32_PADDED_DIMS",
           "BwdRoute", "FwdRoute", "bwd_route", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_flat_bwd_dkv", "flash_attention_flat_bwd_dq",
           "flash_attention_mh", "flash_attention_mh_bwd", "fwd_route",
           "reference_flash_attention", "reference_flash_attention_bwd",
           "reference_flash_attention_bwd_dkv", "reference_flash_attention_bwd_dq",
           "reference_sdpa", "reference_sdpa_bwd", "reference_sdpa_bwd_dkv",
           "reference_sdpa_bwd_dq", "sdpa", "supports_head_dim", "takes_flat_kernel"]

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def supports_head_dim(d: int) -> bool:
    """The kernels take a head dim that is a multiple of 8 up to 256."""
    return d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM


# The padded head dims the attention kernels are built for: the bf16
# kernels (``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``) contract
# over d in k-steps of 16, the f32 kernels (``csrc/flash_attn_fwd_tf32.cu``,
# ``csrc/flash_attn_bwd_tf32.cu``, 3xTF32) in k-steps of 8.  A call takes the
# smallest that holds its d.
TC_PADDED_DIMS = (16, 32, 48, 64, 80, 128, 160, 256)
TF32_PADDED_DIMS = (16, 32, 40, 64, 80, 128, 160, 256)
_LOAD_CODES = {"cp_async": 1, "gather": 2, "qkv_span": 3}
# padded dims whose rows split into groups of 32 units of 16 bytes (8 bf16 or
# 4 f32 columns) and whose raw stage fits: the gather from the qkv rows
_SPAN_DIMS = {torch.bfloat16: (32, 64, 128, 256), torch.float32: (32, 64)}
# the C entry of each (kernel, layout): [B, T, H, d] or flat [B, T, d]
_FWD_ENTRIES = {("tensor_cores", 4): "dst_flash_attn_fwd",
                ("tensor_cores", 3): "dst_flash_attn_fwd_flat",
                ("tensor_cores_3xtf32", 4): "dst_flash_attn_fwd_tf32",
                ("tensor_cores_3xtf32", 3): "dst_flash_attn_fwd_tf32_flat"}


class FwdRoute(NamedTuple):
    """The forward kernel a call takes, as its C entry is told it: ``kernel``
    "tensor_cores" (bf16, mma.sync m16n8k16) or "tensor_cores_3xtf32" (f32,
    mma.sync m16n8k8 in 3xTF32); ``load`` "cp_async" (16-byte copies) or
    "gather" (the other views); ``span``: the gather reads Q, K and V 16
    bytes at a time out of the interleaved rows of one qkv projection
    (element loads staged in registers otherwise); query rows per block, keys
    per tile and warps per block."""
    kernel: str
    padded_d: int
    load: str
    span: bool
    block_q: int
    block_k: int
    warps: int


def _aligned(x: torch.Tensor) -> bool:
    """16-byte token stride, and 16-byte batch and head strides where those
    dims have more than one entry (a size-1 dim never moves the pointer)."""
    vec = 16 // x.element_size()
    return all(s % vec == 0 for i, (n, s) in enumerate(zip(x.shape[:-1], x.stride()[:-1]))
               if n > 1 or i == 1)


def _copies16(x: torch.Tensor) -> bool:
    """Whether every row of x ([B, T, H, d] or [B, T, d]) can be read with
    16-byte copies: element stride 1, a 16-byte aligned base and strides."""
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and _aligned(x)


def _qkv_span(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether q, k, v are the views of one qkv projection's interleaved (c,
    qkv) channels (``models/layers.py::attention``): element stride 3, k one
    element past q and v one past k, the same strides, each row's start (q)
    16-byte aligned, and 16-byte strides."""
    elt = q.element_size()
    return (q.stride() == k.stride() == v.stride() and q.stride(-1) == 3
            and k.data_ptr() == q.data_ptr() + elt and v.data_ptr() == q.data_ptr() + 2 * elt
            and q.data_ptr() % 16 == 0 and _aligned(q))


def fwd_route(q, k, v) -> FwdRoute:
    """The forward kernel and its settings for q, k, v (one dtype, a head
    dim that ``supports_head_dim``): bf16 on the tensor cores, f32 on the
    tensor cores in 3xTF32, each with cp.async where all three views take
    16-byte copies and the gather elsewhere (for element stride 3, the
    interleaved qkv views, from the qkv rows where the padded dim allows;
    never on the flat layout in f32).  The tables mirror ``Tc`` in
    ``csrc/flash_attn_fwd.cu`` and ``Tf`` in ``csrc/flash_attn_fwd_tf32.cu``,
    whose entry points refuse any other route."""
    d = q.shape[-1]
    if q.dtype == torch.bfloat16:
        kernel = "tensor_cores"
        padded = next(p for p in TC_PADDED_DIMS if p >= d)
        two_tiles = 48 <= padded <= 80  # two m-tiles of 16 rows per warp
        warps = 4 if two_tiles else 8
        block_k = 64 if padded <= 64 else 32
        span_layout = True
    elif q.dtype == torch.float32:
        kernel = "tensor_cores_3xtf32"
        padded = next(p for p in TF32_PADDED_DIMS if p >= d)
        two_tiles, warps = False, 8
        block_k = 64 if padded <= 40 else 32 if padded <= 128 else 16
        span_layout = q.dim() == 4
    else:
        raise TypeError(f"no forward kernel for {q.dtype}")
    block_q = 16 * warps * (2 if two_tiles else 1)
    if all(_copies16(x) for x in (q, k, v)):
        return FwdRoute(kernel, padded, "cp_async", False, block_q, block_k, warps)
    span = span_layout and padded in _SPAN_DIMS[q.dtype] and _qkv_span(q, k, v)
    return FwdRoute(kernel, padded, "gather", span, block_q, block_k, warps)


# the C entries of each (kernel, layout): (dQ, dK/dV)
_BWD_ENTRIES = {("tensor_cores", 4): ("dst_flash_attn_bwd_dq", "dst_flash_attn_bwd_dkv"),
                ("tensor_cores", 3): ("dst_flash_attn_bwd_dq_flat",
                                      "dst_flash_attn_bwd_dkv_flat"),
                ("tensor_cores_3xtf32", 4): ("dst_flash_attn_bwd_dq_tf32",
                                             "dst_flash_attn_bwd_dkv_tf32"),
                ("tensor_cores_3xtf32", 3): ("dst_flash_attn_bwd_dq_tf32_flat",
                                             "dst_flash_attn_bwd_dkv_tf32_flat")}


class BwdRoute(NamedTuple):
    """The backward kernels a call takes (its dQ and dK/dV kernels share
    one route): ``kernel`` "tensor_cores" (bf16, mma.sync m16n8k16) or
    "tensor_cores_3xtf32" (f32, mma.sync m16n8k8 in 3xTF32); ``load``
    "cp_async" (16-byte copies), "qkv_span" (bf16: q, k, v 16 bytes at a
    time from the interleaved rows of one qkv projection, dO with 16-byte
    copies) or "gather" (element loads of any view); ``block_rows`` the rows
    a block owns (queries in the dQ kernel, keys in the dK/dV kernel),
    ``tile_rows`` the rows of the other side per streamed tile, ``warps``
    per block and ``split_d`` the warps that share one 16-row m-tile, each
    over a part of d."""
    kernel: str
    padded_d: int
    load: str
    block_rows: int
    tile_rows: int
    warps: int
    split_d: int


def bwd_route(q, k, v, do) -> BwdRoute:
    """The backward kernels and their settings for q, k, v and dO (one
    dtype, a head dim that ``supports_head_dim``, [B, T, H, d] or flat),
    both on the tensor cores, 8 warps a block, two warps sharing an m-tile
    over halves of d from padded d 128: bf16 (mma.sync m16n8k16) with
    cp.async where all four views take 16-byte copies, from the qkv rows
    where q, k, v are one projection's interleaved views (multi-head layout,
    the span's padded dims) and dO takes 16-byte copies, the element gather
    elsewhere; f32 in 3xTF32 with cp.async where all four views take 16-byte
    copies and the padded d is at most 160, the element gather elsewhere.
    The tables mirror ``Bb`` in ``csrc/flash_attn_bwd.cu`` and ``Bt`` in
    ``csrc/flash_attn_bwd_tf32.cu``, whose entries refuse any other route."""
    d = q.shape[-1]
    copies16 = all(_copies16(x) for x in (q, k, v, do))
    if q.dtype == torch.bfloat16:
        kernel = "tensor_cores"
        padded = next(p for p in TC_PADDED_DIMS if p >= d)
        tile = 64 if padded <= 64 else 32
        if copies16:
            load = "cp_async"
        elif (q.dim() == 4 and padded in _SPAN_DIMS[q.dtype] and _qkv_span(q, k, v)
              and _copies16(do)):
            load = "qkv_span"
        else:
            load = "gather"
    elif q.dtype == torch.float32:
        kernel = "tensor_cores_3xtf32"
        padded = next(p for p in TF32_PADDED_DIMS if p >= d)
        tile = 64 if padded <= 40 else 32 if padded <= 64 else 16
        load = "cp_async" if copies16 and padded <= 160 else "gather"
    else:
        raise TypeError(f"no backward kernel for {q.dtype}")
    split = 2 if padded >= 128 else 1
    return BwdRoute(kernel, padded, load, 16 * 8 // split, tile, 8, split)


# The JAX ``sdpa`` takes its flat kernel (``flash_attention``) where the
# multi-head kernel's VMEM plan fails, that is where the double-buffered K
# and V rows of one batch element, 4 * T * H * d * itemsize bytes, pass its
# 15 MiB budget (``_mh_plan``, ``_MH_VMEM_BUDGET_BYTES``); every flat shape
# of the ported tiers also fits the flat kernel's plan (``_fits_vmem``).
# The rule mirrors that choice and was not re-tuned for this card.
_FLAT_ROUTE_BYTES = 15 * 2 ** 20


def takes_flat_kernel(t: int, h: int, d: int, dtype: torch.dtype) -> bool:
    """Whether ``sdpa`` runs K1c / K2c (the flat layout) at this shape; K1 /
    K2 otherwise.  Of the ported tiers only Stable Diffusion's f32 64x64
    level (T=4096, 8 heads of d=40) takes it."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 4 * t * h * d * itemsize > _FLAT_ROUTE_BYTES


def reference_sdpa(q, k, v, scale):
    """Plain attention at any head dim: f32 logits and softmax, the weights
    cast to the storage dtype before the second product.  Returns (out [B,
    T, H, d], lse [B, H, T] f32)."""
    logits = scale * torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    lse = torch.logsumexp(logits, dim=-1)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)
    return out, lse


def _check(q, k, v, ndim):
    """q, k, v of one shape ([B, T, H, d] for ndim 4, [B, T, d] for 3), one
    dtype and one device, at a head dim and grid the kernels take."""
    if not (q.shape == k.shape == v.shape) or q.dim() != ndim:
        layout = "[B, T, H, d]" if ndim == 4 else "[B, T, d]"
        raise ValueError(f"q, k, v must share one {layout} shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    d = q.shape[-1]
    if not supports_head_dim(d):
        raise ValueError(f"head dim {d} not supported; the kernels take a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}")
    grid = (q.shape[0], q.shape[2]) if ndim == 4 else (q.shape[0],)
    if max(grid) > _MAX_GRID_YZ:
        raise ValueError(f"batch or heads {grid} exceed the kernel's grid")


def _launch_fwd(what, out, lse, q, k, v, scale, dims):
    route = fwd_route(q, k, v)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _FWD_ENTRIES[route.kernel, q.dim()])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), *dims,
            *q.stride(), *k.stride(), *v.stride(), float(scale), _DTYPE_CODES[q.dtype],
            route.padded_d, _LOAD_CODES["qkv_span" if route.span else route.load],
            route.block_q, route.block_k, stream)
    _build.check(lib, err, what)


def flash_attention_mh(q, k, v, scale):
    """Multi-head attention forward.  Returns (out [B, T, H, d] in the input
    dtype, lse [B, H, T] f32).  Kernel K1 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if q.device.type == "cpu":
        return reference_sdpa(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v, 4)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch_fwd("flash attention forward", out, lse, q, k, v, scale, (b, t, h, d))
    flash_attention_mh.launches += 1
    return out, lse


flash_attention_mh.launches = 0  # kernel launches since the last reset


def reference_sdpa_bwd(q, k, v, out, lse, do, scale):
    """Plain attention backward from the forward's saved tensors, the math of
    kernel K2: delta = rowsum(dO * out), then ``reference_sdpa_bwd_dq`` and
    ``reference_sdpa_bwd_dkv``.  Returns (dq, dk, dv) [B, T, H, d] in the
    input dtype."""
    do = do.to(q.dtype)
    delta = _delta(out, do)
    return (reference_sdpa_bwd_dq(q, k, v, do, lse, delta, scale),
            *reference_sdpa_bwd_dkv(q, k, v, do, lse, delta, scale))


def _scores_grad(q, k, v, do, lse, delta, scale):
    """P = exp(scale q.k - lse) and dS = P * (dO.v - delta), both [B, H, Tq, Tk]
    in f32 and rounded to the storage dtype (as K2 rounds them before their
    products)."""
    dt = q.dtype
    p = torch.exp(scale * torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                  - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    return p.to(dt).float(), ds.to(dt).float()


def reference_sdpa_bwd_dq(q, k, v, do, lse, delta, scale):
    """Plain version of K2's dQ kernel: dq = scale * dS.k."""
    _, ds = _scores_grad(q, k, v, do, lse, delta, scale)
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())).to(q.dtype)


def reference_sdpa_bwd_dkv(q, k, v, do, lse, delta, scale):
    """Plain version of K2's dK/dV kernel: dk = scale * dS^T.q, dv = P^T.dO."""
    p, ds = _scores_grad(q, k, v, do, lse, delta, scale)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def _delta(out, do):
    """rowsum(dO * out) in f32, [B, H, T] contiguous."""
    return torch.einsum("bthd,bthd->bht", do.float(), out.float()).contiguous()


def _bwd_launch(what, outs, q, k, v, do, lse, delta, scale, route=None):
    """Checks the inputs of a K2 kernel ([B, T, H, d], lse and delta [B, H,
    T]) or a K2c kernel ([B, T, d], lse and delta [B, T]) and launches the
    kernel of ``bwd_route`` (or of ``route``, which the card tests force)
    into ``outs`` (dq: the dQ kernel; dk, dv: the dK/dV kernel); returns
    whether it launched (not for an empty batch)."""
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v, q.dim())
    stats = (q.shape[0], q.shape[2], q.shape[1]) if q.dim() == 4 else q.shape[:2]
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != stats or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 {tuple(stats)}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if not (do.device == lse.device == delta.device == q.device):
        raise ValueError("the backward's tensors lie on different devices")
    if not outs[0].numel():
        return False
    route = route or bwd_route(q, k, v, do)
    entry = _BWD_ENTRIES[route.kernel, q.dim()][len(outs) - 1]
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(o.data_ptr() for o in outs), *q.shape, *q.stride(),
            *k.stride(), *v.stride(), *do.stride(), float(scale), _DTYPE_CODES[q.dtype],
            route.padded_d, _LOAD_CODES[route.load], route.block_rows, route.tile_rows, stream)
    _build.check(lib, err, what)
    return True


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale):
    """dq [B, T, H, d] from q, k, v and dO ([B, T, H, d], strided, one
    dtype), the forward's lse and delta ([B, H, T] f32, contiguous).
    Kernel K2's dQ kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if q.device.type == "cpu":
        return reference_sdpa_bwd_dq(q, k, v, do, lse, delta, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _bwd_launch("flash attention backward (dQ)", (dq,),
                   q, k, v, do, lse, delta, scale):
        _count(flash_attention_bwd_dq, q)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale):
    """(dk, dv) [B, T, H, d]; inputs as ``flash_attention_bwd_dq``.  Kernel
    K2's dK/dV kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return reference_sdpa_bwd_dkv(q, k, v, do, lse, delta, scale)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _bwd_launch("flash attention backward (dK/dV)", (dk, dv),
                   q, k, v, do, lse, delta, scale):
        _count(flash_attention_bwd_dkv, q)
    return dk, dv


def _count(wrapper, q):
    """One launch of a K2 kernel, in all and under its (T, H)."""
    wrapper.launches += 1
    key = (q.shape[1], q.shape[2])
    wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


# kernel launches since the last reset, in all and by (T, H)
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_shape = {}
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_shape = {}


def flash_attention_mh_bwd(q, k, v, out, lse, do, scale):
    """Multi-head attention backward from the forward's (out, lse) and the
    output cotangent dO: delta in plain PyTorch, then K2's dQ and dK/dV
    kernels (their plain versions on a CPU tensor).  Returns (dq, dk, dv) in
    the input dtype."""
    do = do.to(q.dtype)
    delta = _delta(out, do)
    return (flash_attention_bwd_dq(q, k, v, do, lse, delta, scale),
            *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))


# ---------------------------------------------------------------------------
# The flat layout: K1c and K2c
# ---------------------------------------------------------------------------


def _heads(*xs):
    """[B, T, d] -> [B, T, 1, d] views, the plain multi-head versions' layout."""
    return [x[:, :, None] for x in xs]


def reference_flash_attention(q, k, v, scale):
    """Plain version of K1c: ``reference_sdpa`` on the flat layout.  q, k, v
    [B, T, d]; returns (out [B, T, d], lse [B, T] f32)."""
    out, lse = reference_sdpa(*_heads(q, k, v), scale)
    return out[:, :, 0], lse[:, 0]


def reference_flash_attention_bwd_dq(q, k, v, do, lse, delta, scale):
    """Plain version of K2c's dQ kernel, on the flat layout."""
    return reference_sdpa_bwd_dq(*_heads(q, k, v, do), lse[:, None], delta[:, None],
                                 scale)[:, :, 0]


def reference_flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale):
    """Plain version of K2c's dK/dV kernel, on the flat layout."""
    dk, dv = reference_sdpa_bwd_dkv(*_heads(q, k, v, do), lse[:, None], delta[:, None], scale)
    return dk[:, :, 0], dv[:, :, 0]


def _delta_flat(out, do):
    """rowsum(dO * out) in f32, [B, T] contiguous."""
    return torch.einsum("btd,btd->bt", do.float(), out.float()).contiguous()


def reference_flash_attention_bwd(q, k, v, out, lse, do, scale):
    """Plain version of the flat backward (delta, then K2c's two kernels'
    plain versions).  Returns (dq, dk, dv) [B, T, d] in the input dtype."""
    do = do.to(q.dtype)
    delta = _delta_flat(out, do)
    return (reference_flash_attention_bwd_dq(q, k, v, do, lse, delta, scale),
            *reference_flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))


def flash_attention(q, k, v, scale):
    """Attention forward on the flat layout, q, k, v [B, T, d] (B folds
    batch * heads; strided).  Returns (out [B, T, d] in the input dtype, lse
    [B, T] f32).  Kernel K1c on a CUDA tensor, the plain version on a CPU
    tensor."""
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v, 3)
    b, t, d = q.shape
    out = torch.empty((b, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch_fwd("flat flash attention forward", out, lse, q, k, v, scale, (b, t, d))
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0  # kernel launches since the last reset


def flash_attention_flat_bwd_dq(q, k, v, do, lse, delta, scale):
    """dq [B, T, d] from q, k, v and dO ([B, T, d], strided, one dtype), the
    forward's lse and delta ([B, T] f32, contiguous).  Kernel K2c's dQ kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return reference_flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _bwd_launch("flat flash attention backward (dQ)", (dq,),
                   q, k, v, do, lse, delta, scale):
        flash_attention_flat_bwd_dq.launches += 1
    return dq


def flash_attention_flat_bwd_dkv(q, k, v, do, lse, delta, scale):
    """(dk, dv) [B, T, d]; inputs as ``flash_attention_flat_bwd_dq``.  Kernel
    K2c's dK/dV kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return reference_flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _bwd_launch("flat flash attention backward (dK/dV)",
                   (dk, dv), q, k, v, do, lse, delta, scale):
        flash_attention_flat_bwd_dkv.launches += 1
    return dk, dv


flash_attention_flat_bwd_dq.launches = 0  # kernel launches since the last reset
flash_attention_flat_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, scale):
    """Flat attention backward (the JAX ``_flash_bwd``) from the forward's
    (out, lse) and dO: delta in plain PyTorch, then K2c's dQ and dK/dV
    kernels (their plain versions on a CPU tensor).  Returns (dq, dk, dv)
    [B, T, d] in the input dtype."""
    do = do.to(q.dtype)
    delta = _delta_flat(out, do)
    return (flash_attention_flat_bwd_dq(q, k, v, do, lse, delta, scale),
            *flash_attention_flat_bwd_dkv(q, k, v, do, lse, delta, scale))


def _recorded_backward(plain, kernels: str, ctx, q, k, v, do):
    """The backward of a call that autograd records for a second
    differentiation (``create_graph``).  On a CPU tensor: the plain
    forward's own VJP, recomputed from the saved q, k and v, whose result is
    differentiable in every input (the saved lse is a constant to autograd,
    so the plain backward pieces would drop its dependence on q and k).  On
    the card it raises: the kernels' backward is not differentiable."""
    if q.device.type != "cpu":
        raise RuntimeError(
            f"a second-order gradient through attention kernel {kernels}: the kernels' "
            f"backward is not differentiable, so the result would silently lack the "
            f"second-order term; the JAX package has no second-order path through its Pallas "
            f"attention either (jax.grad of a jax.grad through it raises)")
    need = ctx.needs_input_grad[:3]
    with torch.enable_grad():
        out = plain(q, k, v, ctx.scale)[0]
        got = iter(torch.autograd.grad(out, [t for t, n in zip((q, k, v), need) if n],
                                       do.to(out.dtype), create_graph=True))
    return (*(next(got) if n else None for n in need), None)


class _FlashAttentionMH(torch.autograd.Function):
    """K1 forward, K2 backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_mh(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if torch.is_grad_enabled():
            return _recorded_backward(reference_sdpa, "K2 (flash_attention_bwd_dq / "
                                      "flash_attention_bwd_dkv)", ctx, q, k, v, do)
        return (*flash_attention_mh_bwd(q, k, v, out, lse, do, ctx.scale), None)


class _FlashAttention(torch.autograd.Function):
    """K1c forward, K2c backward on the flat layout (the plain versions on
    the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if torch.is_grad_enabled():
            return _recorded_backward(reference_flash_attention, "K2c (flash_attention_flat_"
                                      "bwd_dq / flash_attention_flat_bwd_dkv)", ctx, q, k, v, do)
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.scale), None)


def sdpa(q, k, v, scale=None):
    """Scaled-dot-product attention on [B, T, H, d]; returns [B, T, H, d].
    Where ``ops.ring_attention.set_sp_context`` has installed a layout, the
    ring over its seq group comes first (``sp_sdpa``, which declines the
    shapes its gates refuse, as the JAX ``sdpa`` checks its SP context
    first).  Otherwise, on the card every call goes through a kernel,
    whatever T: K1c forward and K2c backward on [B * H, T, d] copies where
    ``takes_flat_kernel`` holds (as the JAX ``sdpa`` transposes for its flat
    kernel), K1 and K2 on the views as they are elsewhere."""
    b, t, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    from . import ring_attention

    out = ring_attention.sp_sdpa(q, k, v, float(scale))
    if out is not None:
        return out
    if takes_flat_kernel(t, h, d, q.dtype):
        def flat(x):
            return x.transpose(1, 2).reshape(b * h, t, d)

        out = _FlashAttention.apply(flat(q), flat(k), flat(v), scale)
        return out.reshape(b, h, t, d).transpose(1, 2)
    return _FlashAttentionMH.apply(q, k, v, scale)
