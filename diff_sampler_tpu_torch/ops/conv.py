"""Direct 3x3 conv (stride 1, SAME, NHWC) with an optional fused
GroupNorm-affine + SiLU prologue: the plain version and the wrapper of
kernel K4.

Counterpart of ``diff_sampler_tpu/ops/pallas_conv.py`` and its entry points
``conv3x3``, ``gn_silu_conv3x3`` and ``supported``, with the JAX layouts: x
[N, H, W, Cin] in bf16 or f32, w [3, 3, Cin, Cout], a and b [N, Cin] (the
per-(sample, channel) fold of GroupNorm statistics and affine), out [N, H,
W, Cout] in x's dtype.  The rounding order is the JAX kernel's: the prologue
``silu(x * a + b)`` in f32, rounded to x's dtype; w cast to x's dtype;
products summed in f32; the f32 bias added; the result cast to x's dtype.
The SAME padding is zero after the prologue, not ``silu(b)``.

``reference_conv3x3`` is the plain version: 9 shifted f32 matmuls in that
rounding order, no cuDNN.  ``conv3x3`` and ``gn_silu_conv3x3`` take it for a
tensor on the CPU; on a CUDA tensor they launch K4 (``csrc/conv3x3.cu``) or
raise.  K4 is forward only, as the JAX kernel is (it has no VJP): it raises
on an input that requires grad while autograd records.

K4 is wgmma on a TMA-loaded halo tile: each output tile is a patch of one
image by 128 output channels (bf16) or 64 (f32), and each chunk of its halo
(64 bf16 or 32 f32 channels, one 128-byte row a pixel) is loaded once, has
the fused prologue applied once per pixel, and feeds all 9 taps.
``conv_plan`` is the pure-Python mirror of that tiling (the patch, the TMA
boxes, the stages, the shared memory), which the wrapper hands to the C
entry and the CPU tests check.  f32 runs in 3xTF32: x and w are each split
into TF32 hi and lo (``split_tf32``, cvt.rna), and each product is summed as
lo hi + hi lo + hi hi.  The wrapper splits w on the card with
``split_w`` (one more launch a call), A is split in registers.

No model of the JAX package calls this kernel (XLA's conv beat it on the
TPU, so its U-Nets keep ``lax.conv``); the port's U-Nets likewise keep
``F.conv2d``, and these entry points are the only way into K4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["ConvPlan", "conv3x3", "conv_plan", "gn_silu_conv3x3", "reference_conv3x3",
           "split_tf32", "split_w", "supported"]



def supported(n, h, w, cin, cout) -> bool:
    """K4's rule: Cin and Cout multiples of 8 (one 16-byte vector holds 8
    bf16 channels), N, H, W >= 1.  It takes every shape the JAX kernel's
    ``supported`` takes (channels multiples of 128)."""
    return (min(n, h, w) >= 1 and cin >= 8 and cout >= 8
            and cin % 8 == 0 and cout % 8 == 0)


# The kernels' constants (csrc/conv3x3.cu): bf16, and the f32 kernel's where
# they differ (*32)
CONV_M = 256          # output pixels per tile: two consumer warpgroups x 128
CONV_N = 128          # output channels per tile
CONV_K = 64           # input channels per chunk: one 128-byte row of a halo pixel
HALO_MAX = 352        # halo pixels a stage holds
HALO_STAGES = 3
B_STAGES = 5
MAX_BOX = 256         # TMA box dimension limit
MAX_TILE_W = 32       # widest patch
EPI_BYTES = 8 * 16 * 32 * 2  # epilogue staging: 16 x 32 bf16 per consumer warp
CONV_N32 = 64         # f32: output channels per tile
CONV_K32 = 32         # f32: input channels per chunk, again one 128-byte row
B_STAGES32 = 5        # f32: a stage holds the tiles of w_hi and w_lo
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on the H100


class ConvPlan(NamedTuple):
    """The kernel's tiling of one call."""
    tile_h: int       # patch rows
    tile_w: int       # patch columns
    tiles_y: int      # patches down an image
    tiles_x: int      # patches across an image
    co_tiles: int     # output-channel tiles
    tiles: int        # output tiles of the call
    chunks: int       # 64-channel chunks of Cin
    halo_box: tuple   # TMA box over x [N, H, W, Cin], innermost first
    w_box: tuple      # TMA box over w as [3 * 3, Cout, Cin], innermost first
    smem: int         # dynamic shared memory of a block
    tile_n: int       # output channels per tile
    chunk: int        # input channels per chunk


def conv_plan(n, h, w, cin, cout, dtype=torch.bfloat16) -> ConvPlan:
    """The patch of one output tile: whole rows up to 32 columns (wider
    images are cut into 32-column patches), as many rows as 256 pixels and a
    halo stage of 352 pixels allow, at most the image's; in ``dtype``'s
    output-channel tile and chunk."""
    tile_w = min(w, MAX_TILE_W)
    tile_h = max(1, min(h, CONV_M // tile_w, HALO_MAX // (tile_w + 2) - 2))
    tiles_y, tiles_x = -(-h // tile_h), -(-w // tile_w)
    f32 = dtype == torch.float32
    tile_n, chunk, b_stages = ((CONV_N32, CONV_K32, B_STAGES32) if f32
                               else (CONV_N, CONV_K, B_STAGES))
    co_tiles = -(-cout // tile_n)
    # a halo pixel and a row of a w tile are 128 bytes; f32 stages w_hi and
    # w_lo and stores its outputs with no staging
    smem = 1024 + HALO_STAGES * HALO_MAX * 128 + b_stages * (2 if f32 else 1) * tile_n * 128
    smem += 8 * (3 * HALO_STAGES + 2 * b_stages) + (0 if f32 else EPI_BYTES)
    return ConvPlan(tile_h, tile_w, tiles_y, tiles_x, co_tiles, n * tiles_y * tiles_x * co_tiles,
                    -(-cin // chunk), (chunk, tile_w + 2, tile_h + 2, 1), (chunk, tile_n, 1),
                    smem, tile_n, chunk)


def split_tf32(t: torch.Tensor) -> tuple:
    """(hi, lo) of an f32 tensor as the kernels split it
    (``csrc/mma.cuh::split_tf32``): hi is t rounded to TF32's 10-bit
    mantissa, to nearest with ties away from zero (cvt.rna.tf32.f32), and lo
    the same rounding of t - hi (exact in f32).  In int32 bit operations:
    adding half a TF32 step to the magnitude bits carries into the exponent
    where it must; inf and nan pass as they are.  The plain version of the
    split kernel."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        rounded = (bits + 0x1000) & -0x2000
        finite = (bits & 0x7F800000) != 0x7F800000
        return torch.where(finite, rounded, bits).view(torch.float32)

    t = t.float()
    hi = rna(t)
    return hi, rna(t - hi)


def split_w(w: torch.Tensor) -> tuple:
    """(w_hi, w_lo), each [3, 3, Cout, Cin], of an f32 w [3, 3, Cin, Cout]:
    the TF32 split (``split_tf32``) of w transposed, as the f32 K4 takes it.
    The split kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.dtype != torch.float32:
        raise ValueError(f"w must be a float32 [3, 3, Cin, Cout], got {tuple(w.shape)} {w.dtype}")
    cin, cout = w.shape[2:]
    if w.device.type == "cpu":
        return split_tf32(w.transpose(2, 3))
    w = _aligned(w)
    out = torch.empty(2, 3, 3, cout, cin, dtype=torch.float32, device=w.device)
    lib = _build.load_library()
    with torch.cuda.device(w.device):
        err = lib.dst_conv3x3_split_w(w.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), cin,
                                      cout, torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(lib, err, "split_w")
    split_w.launches += 1
    return out[0], out[1]


def reference_conv3x3(x, w, bias=None, a=None, b=None):
    """The plain version: ``conv3x3(x, w, bias)``, or with ``a`` and ``b``
    ``gn_silu_conv3x3(x, a, b, w, bias)``."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    z = x
    if a is not None:
        z = F.silu(x.float() * a.float()[:, None, None, :] + b.float()[:, None, None, :])
        z = z.to(x.dtype)
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))  # zeros around the prologue's output
    wf = w.to(x.dtype).float()
    acc = torch.zeros(n * h * wd, cout, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += zp[:, dy:dy + h, dx:dx + wd, :].float().reshape(-1, cin) @ wf[dy, dx]
    if bias is not None:
        acc += bias.float()
    return acc.reshape(n, h, wd, cout).to(x.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (K4 loads 16 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w, bias, a, b):
    """K4 on CUDA tensors; returns out, [N, H, W, Cout] in x's dtype."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be a float32 or bfloat16 [N, H, W, Cin], got "
                        f"{tuple(x.shape)} {x.dtype}")
    n, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be [3, 3, {cin}, Cout], got {tuple(w.shape)}")
    cout = w.shape[-1]
    if not supported(n, h, wd, cin, cout):
        raise ValueError(f"K4 takes Cin and Cout multiples of 8 and N, H, W >= 1, got "
                         f"x {tuple(x.shape)}, Cout {cout}")
    fuse = a is not None
    tensors = [x, w] + [t for t in (bias, a, b) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("K4 is forward only (the JAX kernel has no VJP): call it under "
                           "torch.no_grad() or on tensors that do not require grad")
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w, bias, a and b lie on different devices")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be [{cout}], got {tuple(bias.shape)}")
    if fuse and (tuple(a.shape) != (n, cin) or tuple(b.shape) != (n, cin)):
        raise ValueError(f"a and b must be [{n}, {cin}], got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bias = _aligned(bias.float() if bias is not None
                    else torch.zeros(cout, dtype=torch.float32, device=x.device))
    if fuse:
        a, b = _aligned(a.float()), _aligned(b.float())
    x = _aligned(x)
    out = torch.empty(n, h, wd, cout, dtype=x.dtype, device=x.device)
    ab = (a.data_ptr() if fuse else None, b.data_ptr() if fuse else None)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        plan = conv_plan(n, h, wd, cin, cout, x.dtype)
        if x.dtype == torch.bfloat16:
            # K-major B for wgmma: w as [3, 3, Cout, Cin]
            wt = _aligned(w.to(x.dtype).permute(0, 1, 3, 2))
            err = lib.dst_conv3x3_bf16(x.data_ptr(), *ab, wt.data_ptr(), bias.data_ptr(),
                                       out.data_ptr(), n, h, wd, cin, cout, int(fuse),
                                       plan.tile_h, plan.tile_w, stream)
        else:
            w_hi, w_lo = split_w(w.float())
            err = lib.dst_conv3x3_f32(x.data_ptr(), *ab, w_hi.data_ptr(), w_lo.data_ptr(),
                                      bias.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
                                      int(fuse), plan.tile_h, plan.tile_w, stream)
    _build.check(lib, err, "conv3x3")
    conv3x3.launches += 1
    return out


def conv3x3(x, w, bias=None):
    """Direct 3x3 SAME conv: x [N, H, W, Cin] (bf16 / f32), w [3, 3, Cin,
    Cout], bias [Cout] or None.  K4 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return reference_conv3x3(x, w, bias)
    return _launch(x, w, bias, None, None)


def gn_silu_conv3x3(x, a, b, w, bias=None):
    """``conv3x3(silu(x * a + b), w, bias)`` with a, b [N, Cin] the
    per-(sample, channel) fold of GroupNorm: a = rsqrt(var + eps) * scale,
    b = bias_gn - mean * a.  K4 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return reference_conv3x3(x, w, bias, a, b)
    return _launch(x, w, bias, a, b)


conv3x3.launches = 0  # K4 launches through either entry point since the last reset
split_w.launches = 0  # split-kernel launches (one per f32 K4 call) since the last reset
