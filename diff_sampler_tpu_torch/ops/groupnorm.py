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
package's ``_gn_bwd``, which has no kernel either.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["groupnorm_silu", "reference_groupnorm_silu", "stats_rows"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Blocks of K3's statistics kernel to aim for: 8 per SM of an H100's 132.
_STATS_BLOCKS = 8 * 132


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


def stats_rows(n: int, hw: int) -> int:
    """Rows (pixels) per block of K3's statistics kernel: enough blocks to
    fill the card (``_STATS_BLOCKS`` over the batch), each a multiple of the
    16 rows a thread holds in registers."""
    chunks = min(max(1, math.ceil(_STATS_BLOCKS / max(n, 1))), math.ceil(hw / 16))
    return 16 * math.ceil(math.ceil(hw / chunks) / 16)


def _launch(x, scale, bias, groups, eps, apply_silu):
    """K3 on a CUDA tensor: returns out, [N, H, W, C] in x's dtype."""
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
    rows = stats_rows(n, hw)
    chunks = math.ceil(hw / rows)
    scratch = torch.empty(2 * n * chunks * c + 2 * n * c, dtype=torch.float32,
                          device=x.device)
    vec = 16 // x.element_size()  # channels per 16-byte vector of the apply pass
    if c % vec or x.data_ptr() % 16:
        vec = 1
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dst_groupnorm_silu(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, hw, c, groups, rows, float(eps), int(bool(apply_silu)), vec,
            _DTYPE_CODES[x.dtype], stream)
    _build.check(lib, err, "GroupNorm")
    groupnorm_silu.launches += 1
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
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip((x, scale, bias), need)]
            out = reference_groupnorm_silu(*leaves, **ctx.args)
            wrt = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(out, wrt, g))
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


groupnorm_silu.launches = 0  # kernel launches (each three CUDA kernels) since the last reset
