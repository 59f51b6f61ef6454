"""GroupNorm (+ affine) (+ SiLU) over NHWC.

Counterpart of ``diff_sampler_tpu/ops/pallas_groupnorm.py::_jnp_gn``, the
path the JAX package runs by default (outside Pallas): f32 statistics in one
sum / sum-of-squares pass, the variance clamped at 0, the per-(sample,
channel) affine folded into one multiply-add, optional SiLU, and the result
cast back to the input dtype.  Plain PyTorch, as the JAX path is plain XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["groupnorm_silu"]


def groupnorm_silu(x, scale, bias, *, groups: int, eps: float = 1e-5,
                   apply_silu: bool = True):
    """x: [N, H, W, C]; scale, bias: [C]."""
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
