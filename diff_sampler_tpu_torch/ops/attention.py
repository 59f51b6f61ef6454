"""Scaled-dot-product attention: the plain version and kernel K1's wrapper.

``flash_attention_mh`` is the wrapper of the hand-written CUDA kernel in
``csrc/flash_attn_fwd.cu``, which replaces
``diff_sampler_tpu/ops/pallas_attention.py::_attn_kernel_mh``.  On a CUDA
tensor it launches that kernel or raises; only a tensor on the CPU takes the
plain ``reference_sdpa``.  At the CIFAR-10 shapes (H=1, d=256, T=256) the
kernel is bound by its f32 multiply-adds on the CUDA cores, not by device
memory: it reads q, k and v once per query tile and never writes the
[T, T] logits, which the plain version materialises in f32.

Layout: q, k, v are [B, T, H, d] (the token layout of the U-Nets); they may
be strided views, such as the interleaved split of the qkv projection.
"""

from __future__ import annotations

import math

import torch

from .. import _build

__all__ = ["HEAD_DIMS", "flash_attention_mh", "reference_sdpa", "sdpa"]

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_sdpa(q, k, v, scale):
    """Plain attention: f32 logits and softmax, the weights cast to the
    storage dtype before the second product.  Returns (out [B, T, H, d],
    lse [B, H, T] f32)."""
    logits = scale * torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    lse = torch.logsumexp(logits, dim=-1)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)
    return out, lse


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, T, H, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the kernel's grid")


def flash_attention_mh(q, k, v, scale):
    """Multi-head attention forward.  Returns (out [B, T, H, d] in the input
    dtype, lse [B, H, T] f32).  Kernel K1 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return reference_sdpa(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dst_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, d, *q.stride(), *k.stride(), *v.stride(),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, err, "flash attention forward")
    flash_attention_mh.launches += 1
    return out, lse


flash_attention_mh.launches = 0  # kernel launches since the last reset


def sdpa(q, k, v, scale=None):
    """Scaled-dot-product attention on [B, T, H, d]; returns [B, T, H, d].
    Every CUDA call goes through kernel K1, whatever T."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return flash_attention_mh(q, k, v, scale)[0]
