"""The plain operations of the reference models, and the count of their work.

Every convolution, linear layer, attention and GroupNorm of the reference
models goes through one function here.  Each computes its result in plain
PyTorch and, inside ``counting()``, adds the operation's arithmetic and the
bytes it must move (each input read once, each output written once) to the
active ``Work``, under the op class of the program's kernels that do that work
on the card:

- ``attention``: the self-attention of the U-Nets, which the program runs in
  its flash-attention kernels;
- ``groupnorm``: every GroupNorm, which the program runs in its GroupNorm
  kernel;
- ``conv_gemm``: convolutions, linear layers, and the attention that the
  program computes as plain matrix products (SD's cross-attention over the
  77 context tokens, the KL decoder's single-head attention), all of which
  run as cuDNN / cuBLAS kernels.

Run on the ``meta`` device, a forward costs nothing and gives the work of one
call at its exact shapes; ``perfbench/work.py`` does so.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict

import torch
import torch.nn.functional as F

CLASSES = ("attention", "groupnorm", "conv_gemm")


class Work:
    """Operations (2 per multiply-add) and bytes of a run of reference code,
    per op class, and each op's least time summed per class."""

    def __init__(self):
        self.flops: Dict[str, float] = {c: 0.0 for c in CLASSES}
        self.bytes: Dict[str, float] = {c: 0.0 for c in CLASSES}
        self.ops: Dict[str, list] = {c: [] for c in CLASSES}

    def add(self, cls: str, flops: float, nbytes: float) -> None:
        self.flops[cls] += flops
        self.bytes[cls] += nbytes
        self.ops[cls].append((flops, nbytes))

    def bound_s(self, cls: str, peak_flops: float, peak_bytes: float) -> float:
        """The least time of the class's ops on a chip of these peaks: for
        each op the larger of its operations over the peak rate and its bytes
        over the memory bandwidth, summed."""
        return sum(max(f / peak_flops, b / peak_bytes) for f, b in self.ops[cls])

    def scaled(self, k: float) -> "Work":
        out = Work()
        for c in CLASSES:
            out.flops[c] = self.flops[c] * k
            out.bytes[c] = self.bytes[c] * k
            out.ops[c] = [(f * k, b * k) for f, b in self.ops[c]]
        return out

    def __iadd__(self, other: "Work") -> "Work":
        for c in CLASSES:
            self.flops[c] += other.flops[c]
            self.bytes[c] += other.bytes[c]
            self.ops[c] += other.ops[c]
        return self


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("perfbench_work", default=None)


@contextlib.contextmanager
def counting(work: Work):
    token = _ACTIVE.set(work)
    try:
        yield work
    finally:
        _ACTIVE.reset(token)


def _record(cls: str, flops: float, *tensors) -> None:
    work = _ACTIVE.get()
    if work is not None:
        work.add(cls, float(flops), float(sum(t.numel() * t.element_size() for t in tensors)))


def _as(x, *ts):
    """Weights in the activations' dtype (a lower-precision net casts its
    f32 weights per layer, as the system's do)."""
    return [None if t is None else t.to(x.dtype) for t in ts]


def conv2d(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    w, b = _as(x, w, b)
    out = F.conv2d(x, w, b, stride=stride, padding=padding, groups=groups)
    k = w.shape[1] * w.shape[2] * w.shape[3]  # inputs per output element
    _record("conv_gemm", 2 * out.numel() * k, x, w, out, *([b] if b is not None else []))
    return out


def conv_transpose2d(x, w, stride: int, padding: int, groups: int):
    w, = _as(x, w)
    out = F.conv_transpose2d(x, w, stride=stride, padding=padding, groups=groups)
    _record("conv_gemm", 2 * x.numel() * w.shape[1] * w.shape[2] * w.shape[3], x, w, out)
    return out


def linear(x, w, b=None):
    w, b = _as(x, w, b)
    out = F.linear(x, w, b)
    _record("conv_gemm", 2 * out.numel() * w.shape[1], x, w, out,
            *([b] if b is not None else []))
    return out


def group_norm(x, groups: int, w, b, eps: float):
    """In f32 statistics whatever the activations' dtype, the result cast
    back, as the system's GroupNorm computes it."""
    out = F.group_norm(x.float(), groups, w.float(), b.float(), eps).to(x.dtype)
    _record("groupnorm", 5 * x.numel(), x, out, w, b)
    return out


def softmax_attention(q, k, v, scale: float, cls: str = "attention", rows: int = 16):
    """softmax(q k^T * scale) v over [N, T, d] q and [N, S, d] k, v, with the
    softmax in f32, ``rows`` of N at a time so that the [rows, T, S] scores
    fit.  Recorded as 4 N T S d operations, q, k, v read and out written."""
    n, t, d = q.shape
    s = k.shape[1]
    outs = []
    for i in range(0, n, rows):
        logits = torch.bmm(q[i:i + rows].float(), k[i:i + rows].float().transpose(1, 2)) * scale
        outs.append(torch.bmm(torch.softmax(logits, dim=-1).to(v.dtype), v[i:i + rows]))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    _record(cls, 4 * n * t * s * d, q, k, v, out)
    return out


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """guided-diffusion's [cos | sin] embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
