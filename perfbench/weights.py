"""Weights from a run's seed, drawn on the device in one call.

Every parameter of the reference model is drawn at unit scale: a standard
normal over the square root of its fan-in (its first axis's slice; 1 for a
vector), the rule of ``chip_smoke.py::_redraw_unit_scale``.  A random EDM
net's zero-initialised output convs would otherwise give D = c_skip x and
hide every fault of the net.  The draw is one ``torch.randn`` over the sum of
the sizes on the device's generator, cut into views, so the same seed gives
the same weights on any run and the reference can draw them again after the
program's state is freed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .core import stream_seed


def draw(names: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the shapes of ``names`` (any device, e.g. meta),
    drawn on ``device`` from stream 1 of ``seed``."""
    total = sum(p.numel() for p in names.values())
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, p in names.items():
        n = p.numel()
        fan_in = p[0].numel() if p.dim() > 1 else 1
        out[name] = flat[off:off + n].view(p.shape).mul_(1.0 / math.sqrt(fan_in))
        off += n
    return out
