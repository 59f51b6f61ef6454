"""Operators of the port: attention (kernels K1 / K2 and, on the flat
layout, K1c / K2c, and their plain versions), GroupNorm (K3), the direct
3x3 conv (K4), trajectory geometry, and the host-side numpy noise schedules
and multistep coefficients (the port's own copies of the JAX package's)."""

from . import multistep, schedules
from .schedules import get_schedule

__all__ = ["get_schedule", "multistep", "schedules"]
