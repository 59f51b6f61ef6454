"""Operators of the port: attention (kernels K1 and K2 and their plain
versions), GroupNorm, and the host-side numpy noise schedules and
multistep coefficients (the port's own copies of the JAX package's)."""

from . import multistep, schedules
from .schedules import get_schedule

__all__ = ["get_schedule", "multistep", "schedules"]
