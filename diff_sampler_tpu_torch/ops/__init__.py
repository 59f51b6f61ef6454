"""Operators of the port.  The noise schedules and multistep coefficients are
host-side numpy, shared with the JAX package (its ``ops`` package imports no
jax)."""

from diff_sampler_tpu.ops import get_schedule, multistep, schedules

__all__ = ["get_schedule", "multistep", "schedules"]
