"""What the drivers share: the seeds' latents, and the benchmark's spans in a
traced window."""

from __future__ import annotations

import contextlib

import torch


def latents(seeds, shape, device):
    """Each seed's latents as the system's ``stacked_randn`` defines them: a
    standard normal of ``shape`` from a generator of that seed on the
    device (the CLIs' image-i-from-seed-i rule, worked out again)."""
    return torch.stack([torch.randn(tuple(shape), device=device,
                                    generator=torch.Generator(device=device).manual_seed(int(s)))
                        for s in seeds])


def span(traced: bool, name: str):
    """A span of the benchmark's own in the profiler's trace, where traced."""
    return torch.profiler.record_function(name) if traced else contextlib.nullcontext()
