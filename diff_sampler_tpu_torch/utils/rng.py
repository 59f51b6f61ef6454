"""Per-seed deterministic RNG.

Counterpart of ``diff_sampler_tpu/utils/rng.py``: image i must be a pure
function of seed i, whatever the batch size or split.  Each seed gets its own
``torch.Generator`` on the target device, as the reference's
``StackedRandomGenerator`` does (one generator per sample).  The numbers are
PyTorch's, not JAX's threefry bits: tests feed both packages the same
latents instead.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["stacked_randn", "stacked_randint"]

# Offset that decorrelates the label stream from the latent stream of the
# same seed (the JAX package folds in a 1 for the same purpose).
_RANDINT_STREAM = 1 << 32


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def stacked_randn(seeds: Sequence[int], shape: Sequence[int], dtype=torch.float32,
                  device="cuda") -> torch.Tensor:
    """[len(seeds), *shape] standard normals; row i depends only on seeds[i]
    (and the device's generator)."""
    rows = [torch.randn(tuple(shape), generator=_generator(s, device), device=device)
            for s in seeds]
    return torch.stack(rows).to(dtype)


def stacked_randint(seeds: Sequence[int], shape: Sequence[int], low: int, high: int,
                    device="cuda") -> torch.Tensor:
    """[len(seeds), *shape] uniform ints in [low, high); row i depends only on
    seeds[i], from a stream independent of ``stacked_randn``'s."""
    rows = [torch.randint(low, high, tuple(shape),
                          generator=_generator(_RANDINT_STREAM + int(s), device),
                          device=device)
            for s in seeds]
    return torch.stack(rows)
