"""The work of one call, counted from the reference model at its shapes.

The reference runs on the ``meta`` device under ``reference.ops.counting``:
no arithmetic happens, and every convolution, linear layer, attention and
GroupNorm adds its operations and bytes to a ``Work``.  The program does
the same arithmetic at the same shapes, so this is the algorithm's work of
the call, counted once: no recompute, and one product for each f32 product
whatever the kernels split it into.
"""

from __future__ import annotations

import torch

from .reference.ops import Work, counting


def call_work(fn, *shapes) -> Work:
    """The Work of ``fn`` on zero-cost ``meta`` tensors of ``shapes``."""
    work = Work()
    args = [torch.empty(s, device="meta") for s in shapes]
    with counting(work), torch.no_grad():
        fn(*args)
    return work
