"""Exponential moving average of parameters.

Counterpart of ``diff_sampler_tpu/utils/ema.py``, which rebuilds the LDM
codebase's ``LitEma`` (``models/ldm/modules/ema.py``): the decay is
warm-up limited to ``min(decay, (1 + count) / (10 + count))`` with the
count of updates made so far, the state is the averaged tensors and that
count.

The update is JAX's formula ``e - (1 - d) * (e - p)``, bit for bit: three
``torch._foreach_*`` passes over all the tensors at once (a difference, its
scaling by ``1 - d``, the subtraction), with ``d`` computed on the
tensors' device from the count, so no update waits for the host.  The
averages are updated in place.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch

__all__ = ["EmaState", "ema_init", "ema_update"]


class EmaState(NamedTuple):
    params: Dict[str, torch.Tensor]  # the averages, by name
    count: torch.Tensor  # 0-dim int32 on the params' device: the updates made


def ema_init(params: Mapping[str, torch.Tensor]) -> EmaState:
    """The state before the first update: detached copies of ``params`` (a
    name -> tensor mapping, e.g. ``dict(module.named_parameters())``) and a
    count of 0 on their device."""
    copies = {k: v.detach().clone() for k, v in params.items()}
    device = next(iter(copies.values())).device
    return EmaState(params=copies, count=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def ema_update(state: EmaState, params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> EmaState:
    """One update of the averages towards ``params`` (the names ``ema_init``
    was given): ``one_minus_decay = 1 - min(decay, (1 + n) / (10 + n))``
    with n the count after this update (LitEma.forward), in f32.  The
    returned state holds the same tensors, updated in place, and the new
    count."""
    count = state.count + 1
    c = count.float()
    d = torch.clamp((1.0 + c) / (10.0 + c), max=decay)
    avg = list(state.params.values())
    diff = torch._foreach_sub(avg, [params[k] for k in state.params])
    torch._foreach_mul_(diff, 1.0 - d)
    torch._foreach_sub_(avg, diff)
    return EmaState(params=state.params, count=count)
