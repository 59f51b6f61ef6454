"""The port's parameter EMA (``utils/ema.py``) against the JAX package's.

500 updates of a small parameter set (a dict of three tensors) towards parameters that drift by seeded numpy noise each step,
through ``ema_update`` on both sides.  The port computes JAX's formula
``e - (1 - d) * (e - p)`` with d in f32, one rounding per operation, so the
averages and the count must be bit-equal to the JAX function run op by op.
Under ``jax.jit`` XLA's CPU backend contracts the product and the
subtraction into one fused multiply-add (one rounding fewer), which moves
a few elements by an ulp a step: that run is held at 2 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.utils.ema import ema_init as jax_ema_init
from diff_sampler_tpu.utils.ema import ema_update as jax_ema_update
from diff_sampler_tpu_torch.utils.ema import EmaState, ema_init, ema_update

SHAPES = {"conv.weight": (8, 4, 3, 3), "conv.bias": (8,), "norm.weight": (16,)}


def _drift(steps: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    p = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    out = []
    for _ in range(steps):
        p = {k: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32) for k, v in p.items()}
        out.append(p)
    return out


@pytest.mark.parametrize("decay", [0.9999, 0.9])
def test_ema_update_matches_jax_bit_for_bit_over_500_steps(decay):
    """decay 0.9999 stays in the warm-up (d = (1 + n) / (10 + n)) for all
    500 steps; decay 0.9 leaves it at n = 80."""
    steps = _drift(501)
    j_state = jax_ema_init({k: jnp.asarray(v) for k, v in steps[0].items()})
    t_state = ema_init({k: torch.from_numpy(v) for k, v in steps[0].items()})
    jit_state = j_state
    jit_update = jax.jit(lambda s, p: jax_ema_update(s, p, decay))
    for p in steps[1:]:
        j_params = {k: jnp.asarray(v) for k, v in p.items()}
        j_state = jax_ema_update(j_state, j_params, decay)
        jit_state = jit_update(jit_state, j_params)
        t_state = ema_update(t_state, {k: torch.from_numpy(v) for k, v in p.items()}, decay)
    assert int(t_state.count) == int(j_state.count) == int(jit_state.count) == 500
    assert t_state.count.dtype == torch.int32
    for k in SHAPES:
        got = t_state.params[k].numpy()
        np.testing.assert_array_equal(got, np.asarray(j_state.params[k]))
        want = np.asarray(jit_state.params[k])
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.abs(want)).max())


def test_state_updates_in_place_and_leaves_params_alone():
    steps = _drift(3, seed=1)
    tensors = {k: torch.from_numpy(v) for k, v in steps[0].items()}
    state = ema_init(tensors)
    assert isinstance(state, EmaState) and int(state.count) == 0
    assert all(state.params[k] is not v and torch.equal(state.params[k], v)
               for k, v in tensors.items())
    avg = dict(state.params)
    new = {k: torch.from_numpy(v) for k, v in steps[1].items()}
    before = {k: v.clone() for k, v in new.items()}
    state = ema_update(state, new)
    assert all(state.params[k] is avg[k] for k in avg)  # updated in place
    assert all(torch.equal(new[k], before[k]) for k in new)
    # n = 1: d = 2 / 11, so e moves 9 / 11 of the way to p
    d = np.float32(2.0) / np.float32(11.0)
    for k, e in state.params.items():
        p0, p1 = tensors[k].numpy(), new[k].numpy()
        np.testing.assert_allclose(e.numpy(), p0 - (np.float32(1.0) - d) * (p0 - p1), rtol=0,
                                   atol=1e-6)
