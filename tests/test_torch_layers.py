"""The port's layers against the JAX package's, through ``params_from_jax``.

Every JAX parameter is overwritten with a seeded draw of unit scale (weights
over sqrt(fan_in)), so no layer hides behind its near-zero init.  Inputs are
numpy draws handed to both sides.  f32, max abs error <= 1e-5 (relative to
the output's scale where it exceeds 1).
"""

import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import layers as J
from diff_sampler_tpu.models.unets import UNetBlock as JUNetBlock
from diff_sampler_tpu.ops.pallas_groupnorm import _jnp_gn
from diff_sampler_tpu_torch.models import layers as T
from diff_sampler_tpu_torch.models.convert import load_jax_params
from diff_sampler_tpu_torch.models.unets import UNetBlock
from diff_sampler_tpu_torch.ops.groupnorm import groupnorm_silu

TOL = 1e-5


def _rescaled(params, seed):
    rng = np.random.RandomState(seed)

    def draw(a):
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        return (rng.randn(*a.shape) / math.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, params)


def _jax_run(module, *inputs, seed=0):
    """Init ``module``, rescale its params, apply it: (params, output)."""
    inputs = [jnp.asarray(a) for a in inputs]
    # nn.Module.init, not module.init: UNetBlock has a field named ``init``
    variables = nn.Module.init(module, jax.random.key(0), *inputs)
    params = _rescaled(variables.get("params", {}), seed)
    return params, np.asarray(module.apply({"params": params}, *inputs))


def _close(ours, ref):
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL * max(1.0, np.abs(ref).max()))


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CONV_CASES = [
    dict(kernel=3),
    dict(kernel=1),
    dict(kernel=3, up=True),
    dict(kernel=3, down=True),
    dict(kernel=3, up=True, resample_filter=(1, 3, 3, 1)),
    dict(kernel=3, down=True, resample_filter=(1, 3, 3, 1)),
    dict(kernel=1, down=True, resample_filter=(1, 3, 3, 1)),
    dict(kernel=0, up=True),
    dict(kernel=0, down=True, resample_filter=(1, 3, 3, 1)),
    dict(kernel=3, down=True, resample_filter=(1, 3, 3, 1), fused_resample=True),
    dict(kernel=3, up=True, resample_filter=(1, 3, 3, 1), fused_resample=True),
    dict(kernel=3, down=True, fused_resample=True),
]


@pytest.mark.parametrize("kw", CONV_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_conv2d(kw):
    cin, cout = 8, (8 if kw["kernel"] == 0 else 12)
    x = _x(2, 8, 8, cin)
    params, ref = _jax_run(J.Conv2d(cin, cout, **kw), x)
    conv = load_jax_params(T.Conv2d(cin, cout, **kw), params)
    _close(conv(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("c,eps", [(32, 1e-5), (64, 1e-6), (12, 1e-6)])
def test_groupnorm(c, eps):
    x = _x(2, 4, 4, c) * 3 + 1
    params, ref = _jax_run(J.GroupNorm(c, eps=eps), x)
    gn = load_jax_params(T.GroupNorm(c, eps=eps), params)
    _close(gn(torch.from_numpy(x)), ref)


def test_groupnorm_silu_matches_jnp_gn():
    x, scale, bias = _x(2, 4, 4, 32), _x(32, seed=2), _x(32, seed=3)
    ref = np.asarray(_jnp_gn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                             8, 1e-6, True))
    ours = groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias), groups=8, eps=1e-6, apply_silu=True)
    _close(ours, ref)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    x = _x(3, 16)
    params, ref = _jax_run(J.Linear(16, 24, use_bias=bias), x)
    lin = load_jax_params(T.Linear(16, 24, bias=bias), params)
    _close(lin(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("endpoint", [True, False])
def test_positional_embedding(endpoint):
    x = np.array([-3.2, 0.0, 0.7, 1.1], np.float32)
    ref = np.asarray(J.positional_embedding(jnp.asarray(x), 32, endpoint=endpoint))
    _close(T.positional_embedding(torch.from_numpy(x), 32, endpoint=endpoint), ref)


def test_fourier_embedding():
    x = np.array([-3.2, 0.0, 0.7, 1.1], np.float32)
    params, ref = _jax_run(J.FourierEmbedding(32), x)
    emb = load_jax_params(T.FourierEmbedding(32), params)
    _close(emb(torch.from_numpy(x)), ref)


BLOCK_CASES = [
    dict(cin=16, cout=16, attention=True),
    dict(cin=16, cout=32, attention=True, adaptive_scale=True),
    dict(cin=16, cout=16, down=True),
    dict(cin=32, cout=16, up=True, resample_filter=(1, 3, 3, 1)),
]


@pytest.mark.parametrize("kw", BLOCK_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unet_block(kw):
    kw = dict(kw)
    cin, cout = kw.pop("cin"), kw.pop("cout")
    common = dict(emb_channels=24, num_heads=1, skip_scale=math.sqrt(0.5), eps=1e-6,
                  resample_proj=True, adaptive_scale=False,
                  init=dict(init_mode="xavier_uniform"),
                  init_zero=dict(init_mode="xavier_uniform", init_weight=1e-5),
                  init_attn=dict(init_mode="xavier_uniform", init_weight=math.sqrt(0.2)))
    common.update(kw)
    x, emb = _x(2, 8, 8, cin), _x(2, 24, seed=2)
    params, ref = _jax_run(JUNetBlock(cin, cout, **common), x, emb)
    block = load_jax_params(UNetBlock(cin, cout, **common), params).eval()
    with torch.no_grad():
        _close(block(torch.from_numpy(x), torch.from_numpy(emb)), ref)
