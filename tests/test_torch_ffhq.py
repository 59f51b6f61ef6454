"""The FFHQ-64 tier at a tiny size: a 4-level SongUNet with FFHQ's
architecture (``EDM_ARCHS["ffhq"]``: positional embedding, standard encoder
and decoder, box resampling, channel_mult [1, 2, 2, 2]) cut to 16 channels,
one block per level and 32x32 inputs, every parameter redrawn at unit scale
on the JAX side and converted.  D(x, sigma) against the JAX package's in f32
within 1e-4 * max|D| (PARITY.md section 2.6), and UniPC / DEIS sampling
through ``build_sample_fn`` at NFE 5 against the JAX package's on the same
latents within 1e-4 * max|x|.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu import sampling as JSAMP
from diff_sampler_tpu.models.factory import EDM_ARCHS as JAX_ARCHS
from diff_sampler_tpu.models.precond import EDMPrecond as JEDMPrecond
from diff_sampler_tpu.models.precond import bind as jbind
from diff_sampler_tpu_torch import sampling as S
from diff_sampler_tpu_torch.models.convert import load_jax_params
from diff_sampler_tpu_torch.models.factory import EDM_ARCHS
from diff_sampler_tpu_torch.models.precond import EDMPrecond, bind

RES = 32
TINY = dict(EDM_ARCHS["ffhq"][1], model_channels=16, num_blocks=1, attn_resolutions=[16],
            dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU,
    where torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX net, its unit-scale params, the port's module holding them)."""
    assert TINY["channel_mult"] == [1, 2, 2, 2]
    assert dict(EDM_ARCHS["ffhq"][1]) == dict(JAX_ARCHS["ffhq"][1])
    net = JEDMPrecond(img_resolution=RES, img_channels=3, model_kwargs=TINY)
    params = jax.jit(net.init)(jax.random.key(0), jnp.zeros((1, RES, RES, 3)),
                               jnp.ones((1,)))["params"]
    rng = np.random.RandomState(0)

    def draw(a):
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        return (rng.randn(*a.shape) / math.sqrt(fan_in)).astype(np.float32)

    params = jax.tree.map(draw, params)
    port = load_jax_params(EDMPrecond(RES, 3, model_kwargs=TINY).eval(), params)
    return net, params, port


@pytest.mark.parametrize("sigma", [80.0, 2.0, 0.05])
def test_ffhq_like_denoiser_matches_jax(pair, sigma):
    net, params, port = pair
    x = np.random.RandomState(1).randn(2, RES, RES, 3).astype(np.float32) * sigma
    s = np.full((2,), sigma, np.float32)
    ref = np.asarray(jax.jit(lambda x, s: net.apply({"params": params}, x, s))(
        jnp.asarray(x), jnp.asarray(s)))
    with torch.no_grad():
        ours = port(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("solver,kw", [("unipc", dict(variant="bh1")), ("deis", dict())])
def test_ffhq_like_sampling_matches_jax(pair, solver, kw):
    net, params, port = pair
    lat = np.random.RandomState(2).randn(2, RES, RES, 3).astype(np.float32)
    jcfg = JSAMP.SolverConfig(solver=solver, num_steps=6, **kw)
    ref = np.asarray(jax.jit(JSAMP.build_sample_fn(jbind(net, params), jcfg))(jnp.asarray(lat)))
    cfg = S.SolverConfig(solver=solver, num_steps=6, **kw)
    assert cfg.nfe() == jcfg.nfe() == 5
    ours = S.build_sample_fn(bind(port), cfg)(torch.from_numpy(lat)).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_full_width_ffhq_net_sites():
    """The full-width FFHQ-64 net (built on the meta device): the six
    attention sites of the 16x16 level and the middle block (T=256 and 64,
    one head of 256 channels) and 95 GroupNorm layers, the per-forward K1 and
    K3 launches ``chip_smoke.py`` holds its FFHQ phase to."""
    from diff_sampler_tpu_torch.models.factory import build_edm_model
    from diff_sampler_tpu_torch.models.layers import GroupNorm

    module = build_edm_model("ffhq", device="meta")
    sites = [m for m in module.modules() if getattr(m, "num_heads", 0)]
    assert len(sites) == 6 and all(m.num_heads == 1 and m.qkv.weight.shape[1] == 256
                                   for m in sites)
    assert sum(isinstance(m, GroupNorm) for m in module.modules()) == 95
