"""The port's EDMPrecond + SongUNet against the JAX package's.

Tiny configurations (the ``__graft_entry__._flagship(tiny=True)`` DDPM++
net, and an NCSN++-style variant) with every parameter redrawn at unit scale,
so attention and the zero-init output convs show in D(x, sigma).  f32, max
abs error <= 1e-4 * max|D|, the bar PARITY.md section 2.6 holds the JAX
package to.  The key test builds the full-width CIFAR-10 net on both sides.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models.factory import build_edm_model as jax_build_edm_model
from diff_sampler_tpu.models.precond import EDMPrecond as JEDMPrecond
from diff_sampler_tpu_torch.models.convert import absent_from_jax, load_jax_params, params_from_jax
from diff_sampler_tpu_torch.models.factory import build_edm_model, create_model
from diff_sampler_tpu_torch.models.precond import EDMPrecond
from diff_sampler_tpu_torch.ops import attention as A

DDPMPP_TINY = dict(model_channels=16, channel_mult=[1, 2], num_blocks=1,
                   attn_resolutions=[8], dropout=0.0)
NCSNPP_TINY = dict(model_channels=16, channel_mult=[1, 2, 2], num_blocks=1,
                   attn_resolutions=[8], dropout=0.0, embedding_type="fourier",
                   channel_mult_noise=2, encoder_type="residual", decoder_type="skip",
                   resample_filter=[1, 3, 3, 1])
SIGMAS = [80.0, 10.0, 1.0, 0.1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU,
    where torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rescaled(params, seed):
    rng = np.random.RandomState(seed)

    def draw(a):
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        return (rng.randn(*a.shape) / math.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, params)


def _pair(model_kwargs, res=16):
    """(jax forward, port module) sharing one set of rescaled params."""
    net = JEDMPrecond(img_resolution=res, img_channels=3, model_kwargs=model_kwargs)
    params = jax.jit(net.init)(jax.random.key(0), jnp.zeros((1, res, res, 3)),
                               jnp.ones((1,)))["params"]
    params = _rescaled(params, seed=0)
    fwd = jax.jit(lambda x, s: net.apply({"params": params}, x, s))
    port = EDMPrecond(img_resolution=res, img_channels=3, model_kwargs=model_kwargs).eval()
    return fwd, load_jax_params(port, params)


@pytest.fixture(scope="module")
def ddpmpp():
    return _pair(DDPMPP_TINY)


@pytest.fixture(scope="module")
def ncsnpp():
    return _pair(NCSNPP_TINY)


def _check_d(pair, sigma, seed):
    fwd, port = pair
    x = np.random.RandomState(seed).randn(3, 16, 16, 3).astype(np.float32) * sigma
    s = np.full((3,), sigma, np.float32)
    ref = np.asarray(fwd(jnp.asarray(x), jnp.asarray(s)))
    with torch.no_grad():
        ours = port(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("sigma", SIGMAS)
def test_ddpmpp_denoiser_matches_jax(ddpmpp, sigma):
    _check_d(ddpmpp, sigma, seed=1)


@pytest.mark.parametrize("sigma", [80.0, 0.1])
def test_ncsnpp_denoiser_matches_jax(ncsnpp, sigma):
    _check_d(ncsnpp, sigma, seed=2)


def test_scalar_sigma_broadcasts(ddpmpp):
    _, port = ddpmpp
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32))
    with torch.no_grad():
        a = port(x, torch.tensor(2.5))
        b = port(x, torch.full((2,), 2.5))
    # one embedding row broadcast vs one per sample: equal up to GEMM rounding
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * b.abs().max().item())


def test_bf16_inner_model_tracks_f32(ddpmpp):
    _, port = ddpmpp
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 16, 16, 3).astype(np.float32))
    with torch.no_grad():
        d32 = port(x, 1.0)
        port.dtype = torch.bfloat16
        try:
            d16 = port(x, 1.0)
        finally:
            port.dtype = torch.float32
    assert d16.dtype == torch.float32
    assert (d16 - d32).abs().max().item() <= 5e-2 * d32.abs().max().item()


@pytest.mark.parametrize("dataset", ["cifar10", "ffhq"])
def test_full_width_state_dict_keys_and_shapes_match_jax(dataset):
    net = jax_build_edm_model(dataset)
    res, ch = net.img_resolution, net.img_channels
    shapes = jax.eval_shape(net.init, jax.random.key(0), jnp.zeros((1, res, res, ch)),
                            jnp.ones((1,)))["params"]
    jax_sd = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    port_sd = build_edm_model(dataset, device="meta").state_dict()
    absent = {k for k in port_sd if absent_from_jax(k)}
    assert set(jax_sd) == set(port_sd) - absent
    assert "model.map_augment.weight" in absent
    assert all(tuple(jax_sd[k].shape) == tuple(port_sd[k].shape) for k in jax_sd)


def test_cifar10_net_has_six_attention_sites():
    module = build_edm_model("cifar10", device="meta")
    sites = [name for name, m in module.named_modules() if getattr(m, "num_heads", 0)]
    assert sites == ["model.enc.16x16_block0", "model.enc.16x16_block1",
                     "model.enc.16x16_block2", "model.enc.16x16_block3",
                     "model.dec.8x8_in0", "model.dec.16x16_block4"]
    assert all(m.qkv.weight.shape == (768, 256, 1, 1) for n, m in module.named_modules()
               if getattr(m, "num_heads", 0))


def test_tiny_forward_on_cpu_never_counts_kernel_launches(ddpmpp):
    _, port = ddpmpp
    before = A.flash_attention_mh.launches
    with torch.no_grad():
        port(torch.zeros(1, 16, 16, 3), 1.0)
    assert A.flash_attention_mh.launches == before


def test_create_model_random_is_seeded_and_eval():
    a, source = create_model("cifar10", "random", device="cpu")
    b, _ = create_model("cifar10", "random", device="cpu")
    assert source == "edm" and not a.training
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with pytest.raises(FileNotFoundError, match="some.pkl"):  # a missing checkpoint file raises
        create_model("cifar10", "some.pkl", device="cpu")
