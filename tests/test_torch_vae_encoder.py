"""The port's KL encoder and posterior against the JAX package's.

The encoder at the size of JAX's ``tests/test_ldm.py::test_vae_encoder``
(ch 32, ch_mult (1, 2), one res block, 16 px images, ``double_z``; z 4 as
SD's), with and without attention at 8 px, inside a tiny KL stack that
``build_latent_diffusion(..., encoder=True)`` builds (a monkeypatched
``LDM_CONFIGS`` entry).  Every weight is redrawn at unit scale, written in
the reference checkpoint's layout (``reference_state_dict``) and split by
the JAX package's ``ldm_state_dict_to_params``, whose trees drive the JAX
``AutoencoderKL`` with its ``VAEEncoder``.  Inputs are numpy draws.  f32 on
the CPU, where the port's GroupNorm takes its plain version (K3 runs on the
card).

Bounds: the encoder's moments, the posterior's mean / logvar / std / mode,
``sample`` on a fixed noise tensor, the round trip ``decode(encode(x).mode())``
and ``_ConvDownAsym`` 2e-5 * max (the stacks sum f32 terms in other
orders); the posterior's clip and split on given moments, and the
checkpoint round trips, exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import ldm as JL
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.models.convert import load_ldm_jax_params

RES = 16
VAE = dict(z_channels=4, resolution=RES, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_resolutions=(), double_z=True)
TINY = dict(
    linear_start=0.00085, linear_end=0.0120, timesteps=1000, scale_factor=0.18215,
    conditioning_key=None, first_stage="kl",
    unet=dict(image_size=RES // 2, in_channels=4, out_channels=4, model_channels=32,
              num_res_blocks=1, attention_resolutions=(), channel_mult=(1,), num_heads=1),
    vae=VAE, embed_dim=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=2e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _redraw_unit_scale(module, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                    / math.sqrt(fan_in))


def _stack(monkeypatch, attn=(), seed=0, **kw):
    cfg = dict(TINY, vae=dict(VAE, attn_resolutions=attn))
    monkeypatch.setitem(TL.LDM_CONFIGS, "tiny_kl", cfg)
    ld = TL.build_latent_diffusion("tiny_kl", device="cpu", **kw)
    _redraw_unit_scale(ld, seed)
    return ld


def _jax_first_stage(trees, attn=()):
    vae = dict(VAE, attn_resolutions=attn)
    dec = JL.VAEDecoder(out_ch=3, **{k: v for k, v in vae.items() if k != "double_z"})
    enc = JL.VAEEncoder(in_channels=3, **vae)
    return JL.AutoencoderKL(decoder=dec, decoder_params=trees["decoder"],
                            quant_conv=trees["quant_conv"],
                            post_quant_conv=trees["post_quant_conv"],
                            encoder=enc, encoder_params=trees["encoder"])


def _images(seed, n=2):
    return np.random.RandomState(seed).randn(n, RES, RES, 3).astype(np.float32)


@pytest.mark.parametrize("attn", [(), (8,)], ids=["no attention", "attention at 8 px"])
def test_encode_and_round_trip_match_jax(monkeypatch, attn):
    ld = _stack(monkeypatch, attn, encoder=True)
    trees = JL.ldm_state_dict_to_params(TL.reference_state_dict(ld))
    jfirst = _jax_first_stage(trees, attn)
    x = _images(1)
    jpost = jfirst.encode(jnp.asarray(x))
    with torch.no_grad():
        post = ld.first_stage.encode(torch.from_numpy(x))
        moments = ld.first_stage.quant_conv(ld.first_stage.encoder(torch.from_numpy(x)))
        round_trip = ld.first_stage.decode(post.mode())
    jmoments = jfirst.encoder.apply({"params": jfirst.encoder_params}, jnp.asarray(x))
    assert post.mean.shape == (2, RES // 2, RES // 2, 4)
    _close(moments, JL._conv1x1(jmoments, trees["quant_conv"]), what="moments")
    for name in ("mean", "logvar", "std"):
        _close(getattr(post, name), getattr(jpost, name), what=name)
    _close(post.mode(), jpost.mode(), what="mode")
    _close(round_trip, jfirst.decode(jpost.mode()), what="decode(encode(x).mode())")


def test_sample_with_fixed_noise_matches_jax(monkeypatch):
    """JAX's ``sample(key)`` draws ``jax.random.normal``, the port's
    ``sample(generator)`` its ``_standard_normal``: both are handed the same
    numpy noise."""
    rng = np.random.RandomState(2)
    moments = (rng.randn(2, 4, 4, 8) * 3).astype(np.float32)
    noise = rng.randn(2, 4, 4, 4).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(noise))
    monkeypatch.setattr(TL, "_standard_normal", lambda like, g: torch.from_numpy(noise))
    jpost = JL.DiagonalGaussianDistribution(jnp.asarray(moments))
    post = TL.DiagonalGaussianDistribution(torch.from_numpy(moments))
    _close(post.sample(torch.Generator().manual_seed(0)), jpost.sample(jax.random.key(0)),
           what="sample")
    det = TL.DiagonalGaussianDistribution(torch.from_numpy(moments), deterministic=True)
    jdet = JL.DiagonalGaussianDistribution(jnp.asarray(moments), deterministic=True)
    np.testing.assert_array_equal(det.sample(None).numpy(), np.asarray(jdet.sample(None)))
    np.testing.assert_array_equal(det.sample(None).numpy(), moments[..., :4])


def test_posterior_split_and_clip_match_jax():
    """The moments' last axis splits into (mean, logvar) halves; logvar is
    clipped to [-30, 20] before std = exp(logvar / 2)."""
    moments = np.linspace(-45.0, 35.0, 2 * 3 * 5 * 8, dtype=np.float32).reshape(2, 3, 5, 8)
    post = TL.DiagonalGaussianDistribution(torch.from_numpy(moments))
    jpost = JL.DiagonalGaussianDistribution(jnp.asarray(moments))
    np.testing.assert_array_equal(post.mean.numpy(), moments[..., :4])
    np.testing.assert_array_equal(post.logvar.numpy(), np.clip(moments[..., 4:], -30.0, 20.0))
    assert post.logvar.min() == -30.0 and post.logvar.max() == 20.0
    for name in ("mean", "logvar"):
        np.testing.assert_array_equal(getattr(post, name).numpy(),
                                      np.asarray(getattr(jpost, name)))
    _close(post.std, jpost.std, rel=1e-6, what="std")
    np.testing.assert_array_equal(post.mode().numpy(), post.mean.numpy())


def test_conv_down_asym_matches_jax():
    """Zero padding (0, 1, 0, 1), then the stride-2 3x3 conv without
    padding, on odd sizes: (9 + 1 - 3) // 2 + 1 = 4 rows, 3 columns."""
    x = np.random.RandomState(3).randn(2, 9, 7, 8).astype(np.float32)
    mod = TL._ConvDownAsym(8, device="cpu")
    _redraw_unit_scale(mod, 4)
    assert set(mod.state_dict()) == {"conv.weight", "conv.bias"}
    params = {"kernel": mod.conv.weight.detach().numpy().transpose(2, 3, 1, 0),
              "bias": mod.conv.bias.detach().numpy()}
    want = JL._ConvDownAsym(8, 8).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.shape == (2, 4, 3, 8)
    _close(got, want, what="_ConvDownAsym")


def test_checkpoint_round_trip_with_and_without_the_encoder(monkeypatch):
    """``reference_state_dict`` writes the encoder under
    ``first_stage_model.encoder.*`` / ``quant_conv.*`` (the names the JAX
    package's ``ldm_state_dict_to_params`` splits); ``load_ldm_checkpoint``
    and ``convert.load_ldm_jax_params`` load them back bit-equal into a
    stack with its encoder; a stack without one leaves them out, and one
    with an encoder refuses a checkpoint that lacks them."""
    ld = _stack(monkeypatch, encoder=True)
    sd = TL.reference_state_dict(ld)
    enc_keys = [k for k in sd if k.startswith(TL.ENCODER_PREFIXES)]
    assert "first_stage_model.encoder.down.0.downsample.conv.weight" in sd
    assert "first_stage_model.quant_conv.weight" in sd and len(enc_keys) > 20
    assert not any(k.startswith("first_stage_model.encoder.") and "downsample" in k
                   and ".down.1." in k for k in sd)  # no downsample below the last level
    trees = JL.ldm_state_dict_to_params(sd)
    assert set(trees["encoder"]) == {k[len("first_stage_model.encoder."):].rsplit(".", 1)[0]
                                     .replace(".", "_") for k in sd
                                     if k.startswith("first_stage_model.encoder.")}
    own = ld.state_dict()
    for load in (lambda fresh: TL.load_ldm_checkpoint(fresh, sd),
                 lambda fresh: load_ldm_jax_params(fresh, trees)):
        fresh = _stack(monkeypatch, seed=1, encoder=True)
        load(fresh)
        got = fresh.state_dict()
        assert set(got) == set(own)
        for k in own:
            assert torch.equal(got[k], own[k]), k
    plain = _stack(monkeypatch, seed=2)
    assert plain.first_stage.encoder is None and plain.first_stage.quant_conv is None
    TL.load_ldm_checkpoint(plain, sd)
    assert all(TL.checkpoint_ignores(k) and not TL.checkpoint_ignores(k, encoder=True)
               for k in enc_keys)
    with pytest.raises(RuntimeError, match="without its encoder"):
        plain.first_stage.encode(torch.zeros(1, RES, RES, 3))
    lacking = {k: v for k, v in sd.items() if not k.startswith("first_stage_model.quant_conv.")}
    with pytest.raises(KeyError, match="quant_conv"):
        TL.load_ldm_checkpoint(_stack(monkeypatch, seed=3, encoder=True), lacking)
    with pytest.raises(KeyError, match="first_stage_model.encoder.bogus"):
        TL.load_ldm_checkpoint(_stack(monkeypatch, seed=3, encoder=True),
                               {**sd, "first_stage_model.encoder.bogus.weight": torch.zeros(1)})


def test_random_stack_with_encoder_and_vq_refusal(monkeypatch):
    """Random weights: quant_conv is the identity, as post_quant_conv; the
    decode-only stack's keys are those of the stack with an encoder less
    the encoder's; a VQ config has no encoder to build."""
    monkeypatch.setitem(TL.LDM_CONFIGS, "tiny_kl", TINY)
    with_enc = TL.build_latent_diffusion("tiny_kl", encoder=True, device="cpu")
    without = TL.build_latent_diffusion("tiny_kl", device="cpu")
    qc = with_enc.first_stage.quant_conv
    assert torch.equal(qc.weight[:, :, 0, 0], torch.eye(8)) and not qc.bias.any()
    extra = set(with_enc.state_dict()) - set(without.state_dict())
    assert extra and all(k.startswith(("first_stage.encoder.", "first_stage.quant_conv."))
                         for k in extra)
    for k, v in without.state_dict().items():
        assert torch.equal(v, with_enc.state_dict()[k]) or k.startswith("unet."), k
    with pytest.raises(ValueError, match="VQModel has no encode"):
        TL.build_latent_diffusion("lsun_bedroom_ldm", encoder=True, device="meta")
