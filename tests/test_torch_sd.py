"""The port's Stable Diffusion tier (``ms_coco``) against the JAX package's.

A tiny stand-in for ``LDM_CONFIGS["ms_coco"]`` (the U-Net of
tests/test_amed_tiers.py's SD tier: 4-channel 16x16 latents, 32 channels,
mult [1, 2], one res block per level, spatial transformers with 2 heads at
both levels and a 16-wide context of 5 tokens; a KL decoder of 32 channels
to 32x32 images) is built by the port's factory with every weight redrawn
at unit scale, then handed to the JAX modules through the JAX package's own
``_mechanical`` (the reference state_dict names with '.' -> '_').  Inputs
and contexts are numpy draws handed to both sides.  f32 on the CPU, where
the port's GroupNorm and attention take their plain versions (kernels K3,
K1 / K2 and K1c / K2c run on the card).

From a checkpoint: a tiny SD checkpoint in ``v1-5-pruned-emaonly.ckpt``'s
layout with a tiny CLIP text tower (tests/test_torch_checkpoint.py writes
it) drives the sampling CLI with ``--prompt``, with per-seed captions and
with ``--dp``, each byte for byte ``generate`` on
``get_learned_conditioning``'s contexts, and AMED on encoded captions.

Bounds: the LayerNorm, GEGLU feed-forward, self- and cross-attention and the
spatial transformer 1e-5 * max; the conditioning draws and the param
conversion exact; the U-Net, its bottleneck, the KL decode, D(x, sigma) under
guidance 7.5, the pooled tap and ``generate`` (with bound or per-seed
contexts) 2e-5 * max (deeper stacks sum
more f32 terms in other orders); one SGD AMED step: loss within 1e-4
relative, params within 5e-4 of the step's largest move (as
tests/test_torch_ldm.py).
"""

import dataclasses
import math
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sampler_tpu import sampling as JSAMP
from diff_sampler_tpu.models import ldm as JL
from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.models.factory import _capture_middle_lazy
from diff_sampler_tpu.ops import get_schedule as jax_get_schedule
from diff_sampler_tpu.solvers import amed as JA
from diff_sampler_tpu.solvers import samplers as JS
from diff_sampler_tpu.training import amed as JT
from diff_sampler_tpu.training import conditioning as JC
from diff_sampler_tpu_torch import sampling as S
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed as cli_train
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.gits.search import GITSConfig, gits_schedule
from diff_sampler_tpu_torch.models import text as TTX
from diff_sampler_tpu_torch.models.convert import load_jax_params, load_ldm_jax_params
from diff_sampler_tpu_torch.models.convert import params_to_jax
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.solvers import amed as TA
from diff_sampler_tpu_torch.training import amed as TT
from diff_sampler_tpu_torch.training import conditioning as TC
from diff_sampler_tpu_torch.utils import checkpoint as ckpt
from diff_sampler_tpu_torch.utils.image import encode_png
from diff_sampler_tpu_torch.utils.rng import stacked_randn
from test_torch_checkpoint import patch_tiny_sd, write_ldm_checkpoint

RES, CTX_DIM, TOKENS = 16, 16, 5
TINY = dict(
    linear_start=0.00085, linear_end=0.0120, timesteps=1000,
    scale_factor=0.18215, conditioning_key="crossattn", first_stage="kl",
    unet=dict(image_size=RES, in_channels=4, out_channels=4, model_channels=32,
              num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2,
              use_spatial_transformer=True, transformer_depth=1, context_dim=CTX_DIM,
              legacy=False),
    vae=dict(z_channels=4, resolution=2 * RES, ch=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(), double_z=True),
    embed_dim=4)
# The CLI's stand-in: 8x8 latents and one level (the middle block still pools
# to 64 predictor inputs), its spatial transformer the only one, so that a
# guided 1000-sample AMED iteration takes seconds.
TINY_CLI = dict(TINY, unet=dict(TINY["unet"], image_size=8, channel_mult=(1,),
                                attention_resolutions=()),
                vae=dict(TINY["vae"], resolution=16))
GUIDANCE = 7.5


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


def _mech(module, prefix):
    """The JAX params of a port module, named as its JAX parent names them."""
    return JL._mechanical({f"{prefix}.{k}": v for k, v in module.state_dict().items()})


def _jax_trees(ld):
    pq = ld.first_stage.post_quant_conv
    return dict(unet=JL._mechanical(ld.unet.state_dict()),
                decoder=JL._mechanical(ld.first_stage.decoder.state_dict()), quant_conv=None,
                post_quant_conv={"kernel": pq.weight.detach().numpy().transpose(2, 3, 1, 0),
                                 "bias": pq.bias.detach().numpy()})


def _jax_precond(trees, res):
    """The JAX package's SD denoiser over ``trees``: its ``build_ldm_model``
    on the ms_coco branch, less the random init."""
    ld = JL.build_latent_diffusion("ms_coco", params_override=trees)
    pre = JP.CFGPrecond(model_fn=lambda x, t, cond: ld.apply_model(x, t, cond),
                        alphas_cumprod=ld.alphas_cumprod, img_resolution=res, img_channels=4,
                        guidance_type="classifier-free", guidance_rate=GUIDANCE, epsilon_t=1e-3,
                        label_dim=1, model_fn_bottleneck=_capture_middle_lazy(ld))
    pre.sigma_min = 0.1
    pre.latent_diffusion = ld
    return pre


def _tiers(config):
    """(the port's CFGPrecond from its factory, the JAX one, the JAX trees)
    over one set of weights, for a stand-in ``config`` of ms_coco."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(TL.LDM_CONFIGS, "ms_coco", config)
        mp.setitem(JL.LDM_CONFIGS, "ms_coco", config)
        pre_t, source = factory.create_model("ms_coco", "random", guidance_rate=GUIDANCE,
                                             device="cpu")
        assert source == "sd" and pre_t.guidance_rate == GUIDANCE
        _redraw_unit_scale(pre_t.latent_diffusion, seed=0)
        trees = _jax_trees(pre_t.latent_diffusion)
        return pre_t, _jax_precond(trees, config["unet"]["image_size"]), trees


@pytest.fixture(scope="module")
def tiers():
    return _tiers(TINY)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ctx(seed, n=2):
    return _rand(seed, n, TOKENS, CTX_DIM)


def _apply(fn_of_parent, params, *args):
    """Run a JAX layer builder (``fn_of_parent(parent) -> callable``) under a
    throwaway Flax module with ``params``."""
    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, *a):
            return fn_of_parent(self)(*a)

    return Wrap().apply({"params": params}, *(jnp.asarray(a) for a in args))


def test_sd_config_matches_the_jax_package():
    assert TL.LDM_CONFIGS["ms_coco"] == JL.LDM_CONFIGS["ms_coco"]


def test_full_width_sd_unet_has_the_reference_params_and_16_attention_sites():
    """The full SD v1.5 U-Net on the meta device: 860M parameters, named as
    the JAX init names them, and 16 spatial transformers with 8 heads of 40,
    80 and 160 channels (5, 5 and 6 sites, the middle block's among them)."""
    cfg = TL.LDM_CONFIGS["ms_coco"]["unet"]
    unet = TL.LDMUNet(device="meta", **cfg)
    shapes = jax.eval_shape(JL.LDMUNet(**cfg).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 4)), jnp.ones((1,)),
                            jnp.zeros((1, 77, 768)))["params"]
    got = JL._mechanical({k: np.zeros(v.shape, np.float32) for k, v in unet.state_dict().items()})
    assert jax.tree.map(np.shape, got) == jax.tree.map(lambda s: s.shape, shapes)
    assert 859e6 < sum(p.numel() for p in unet.parameters()) < 860e6
    sites = [m.transformer_blocks[0].attn1 for m in unet.modules()
             if isinstance(m, TL.SpatialTransformer)]
    assert sorted(a.dim_head for a in sites) == [40] * 5 + [80] * 5 + [160] * 6
    assert {a.heads for a in sites} == {8}


def test_layernorm_matches_jax():
    ln = factory.init_params(TL._LN(24, device="cpu"))
    _redraw_unit_scale(ln, seed=1)
    with torch.no_grad():
        ln.weight.add_(1.0)
    x = _rand(2, 3, 7, 24) * 3 + 1
    want = JL._LN(24).apply({"params": {"scale": ln.weight.detach().numpy(),
                                        "bias": ln.bias.detach().numpy()}}, jnp.asarray(x))
    with torch.no_grad():
        _close(ln(torch.from_numpy(x)).numpy(), want, rel=1e-5)


def test_geglu_feed_forward_matches_jax_tanh_gelu():
    """The JAX package's GEGLU calls ``jax.nn.gelu`` bare (its tanh form):
    the port matches it at 1e-5, where the exact GELU would miss."""
    ff = factory.init_params(TL.FeedForward(24, device="cpu"))
    _redraw_unit_scale(ff, seed=3)
    x = _rand(4, 2, 9, 24) * 2
    want = _apply(lambda p: JL._feed_forward(p, "ff", 24), _mech(ff, "ff"), x)
    with torch.no_grad():
        _close(ff(torch.from_numpy(x)).numpy(), want, rel=1e-5)
        h, gate = ff.net["0"].proj(torch.from_numpy(x)).chunk(2, dim=-1)
        exact = ff.net["2"](h * torch.nn.functional.gelu(gate)).numpy()
    assert np.abs(exact - np.asarray(want)).max() > 1e-5 * np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("context", [False, True], ids=["self", "cross"])
def test_self_and_cross_attention_match_jax(context):
    attn = factory.init_params(TL.CrossAttention(32, CTX_DIM if context else 32, 2, 16,
                                                 device="cpu"))
    _redraw_unit_scale(attn, seed=5)
    x = _rand(6, 2, 20, 32)
    args = (x, _ctx(7)) if context else (x,)
    want = _apply(lambda p: JL._cross_attention(p, "attn", 32, CTX_DIM if context else 32, 2,
                                                16), _mech(attn, "attn"), *args)
    with torch.no_grad():
        _close(attn(*(torch.from_numpy(a) for a in args)).numpy(), want, rel=1e-5)


def test_spatial_transformer_matches_jax():
    st = factory.init_params(TL.SpatialTransformer(64, 2, 32, 1, CTX_DIM, device="cpu"))
    _redraw_unit_scale(st, seed=8)
    x, ctx = _rand(9, 2, 4, 4, 64), _ctx(10)
    want = _apply(lambda p: JL._spatial_transformer(p, "st", 64, 2, 32, 1, CTX_DIM),
                  _mech(st, "st"), x, ctx)
    with torch.no_grad():
        _close(st(torch.from_numpy(x), torch.from_numpy(ctx)).numpy(), want, rel=1e-5)


def test_param_conversion_round_trips(tiers):
    """``load_ldm_jax_params`` puts the JAX trees of the SD stack (the KL
    stage has no codebook) back into a fresh stack, tensor for tensor."""
    pre_t, _, trees = tiers
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(TL.LDM_CONFIGS, "ms_coco", TINY)
        fresh = TL.build_latent_diffusion("ms_coco", seed=3, device="cpu")
    load_ldm_jax_params(fresh, trees)
    want, got = pre_t.latent_diffusion.state_dict(), fresh.state_dict()
    assert set(got) == set(want)
    assert "unet.input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight" in got
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_unet_with_context_and_bottleneck_match_jax(tiers):
    pre_t, pre_j, trees = tiers
    x, ctx = _rand(11, 2, RES, RES, 4) * 2.0, _ctx(12)
    t = np.array([5.0, 700.0], np.float32)
    unet_j = pre_j.latent_diffusion.unet
    out_j, bot_j = jax.jit(lambda *a: unet_j.apply({"params": trees["unet"]}, *a,
                                                   return_bottleneck=True))(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out_t, bot_t = pre_t.latent_diffusion.unet(torch.from_numpy(x), torch.from_numpy(t),
                                                   torch.from_numpy(ctx), return_bottleneck=True)
    assert bot_t.shape == (2, RES // 2, RES // 2, 64)
    _close(out_t.numpy(), out_j, what="eps")
    _close(bot_t.numpy(), bot_j, what="middle block")


def test_kl_decode_with_scale_factor_matches_jax(tiers):
    pre_t, pre_j, _ = tiers
    ld_t = pre_t.latent_diffusion
    assert isinstance(ld_t.first_stage, TL.AutoencoderKL) and ld_t.scale_factor == 0.18215
    z = _rand(13, 2, RES, RES, 4) * 0.18215
    with torch.no_grad():
        img = ld_t.decode_first_stage(torch.from_numpy(z)).numpy()
        unscaled = ld_t.first_stage.decode(torch.from_numpy(z / 0.18215)).numpy()
    assert img.shape == (2, 2 * RES, 2 * RES, 3)
    _close(img, pre_j.latent_diffusion.decode_first_stage(jnp.asarray(z)), what="decode")
    np.testing.assert_array_equal(img, unscaled)
    _close(ld_t.decode_in_chunks(z, chunk=1), img, what="one at a time")


def test_guided_denoiser_and_doubled_bottleneck_match_jax(tiers):
    """D(x, sigma) under guidance 7.5 runs the doubled (unconditional,
    conditional) batch; the AMED tap pools the conditional half."""
    pre_t, pre_j, _ = tiers
    x = _rand(14, 2, RES, RES, 4) * np.array([14.0, 0.5], np.float32)[:, None, None, None]
    s = np.array([14.0, 0.5], np.float32)
    ctx, uc = _ctx(15), _ctx(16, n=1)
    kw_j = dict(condition=jnp.asarray(ctx), unconditional_condition=jnp.asarray(uc))
    kw_t = dict(condition=torch.from_numpy(ctx), unconditional_condition=torch.from_numpy(uc))
    d_j, b_j = jax.jit(JA.bind_with_bottleneck(pre_j, cfg_doubled=True, **kw_j).fn)(
        jnp.asarray(x), jnp.asarray(s))
    den_t = TA.bind_with_bottleneck(pre_t, cfg_doubled=True, **kw_t)
    assert not any(p.requires_grad for p in pre_t.latent_diffusion.parameters())
    calls = []
    real = pre_t.latent_diffusion.unet.forward

    def spy(x_in, *a, **k):
        calls.append(x_in.shape[0])
        return real(x_in, *a, **k)

    pre_t.latent_diffusion.unet.forward = spy
    try:
        with torch.no_grad():
            d_t, b_t = den_t.with_bottleneck(torch.from_numpy(x), torch.from_numpy(s))
            plain = den_t(torch.from_numpy(x), torch.from_numpy(s))
    finally:
        del pre_t.latent_diffusion.unet.forward
    assert calls == [4, 4] and b_t.shape == (2, 64)
    _close(d_t.numpy(), d_j, what="D")
    _close(b_t.numpy(), b_j, what="pooled conditional tap")
    torch.testing.assert_close(plain, d_t, rtol=0, atol=0)
    assert np.abs(d_t.numpy() - x).max() > 0.1  # the net shows


def test_generate_with_guidance_matches_jax(tiers):
    """The slice as a whole: ``generate`` at NFE 3 (euler, 4 steps, discrete
    schedule, rho 1) with bound contexts, and the JAX sampler on the same
    per-seed latents."""
    pre_t, pre_j, _ = tiers
    seeds, ctx, uc = [3, 1, 4], _ctx(17, n=3), _ctx(18, n=1)
    cfg = S.SolverConfig(solver="euler", num_steps=4, schedule_type="discrete",
                         schedule_rho=1.0)
    assert cfg.nfe() == 3
    den = bind(pre_t, condition=torch.from_numpy(ctx), unconditional_condition=torch.from_numpy(uc))
    got = S.generate(den, seeds, (RES, RES, 4), cfg, max_batch_size=3, device="cpu")
    lat = stacked_randn(seeds, (RES, RES, 4), device="cpu").numpy()
    t_steps = jax_get_schedule(4, pre_j.sigma_min, pre_j.sigma_max, "discrete", 1.0,
                               sigma_fn=pre_j.sigma, sigma_inv_fn=pre_j.sigma_inv)
    den_j = JP.bind(pre_j, condition=jnp.asarray(ctx), unconditional_condition=jnp.asarray(uc))
    want = jax.jit(lambda z: JS.get_sampler("euler")(den_j, z, t_steps).x)(jnp.asarray(lat))
    _close(got, want)
    images = pre_t.latent_diffusion.decode_in_chunks(got)
    assert images.shape == (3, 2 * RES, 2 * RES, 3) and np.isfinite(images).all()


def test_amed_train_step_with_contexts_matches_jax():
    """One AMED trajectory through the guided SD tier (the CLI's stand-in
    net; discrete schedule, two steps, student amed, teacher euler, M=1),
    two microbatches, each bound to its own contexts, with SGD(0.1) on both
    sides."""
    pre_t, pre_j, _ = _tiers(TINY_CLI)
    uc = _ctx(19, n=2)
    cfg = TT.AMEDConfig(dataset_name="ms_coco", num_steps=2, M=1, sampler_stu="amed",
                        sampler_tea="euler", schedule_type="discrete", schedule_rho=1.0,
                        sigma_min=pre_t.sigma_min, sigma_max=pre_t.sigma_max, batch=4,
                        batch_gpu=2, guidance_type="cfg", guidance_rate=GUIDANCE)
    cfg_j = JT.AMEDConfig(**{k: getattr(cfg, k) for k in JT.AMEDConfig.__dataclass_fields__
                             if hasattr(cfg, k)})
    pred_j = JA.AMEDPredictor(scale_dir=cfg.scale_dir, scale_time=cfg.scale_time)
    p0 = jax.tree.map(np.asarray, pred_j.init(jax.random.key(3), jnp.zeros((2, 64)),
                                              jnp.asarray(1.0), jnp.asarray(0.5))["params"])
    pred_t = load_jax_params(TA.AMEDPredictor(scale_dir=cfg.scale_dir,
                                              scale_time=cfg.scale_time), p0)
    lat, ctx = _rand(20, 4, 8, 8, 4), _ctx(21, n=4)
    opt = optax.sgd(0.1)

    def factory_j(c):
        return JA.bind_with_bottleneck(pre_j, cfg_doubled=True, condition=c,
                                       unconditional_condition=jnp.asarray(uc))

    new, _, metrics = jax.jit(JT.make_amed_train_step(
        pred_j, None, cfg_j, opt, denoise_factory=factory_j, sigma_fn=pre_j.sigma,
        sigma_inv_fn=pre_j.sigma_inv))(p0, opt.init(p0), jnp.asarray(lat), jnp.asarray(ctx))

    def factory_t(c):
        return TA.bind_with_bottleneck(pre_t, cfg_doubled=True, condition=c,
                                       unconditional_condition=torch.from_numpy(uc))

    step = TT.make_amed_train_step(pred_t, None, cfg, torch.optim.SGD(pred_t.parameters(),
                                                                      lr=0.1),
                                   denoise_factory=factory_t)
    loss_t = float(step(torch.from_numpy(lat), torch.from_numpy(ctx))["loss"])
    loss_j = float(metrics["loss"])
    assert math.isfinite(loss_t) and abs(loss_t - loss_j) <= 1e-4 * abs(loss_j)
    state = pred_t.state_dict()
    moved = max(np.abs(state[f"{layer}.weight"].numpy() - leaves["kernel"].T).max()
                for layer, leaves in p0.items())
    assert moved > 1e-3
    for layer, leaves in jax.tree.map(np.asarray, new).items():
        np.testing.assert_allclose(state[f"{layer}.weight"].numpy(), leaves["kernel"].T,
                                   rtol=0, atol=5e-4 * moved, err_msg=layer)
        np.testing.assert_allclose(state[f"{layer}.bias"].numpy(), leaves["bias"], rtol=0,
                                   atol=5e-4 * moved, err_msg=layer)


def test_conditioning_draws_are_bit_equal_to_jax(tiers, tmp_path):
    pre_t, pre_j, _ = tiers
    ld_t, ld_j = pre_t.latent_diffusion, pre_j.latent_diffusion
    for batch, seed, it in ((3, 0, 0), (8, 5, 7), (2, 2 ** 31 - 3, 9)):
        got = TC.make_caption_context_fn(ld_t, None, batch, seed, verbose=False)(it)
        want = JC.make_caption_context_fn(ld_j, None, batch, seed, verbose=False)(it)
        assert got.shape == (batch, 77, CTX_DIM) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for mb, rate, seed in ((4, GUIDANCE, 0), (2, 3.0, 11)):
        np.testing.assert_array_equal(TC.make_uncond_context(ld_t, mb, rate, seed),
                                      JC.make_uncond_context(ld_j, mb, rate, seed))
    assert TC.make_uncond_context(ld_t, 4, 1.0) is None
    csv = tmp_path / "captions.csv"
    csv.write_text('text,id\n"a cat, on a mat",1\na dog,2\n')
    assert TC.load_captions(str(csv)) == JC.load_captions(str(csv)) == ["a cat, on a mat",
                                                                        "a dog"]
    with pytest.raises(FileNotFoundError):
        TC.load_captions(str(tmp_path / "missing.csv"))


@pytest.fixture
def tiny_cli(monkeypatch, tmp_path):
    monkeypatch.setitem(TL.LDM_CONFIGS, "ms_coco", TINY_CLI)
    monkeypatch.chdir(tmp_path)


def test_train_amed_cli_trains_sd_with_guidance(tiny_cli, capsys):
    """train_amed --dataset_name=ms_coco --guidance_type=cfg: one iteration
    of 1000 two-step trajectories in microbatches of 500 under guidance 7.5; the
    sidecar holds SD's sigma range and the guidance, and the predictor
    samples through ``bind_with_bottleneck(..., cfg_doubled=True)``."""
    with pytest.raises(ValueError, match="guidance_type=cfg"):
        cli_train.main(["--dataset_name=ms_coco", "--model_path=random", "--device=cpu"])
    run = cli_train.main(["--dataset_name=ms_coco", "--guidance_type=cfg",
                          f"--guidance_rate={GUIDANCE}", "--model_path=random", "--batch=1000",
                          "--batch_gpu=500", "--num_steps=2", "--total_kimg=1", "--device=cpu",
                          "--outdir=exps"])
    assert "seeded random contexts" in capsys.readouterr().out
    assert os.path.basename(run) == "00000-ms_coco-2-2-amed-heun"
    cfg = cli_train.AMEDConfig(**ckpt.load_config(os.path.join(run, "predictor_config.json")))
    pre, source = factory.create_model("ms_coco", "random", guidance_rate=GUIDANCE, device="cpu")
    assert source == "sd"
    assert (cfg.sigma_min, cfg.sigma_max) == (0.1, pre.sigma_max)
    assert (cfg.guidance_type, cfg.guidance_rate, cfg.batch_gpu) == ("cfg", GUIDANCE, 500)
    ctx, uc = torch.from_numpy(_ctx(22, n=3)), torch.from_numpy(_ctx(23, n=1))
    fn, _ = cli_sample.build_amed_sample_fn(pre, run, "cpu", cfg_doubled=True, condition=ctx,
                                            unconditional_condition=uc)
    x = fn(stacked_randn([0, 1, 2], (8, 8, 4), device="cpu"))
    assert x.shape == (3, 8, 8, 4) and torch.isfinite(x).all()
    with pytest.raises(ValueError, match="text encoder"):  # random weights have none
        cli_sample.main(["--dataset_name=ms_coco", "--device=cpu"])


def test_generate_with_per_seed_contexts_matches_jax(tiers, monkeypatch):
    """``generate(per_seed_cond=...)``: one context row per seed, padded and
    chunked as the latents are (3 seeds at batch 2), against the JAX
    package's ``generate(per_seed_cond=..., denoise_with_labels=...)`` on the
    port's per-seed latents (its own generator draws others)."""
    pre_t, pre_j, _ = tiers
    monkeypatch.setattr(JSAMP, "stacked_randn", lambda seeds, shape, *a: jnp.asarray(
        stacked_randn(np.asarray(seeds).tolist(), shape, device="cpu").numpy()))
    seeds, rows, uc = [3, 1, 4], _ctx(24, n=3), _ctx(25, n=1)
    cfg = S.SolverConfig(solver="euler", num_steps=3, schedule_type="discrete",
                         schedule_rho=1.0)
    got = S.generate(bind(pre_t, unconditional_condition=torch.from_numpy(uc)), seeds,
                     (RES, RES, 4), cfg, max_batch_size=2, device="cpu", per_seed_cond=rows)
    jcfg = JSAMP.SolverConfig(solver="euler", num_steps=3, schedule_type="discrete",
                              schedule_rho=1.0)
    want = JSAMP.generate(
        JP.bind(pre_j), seeds, (RES, RES, 4), jcfg, max_batch_size=2, sigma_fn=pre_j.sigma,
        sigma_inv_fn=pre_j.sigma_inv, per_seed_cond=rows,
        denoise_with_labels=lambda x, t, c: pre_j(
            x, t, condition=c, unconditional_condition=jnp.broadcast_to(uc, c.shape)))
    _close(got, want, what="per-seed rows")
    one = S.generate(bind(pre_t, condition=torch.from_numpy(rows[1:2]),
                          unconditional_condition=torch.from_numpy(uc)), seeds[1:2],
                     (RES, RES, 4), cfg, device="cpu")
    np.testing.assert_array_equal(one[0], got[1])  # a row is its own seed's and context's
    with pytest.raises(ValueError, match="2 rows for 3 seeds"):
        S.generate(bind(pre_t), seeds, (RES, RES, 4), cfg, device="cpu", per_seed_cond=rows[:2])


CAPTIONS = ["a cat on the mat", "low photo of a dog", "the café"]


@pytest.fixture
def sd_checkpoint(tiny_cli, monkeypatch, tmp_path):
    """The CLI's stand-in net with a tiny CLIP text tower (a synthetic BPE
    vocab through $CLIP_BPE_VOCAB), every weight redrawn at unit scale,
    written as ``v1-5-pruned-emaonly.ckpt`` is laid out; the captions CSV in
    an offline root of the working directory.  Returns the checkpoint path."""
    patch_tiny_sd(monkeypatch, TINY_CLI, tmp_path)
    src = TL.build_latent_diffusion("ms_coco", device="cpu")
    src.cond_stage_model = factory.init_params(TTX.FrozenCLIPEmbedder(device="cpu"))
    _redraw_unit_scale(src, seed=26)
    path = str(tmp_path / "sd.ckpt")
    write_ldm_checkpoint(path, src, TINY_CLI)
    os.makedirs("models")
    with open(os.path.join("models", "MS-COCO_val2014_30k_captions.csv"), "w") as f:
        f.write("image_id,id,text\n" + "".join(f'{i},{i},"{c}"\n' for i, c in enumerate(CAPTIONS)))
    return path


def _pngs(outdir, seeds):
    out = []
    for seed in seeds:
        with open(os.path.join(outdir, f"{seed - seed % 1000:06d}", f"{seed:06d}.png"), "rb") as f:
            out.append(f.read())
    return out


def test_sample_cli_runs_sd_from_a_checkpoint_with_prompt_and_captions(sd_checkpoint):
    """``cli/sample.py --dataset_name=ms_coco --model_path=<file>``: with
    ``--prompt`` every seed gets the prompt's context, without it seed s gets
    caption s % 3; under guidance 7.5 both add the empty prompt's context.
    The PNGs are ``generate`` on ``get_learned_conditioning``'s contexts,
    decoded, byte for byte (5 seeds at batch 2)."""
    seeds = list(range(5))
    common = [f"--model_path={sd_checkpoint}", f"--guidance_rate={GUIDANCE}", "--solver=euler",
              "--num_steps=3", "--seeds=0-4", "--batch=2", "--device=cpu"]
    cli_sample.main(["--dataset_name=ms_coco", "--prompt=a photo of the cat",
                     "--outdir=prompt", *common])
    cli_sample.main(["--dataset_name=ms_coco", "--guidance_type=cfg", "--outdir=captions",
                     *common])
    pre, source = factory.create_model("ms_coco", sd_checkpoint, guidance_rate=GUIDANCE,
                                       device="cpu")
    ld = pre.latent_diffusion
    assert source == "sd" and ld.cond_stage_model is not None
    uc = ld.get_learned_conditioning([""])
    cfg = S.SolverConfig(solver="euler", num_steps=3, schedule_type="discrete",
                         schedule_rho=1.0)
    runs = {"prompt": dict(den=bind(pre, condition=ld.get_learned_conditioning(
                ["a photo of the cat"]), unconditional_condition=uc)),
            "captions": dict(den=bind(pre, unconditional_condition=uc), per_seed_cond=(
                ld.get_learned_conditioning([CAPTIONS[s % 3] for s in seeds])))}
    images = {}
    for name, kw in runs.items():
        latents = S.generate(kw.pop("den"), seeds, (8, 8, 4), cfg, max_batch_size=2,
                             device="cpu", **kw)
        images[name] = S.to_uint8(ld.decode_in_chunks(latents))
        assert _pngs(name, seeds) == [encode_png(im) for im in images[name]], name
    assert (images["prompt"] != images["captions"]).any()
    assert (images["captions"][0] != images["captions"][3]).any()  # same caption, other seed
    with pytest.raises(SystemExit):  # classifier-free guidance is the only kind
        cli_sample.main(["--dataset_name=ms_coco", "--guidance_type=uncond", *common])
    with pytest.raises(NotImplementedError, match="apply to ms_coco"):
        cli_sample.main(["--dataset_name=lsun_bedroom_ldm", "--prompt=a cat", "--device=cpu"])


def test_sample_cli_gits_on_sd_runs_the_warmup_on_captions(sd_checkpoint):
    """``--dp=True`` without ``--prompt``: warmup seed i runs on caption
    i % 3, through ``gits_schedule(per_seed_cond=..., denoise_with_cond=...)``."""
    out = cli_sample.main(["--dataset_name=ms_coco", f"--model_path={sd_checkpoint}",
                           f"--guidance_rate={GUIDANCE}", "--dp=True", "--num_steps=3",
                           "--num_steps_tea=5", "--num_warmup=4", "--solver=euler",
                           "--solver_tea=euler", "--seeds=0-1", "--batch=2", "--device=cpu",
                           "--outdir=gits"])
    pre, _ = factory.create_model("ms_coco", sd_checkpoint, guidance_rate=GUIDANCE,
                                  device="cpu")
    ld = pre.latent_diffusion
    uc = ld.get_learned_conditioning([""])
    gcfg = GITSConfig(num_steps=3, num_steps_tea=5, num_warmup=4, solver_tea="euler",
                      solver="euler", schedule_type="discrete", schedule_rho=1.0, batch_size=2)
    dp_list, _, cost = gits_schedule(
        bind(pre, unconditional_condition=uc), (8, 8, 4), gcfg, device="cpu", return_cost=True,
        per_seed_cond=ld.get_learned_conditioning([CAPTIONS[i % 3] for i in range(4)]),
        denoise_with_cond=lambda x, t, c: pre(x, t, condition=c, unconditional_condition=uc))
    assert out["dp_list"] == dp_list and np.isfinite(cost).all()


def test_amed_trains_on_encoded_captions_drawn_as_jax_draws(sd_checkpoint, capsys):
    """With a bound text encoder and the captions file, AMED's context
    function encodes the captions the JAX one draws (the same RandomState
    draws, seen through a recording encoder on the JAX side), and the
    unconditional context is the empty prompt's; ``build_trainer`` takes
    the checkpoint and the captions and trains a step on them."""
    csv = os.path.join("models", "MS-COCO_val2014_30k_captions.csv")
    pre, _ = factory.create_model("ms_coco", sd_checkpoint, guidance_rate=GUIDANCE,
                                  device="cpu")
    ld = pre.latent_diffusion
    seen_t, seen_j = [], []
    real = ld.get_learned_conditioning

    def spy(texts):
        seen_t.append(list(texts))
        return real(texts)

    ld.get_learned_conditioning = spy

    class JaxLD:  # the JAX context sampler's view of a LatentDiffusion
        unet = ld.unet

        @staticmethod
        def cond_stage_fn(texts):
            raise AssertionError("the JAX sampler encodes through get_learned_conditioning")

        @staticmethod
        def get_learned_conditioning(texts):
            seen_j.append(list(texts))
            return np.zeros((len(texts), 77, CTX_DIM), np.float32)

    for batch, seed, it in ((4, 0, 0), (3, 9, 5)):
        got = TC.make_caption_context_fn(ld, csv, batch, seed, verbose=False)(it)
        JC.make_caption_context_fn(JaxLD, csv, batch, seed, verbose=False)(it)
        assert got.shape == (batch, 77, CTX_DIM) and got.dtype == np.float32
        np.testing.assert_array_equal(got, real(seen_t[-1]).numpy())
    uc = TC.make_uncond_context(ld, 2, GUIDANCE)
    JC.make_uncond_context(JaxLD, 2, GUIDANCE)
    assert seen_t == seen_j and seen_t[-1] == ["", ""] and len(set(map(tuple, seen_t))) == 3
    np.testing.assert_array_equal(uc, real(["", ""]).numpy())
    del ld.get_learned_conditioning

    cfg = cli_train.AMEDConfig(dataset_name="ms_coco", num_steps=2, batch=2, batch_gpu=2,
                               guidance_type="cfg", guidance_rate=GUIDANCE)
    module, cfg, _, step, context_fn = cli_train.build_trainer(cfg, sd_checkpoint, "cpu",
                                                               prompt_path=csv)
    assert "Loaded 3 captions" in capsys.readouterr().out
    assert module.latent_diffusion.cond_stage_model is not None
    metrics = step(stacked_randn([0, 1], (8, 8, 4), device="cpu"),
                   torch.from_numpy(context_fn(0)))
    assert math.isfinite(float(metrics["loss"]))


def test_sample_cli_amed_on_sd_binds_the_prompt_and_caption_contexts(sd_checkpoint):
    """``cli/sample.py --predictor`` on ``ms_coco`` samples on the contexts
    the plain path builds: with ``--prompt`` the prompt's, without it a
    caption per seed, and under guidance 7.5 the empty prompt's too, the
    batch doubled (``cfg_doubled``) as the trainer doubles it.  The PNGs are
    ``build_amed_sample_fn`` on ``get_learned_conditioning``'s contexts,
    decoded, byte for byte (5 seeds at batch 2).  Without an encoder
    (random weights) it raises."""
    pre, _ = factory.create_model("ms_coco", sd_checkpoint, guidance_rate=GUIDANCE,
                                  device="cpu")
    cfg = dataclasses.replace(
        cli_train.AMEDConfig(dataset_name="ms_coco", num_steps=3, guidance_type="cfg",
                             guidance_rate=GUIDANCE),
        sigma_min=float(pre.sigma_min), sigma_max=float(pre.sigma_max))
    os.makedirs("run")
    ckpt.save_config(os.path.join("run", "predictor_config.json"), cfg)
    pred = factory.init_params(cli_train.predictor_from_config(cfg, device="cpu"), seed=3)
    ckpt.save_params(os.path.join("run", "predictor.npz"), params_to_jax(pred.state_dict()))
    seeds = list(range(5))
    common = [f"--model_path={sd_checkpoint}", f"--guidance_rate={GUIDANCE}", "--predictor=run",
              "--seeds=0-4", "--batch=2", "--device=cpu"]
    cli_sample.main(["--dataset_name=ms_coco", "--prompt=a photo of the cat",
                     "--outdir=prompt", *common])
    cli_sample.main(["--dataset_name=ms_coco", "--outdir=captions", *common])
    ld = pre.latent_diffusion
    uc = ld.get_learned_conditioning([""])
    runs = {"prompt": dict(condition=ld.get_learned_conditioning(["a photo of the cat"])),
            "captions": dict(per_seed_cond=ld.get_learned_conditioning(
                [CAPTIONS[s % 3] for s in seeds]))}
    images = {}
    for name, kw in runs.items():
        rows = kw.pop("per_seed_cond", None)
        fn, _ = cli_sample.build_amed_sample_fn(pre, "run", "cpu", cfg_doubled=True,
                                                unconditional_condition=uc, **kw)
        latents = S.generate_batches(fn, seeds, (8, 8, 4), max_batch_size=2, device="cpu",
                                     per_seed_cond=rows)
        images[name] = S.to_uint8(ld.decode_in_chunks(latents))
        assert _pngs(name, seeds) == [encode_png(im) for im in images[name]], name
    assert (images["prompt"] != images["captions"]).any()
    assert (images["captions"][0] != images["captions"][3]).any()  # same caption, other seed
    with pytest.raises(ValueError, match="text encoder"):  # random weights have none
        cli_sample.main(["--dataset_name=ms_coco", "--predictor=run", "--device=cpu"])
