"""The port's latent-diffusion tier (LSUN-Bedroom / FFHQ LDM) against the JAX
package's.

A tiny stand-in for ``LDM_CONFIGS["lsun_bedroom_ldm"]`` (16x16x3 latents, 32
channels, mult [1, 2], one res block per level, legacy attention at 8x8 with
2 heads of 16; a VQ decoder of 32 channels to 32x32 images) is built by the
port's ``build_latent_diffusion`` with every weight redrawn at unit scale,
then handed to the JAX modules through the JAX package's own
``_mechanical`` (the reference state_dict names with '.' -> '_').  Inputs
are numpy draws handed to both sides.  f32 on the CPU, where the port's
GroupNorm and attention take their plain versions (kernels K3, K1 and K2 run
on the card).

Bounds: ``linear_alphas_cumprod``, the VQ quantisation and the param
conversion exact; ``interpolate_fn``, ``sigma`` and ``sigma_inv`` 2e-6
relative (both sides compute in f32, with other ``exp`` / ``log``); the
discrete t-steps 1e-5 relative; the U-Net, the decoder, D(x, sigma), the
pooled middle-block tap and the samplers 1e-4 * max (the U-Net parity bar);
one SGD AMED step: loss within 1e-4 relative, params within 5e-4 of the
step's largest move.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sampler_tpu.models import ldm as JL
from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.models.factory import _capture_middle_lazy
from diff_sampler_tpu.ops import get_schedule as jax_get_schedule
from diff_sampler_tpu.solvers import amed as JA
from diff_sampler_tpu.solvers import samplers as JS
from diff_sampler_tpu.training import amed as JT
from diff_sampler_tpu_torch import sampling as S
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed as cli_train
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.models.convert import load_jax_params, load_ldm_jax_params
from diff_sampler_tpu_torch.models.precond import CFGPrecond, bind, interpolate_fn
from diff_sampler_tpu_torch.ops import get_schedule
from diff_sampler_tpu_torch.solvers import amed as TA
from diff_sampler_tpu_torch.training import amed as TT
from diff_sampler_tpu_torch.utils import checkpoint as ckpt
from diff_sampler_tpu_torch.utils.image import encode_png
from diff_sampler_tpu_torch.utils.rng import stacked_randn

RES = 16
TINY = dict(
    linear_start=0.0015, linear_end=0.0195, timesteps=1000,
    scale_factor=1.0, conditioning_key=None, first_stage="vq",
    unet=dict(image_size=RES, in_channels=3, out_channels=3, model_channels=32,
              attention_resolutions=(2,), num_res_blocks=1, channel_mult=(1, 2),
              num_head_channels=16),
    vae=dict(z_channels=3, resolution=2 * RES, ch=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(16,)),
    n_embed=32, embed_dim=3)
# The CLIs' stand-in: 8x8 latents and one level (the middle block still pools
# to 64 predictor inputs), so a 1000-sample AMED iteration takes seconds.
TINY_CLI = dict(TINY, unet=dict(TINY["unet"], image_size=8, channel_mult=(1,),
                                attention_resolutions=(1,)),
                vae=dict(TINY["vae"], resolution=16, attn_resolutions=()))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU,
    where torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-4, what=""):
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


def _jax_trees(ld):
    """The JAX package's param trees of the port's LatentDiffusion."""
    pq = ld.first_stage.post_quant_conv
    return dict(unet=JL._mechanical(ld.unet.state_dict()),
                decoder=JL._mechanical(ld.first_stage.decoder.state_dict()),
                post_quant_conv={"kernel": pq.weight.detach().numpy().transpose(2, 3, 1, 0),
                                 "bias": pq.bias.detach().numpy()},
                codebook=ld.first_stage.codebook.detach().numpy().copy())


def _jax_precond(trees):
    """The JAX package's LSUN LDM denoiser over ``trees``: its
    ``build_ldm_model`` on the unconditional branch, less the random init."""
    ld = JL.build_latent_diffusion("lsun_bedroom_ldm", params_override=trees)
    bneck = _capture_middle_lazy(ld)
    pre = JP.CFGPrecond(model_fn=lambda x, t, cond: ld.apply_model(x, t, None),
                        alphas_cumprod=ld.alphas_cumprod, img_resolution=RES, img_channels=3,
                        guidance_type="uncond", guidance_rate=1.0, label_dim=0,
                        model_fn_bottleneck=lambda x, t, cond: bneck(x, t, None))
    pre.sigma_min = 0.006
    pre.latent_diffusion = ld
    return pre


@pytest.fixture(scope="module")
def tiers():
    """(the port's CFGPrecond from its factory, the JAX one, the JAX trees)
    over one set of weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", TINY)
        mp.setitem(JL.LDM_CONFIGS, "lsun_bedroom_ldm", TINY)
        pre_t, source = factory.create_model("lsun_bedroom_ldm", "random", device="cpu")
        assert source == "ldm"
        _redraw_unit_scale(pre_t.latent_diffusion, seed=0)
        trees = _jax_trees(pre_t.latent_diffusion)
        return pre_t, _jax_precond(trees), trees


def _latents(seed, n=2, res=RES):
    return np.random.RandomState(seed).randn(n, res, res, 3).astype(np.float32)


def test_linear_alphas_cumprod_is_exact():
    for start, end in ((0.0015, 0.0195), (0.00085, 0.0120)):
        np.testing.assert_array_equal(TL.linear_alphas_cumprod(start, end, 1000),
                                      JL.linear_alphas_cumprod(start, end, 1000))


def test_configs_match_the_jax_package():
    for name in ("lsun_bedroom_ldm", "ffhq_ldm"):
        assert TL.LDM_CONFIGS[name] == JL.LDM_CONFIGS[name]


def test_build_rejects_what_comes_with_the_sd_slice(monkeypatch):
    """The SD slice brought the crossattn conditioning key and the KL first
    stage (tests/test_torch_sd.py); what the port still does not build is
    refused, not ignored: the reference's other conditioning keys and any
    other first stage."""
    for change, what in ((dict(conditioning_key="concat"), "conditioning key 'concat'"),
                         (dict(conditioning_key="hybrid"), "conditioning key 'hybrid'"),
                         (dict(first_stage="vq_interface"), "first stage 'vq_interface'")):
        monkeypatch.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", dict(TINY, **change))
        with pytest.raises(NotImplementedError, match=what):
            TL.build_latent_diffusion("lsun_bedroom_ldm", device="cpu")


def test_full_width_lsun_unet_has_the_reference_params_and_16_attention_sites():
    """The full LSUN-Bedroom U-Net on the meta device: 274M parameters,
    named as the JAX init names them, and legacy attention at d=32 with 14,
    21 and 28 heads at 32x32, 16x16 and 8x8 (5, 5 and 6 sites)."""
    unet = TL.LDMUNet(device="meta", **TL.LDM_CONFIGS["lsun_bedroom_ldm"]["unet"])
    shapes = jax.eval_shape(JL.LDMUNet(**JL.LDM_CONFIGS["lsun_bedroom_ldm"]["unet"]).init,
                            jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.ones((1,)))["params"]
    got = JL._mechanical({k: np.zeros(v.shape, np.float32) for k, v in unet.state_dict().items()})
    assert jax.tree.map(np.shape, got) == jax.tree.map(lambda s: s.shape, shapes)
    assert 273e6 < sum(p.numel() for p in unet.parameters()) < 275e6
    heads = [m.num_heads for m in unet.modules() if isinstance(m, TL.AttentionBlock)]
    assert sorted(heads) == [14] * 5 + [21] * 5 + [28] * 6


def test_param_conversion_round_trips(tiers):
    """``load_ldm_jax_params`` puts the JAX trees back into a fresh stack,
    tensor for tensor."""
    pre_t, _, trees = tiers
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", TINY)
        fresh = TL.build_latent_diffusion("lsun_bedroom_ldm", seed=3, device="cpu")
    load_ldm_jax_params(fresh, trees)
    want = pre_t.latent_diffusion.state_dict()
    got = fresh.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    trees = dict(trees, unet={k: v for k, v in trees["unet"].items() if k != "out_2"})
    with pytest.raises(KeyError, match="out.2"):
        load_ldm_jax_params(fresh, trees)


def test_unet_and_bottleneck_match_jax(tiers):
    pre_t, pre_j, trees = tiers
    unet_j = pre_j.latent_diffusion.unet
    x = _latents(1) * 2.0
    t = np.array([5.0, 700.0], np.float32)
    out_j, bot_j = unet_j.apply({"params": trees["unet"]}, jnp.asarray(x), jnp.asarray(t),
                                return_bottleneck=True)
    with torch.no_grad():
        out_t, bot_t = pre_t.latent_diffusion.unet(torch.from_numpy(x), torch.from_numpy(t),
                                                   return_bottleneck=True)
    assert bot_t.shape == (2, 8, 8, 64)
    _close(out_t.numpy(), out_j, what="eps")
    _close(bot_t.numpy(), bot_j, what="middle block")


def test_vq_quantize_and_decode_match_jax(tiers):
    pre_t, pre_j, _ = tiers
    z = _latents(2) * 1.5
    first_t, first_j = pre_t.latent_diffusion.first_stage, pre_j.latent_diffusion.first_stage
    with torch.no_grad():
        q_t = first_t.quantize(torch.from_numpy(z)).numpy()
        img_t = pre_t.latent_diffusion.decode_first_stage(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(q_t, np.asarray(first_j.quantize(jnp.asarray(z))))
    assert len(np.unique(q_t.reshape(-1, 3), axis=0)) > 4  # many codes are hit
    assert img_t.shape == (2, 2 * RES, 2 * RES, 3)
    _close(img_t, pre_j.latent_diffusion.decode_first_stage(jnp.asarray(z)), what="decode")
    _close(pre_t.latent_diffusion.decode_in_chunks(z, chunk=1), img_t, what="one at a time")


def test_decoder_with_attention_levels_matches_jax():
    """A decoder with attention in its up levels too (the LSUN config has
    none there, only in its middle)."""
    kw = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
              resolution=16, z_channels=3)
    dec = factory.init_params(TL.VAEDecoder(device="cpu", **kw))
    _redraw_unit_scale(dec, seed=4)
    assert len(dec.up[1]["attn"]) == 2
    z = _latents(5, res=8)
    want = JL.VAEDecoder(**kw).apply({"params": JL._mechanical(dec.state_dict())}, jnp.asarray(z))
    with torch.no_grad():
        _close(dec(torch.from_numpy(z)).numpy(), want)


def test_interpolate_fn_matches_jax():
    rng = np.random.RandomState(6)
    xp = np.sort(rng.randn(12)).astype(np.float32)
    xp[5] = xp[4]  # a zero-width segment
    yp = rng.randn(12).astype(np.float32)
    x = np.concatenate([rng.randn(40) * 2, xp[[0, 4, 11]], [-9.0, 9.0]]).astype(np.float32)
    got = interpolate_fn(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(yp))
    want = JP.interpolate_fn(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(yp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


def test_sigma_maps_and_discrete_schedule_match_jax(tiers):
    pre_t, pre_j, _ = tiers
    assert pre_t.sigma_min == pre_j.sigma_min == 0.006
    np.testing.assert_allclose(pre_t.sigma_max, pre_j.sigma_max, rtol=2e-6)
    t = np.array([1e-3, 0.01, 0.37, 0.5, 0.999, 1.0], np.float32)
    sig = np.array([0.006, 0.05, 1.0, 7.5, pre_j.sigma_max], np.float32)
    for name, arg in (("sigma", t), ("sigma_inv", sig)):
        want = np.asarray(getattr(pre_j, name)(jnp.asarray(arg)))
        np.testing.assert_allclose(getattr(pre_t, name)(arg), want, rtol=2e-6, err_msg=name)
        got = getattr(pre_t, name)(torch.from_numpy(arg))  # a tensor keeps its type
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, err_msg=name)
    for steps, rho in ((4, 1.0), (6, 1.0), (5, 7.0)):
        got = get_schedule(steps, pre_t.sigma_min, pre_t.sigma_max, "discrete", rho,
                           sigma_fn=pre_t.sigma, sigma_inv_fn=pre_t.sigma_inv)
        want = jax_get_schedule(steps, pre_j.sigma_min, pre_j.sigma_max, "discrete", rho,
                                sigma_fn=pre_j.sigma, sigma_inv_fn=pre_j.sigma_inv)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_uncond_denoiser_matches_jax(tiers):
    pre_t, pre_j, _ = tiers
    x = _latents(7) * np.array([60.0, 0.5], np.float32)[:, None, None, None]
    s = np.array([60.0, 0.5], np.float32)
    want = pre_j(jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        got = pre_t(torch.from_numpy(x), torch.from_numpy(s))
        one = pre_t(torch.from_numpy(x[:1]), 60.0)  # a scalar sigma broadcasts
    _close(got.numpy(), want)
    _close(one.numpy(), np.asarray(want)[:1])
    assert np.abs(got.numpy() - x).max() > 0.1  # the net shows


def _analytic_eps(tanh):
    """A conditional eps model on both sides: tanh(x) * cond + t / 1000."""
    def fn(x, t, c):
        return tanh(x) * c[:, None, None, :] + t[:, None, None, None] / 1000.0
    return fn


@pytest.mark.parametrize("guidance_rate", [1.0, 3.5])
def test_classifier_free_denoiser_matches_jax(guidance_rate):
    """The classifier-free branch: one bound conditioning row broadcast to
    the batch, and a doubled batch (uncond, cond) when the rate is not 1."""
    alphas = TL.linear_alphas_cumprod(0.00085, 0.0120, 1000)
    kw = dict(alphas_cumprod=alphas, img_resolution=RES, img_channels=3,
              guidance_type="classifier-free", guidance_rate=guidance_rate)
    pre_t = CFGPrecond(model_fn=_analytic_eps(torch.tanh), **kw)
    pre_j = JP.CFGPrecond(model_fn=_analytic_eps(jnp.tanh), **kw)
    rng = np.random.RandomState(8)
    x = (rng.randn(3, 4, 4, 3) * 5).astype(np.float32)
    s = np.array([14.0, 2.0, 0.1], np.float32)
    cond, uncond = rng.randn(1, 3).astype(np.float32), rng.randn(1, 3).astype(np.float32)
    want = pre_j(jnp.asarray(x), jnp.asarray(s), jnp.asarray(cond), jnp.asarray(uncond))
    got = pre_t(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(cond),
                torch.from_numpy(uncond))
    _close(got.numpy(), want, rel=1e-5)
    den = bind(pre_t, condition=torch.from_numpy(cond),
               unconditional_condition=torch.from_numpy(uncond))
    assert torch.equal(den(torch.from_numpy(x), torch.from_numpy(s)), got)


def test_generate_on_the_discrete_schedule_matches_jax(tiers):
    """The slice as a whole: ``generate`` with ipndm on the discrete
    schedule (rho 1) over the tiny LDM, and the JAX sampler on the same
    per-seed latents."""
    pre_t, pre_j, _ = tiers
    seeds = [3, 1, 4]
    cfg = S.SolverConfig(solver="ipndm", num_steps=4, schedule_type="discrete",
                         schedule_rho=1.0)
    den = bind(pre_t)
    assert (den.sigma_fn, den.sigma_inv_fn) == (pre_t.sigma, pre_t.sigma_inv)
    got = S.generate(den, seeds, (RES, RES, 3), cfg, max_batch_size=2, device="cpu")
    lat = stacked_randn(seeds, (RES, RES, 3), device="cpu").numpy()
    t_steps = jax_get_schedule(4, pre_j.sigma_min, pre_j.sigma_max, "discrete", 1.0,
                               sigma_fn=pre_j.sigma, sigma_inv_fn=pre_j.sigma_inv)
    den_j = JP.bind(pre_j)
    want = jax.jit(lambda z: JS.get_sampler("ipndm")(den_j, z, t_steps).x)(jnp.asarray(lat))
    _close(got, want)


def test_amed_bottleneck_and_train_step_match_jax(tiers):
    """The middle-block tap pooled over channels, then one AMED trajectory
    (discrete schedule, student amed, teacher euler, M=1, as
    tests/test_amed_tiers.py trains the JAX LDM tier) with SGD(0.1) on both
    sides: the update is linear in the predictor's gradient."""
    pre_t, pre_j, _ = tiers
    assert TA.bottleneck_module_name(0, RES, "ldm") == "middle_block"
    den_t, den_j = TA.bind_with_bottleneck(pre_t), JA.bind_with_bottleneck(pre_j)
    assert not any(p.requires_grad for p in pre_t.latent_diffusion.parameters())
    x = _latents(9) * 3.0
    s = np.array([3.0, 0.2], np.float32)
    d_j, b_j = jax.jit(den_j.fn)(jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        d_t, b_t = den_t.with_bottleneck(torch.from_numpy(x), torch.from_numpy(s))
    assert b_t.shape == (2, 64)
    _close(d_t.numpy(), d_j, what="D")
    _close(b_t.numpy(), b_j, what="pooled tap")

    cfg = TT.AMEDConfig(dataset_name="lsun_bedroom_ldm", num_steps=3, M=1, sampler_stu="amed",
                        sampler_tea="euler", schedule_type="discrete", schedule_rho=1.0,
                        sigma_min=pre_t.sigma_min, sigma_max=pre_t.sigma_max)
    cfg_j = JT.AMEDConfig(**{k: getattr(cfg, k) for k in JT.AMEDConfig.__dataclass_fields__
                             if hasattr(cfg, k)})
    pred_j = JA.AMEDPredictor(scale_dir=cfg.scale_dir, scale_time=cfg.scale_time)
    p0 = jax.tree.map(np.asarray, pred_j.init(jax.random.key(3), jnp.zeros((2, 64)),
                                              jnp.asarray(1.0), jnp.asarray(0.5))["params"])
    pred_t = load_jax_params(TA.AMEDPredictor(scale_dir=cfg.scale_dir,
                                              scale_time=cfg.scale_time), p0)
    lat = _latents(10)
    opt = optax.sgd(0.1)
    new, _, metrics = jax.jit(JT.make_amed_train_step(
        pred_j, den_j, cfg_j, opt, sigma_fn=pre_j.sigma, sigma_inv_fn=pre_j.sigma_inv))(
        p0, opt.init(p0), jnp.asarray(lat))
    step = TT.make_amed_train_step(pred_t, den_t, cfg, torch.optim.SGD(pred_t.parameters(),
                                                                       lr=0.1))
    loss_t, loss_j = float(step(torch.from_numpy(lat))["loss"]), float(metrics["loss"])
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


@pytest.fixture
def tiny_cli(monkeypatch, tmp_path):
    monkeypatch.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", TINY_CLI)
    monkeypatch.chdir(tmp_path)


def _pngs_equal(outdir, seeds, images):
    for i, seed in enumerate(seeds):
        with open(os.path.join(outdir, "000000", f"{seed:06d}.png"), "rb") as f:
            assert f.read() == encode_png(images[i]), seed


def test_sample_cli_decodes_latents_on_the_discrete_schedule(tiny_cli, capsys):
    cli_sample.main(["--dataset_name=lsun_bedroom_ldm", "--model_path=random",
                     "--solver=euler", "--num_steps=3", "--seeds=0-2", "--batch=2",
                     "--device=cpu", "--outdir=out"])
    out = capsys.readouterr().out
    assert "schedule: discrete(rho=1.0) | source: ldm" in out and "16x16, decoded" in out
    pre, _ = factory.create_model("lsun_bedroom_ldm", "random", device="cpu")
    lat = S.generate(bind(pre), [0, 1, 2], (8, 8, 3),
                     S.SolverConfig(solver="euler", num_steps=3, schedule_type="discrete",
                                    schedule_rho=1.0), device="cpu")
    images = pre.latent_diffusion.decode_in_chunks(lat)
    assert images.shape == (3, 16, 16, 3)
    _pngs_equal("out", [0, 1, 2], S.to_uint8(images))


def test_ldm_trains_and_samples_through_the_amed_clis(tiny_cli, capsys):
    """train_amed on the latent tier (the sidecar holds the LDM's sigma
    range), then sample --predictor, whose PNGs are the AMED sampler's
    latents through the VQ decoder."""
    run = cli_train.main(["--dataset_name=lsun_bedroom_ldm", "--model_path=random",
                          "--batch=1000", "--num_steps=3", "--total_kimg=1", "--afs=True",
                          "--device=cpu", "--outdir=exps"])
    assert os.path.basename(run) == "00000-lsun_bedroom_ldm-3-3-amed-heun"
    cfg = cli_train.AMEDConfig(**ckpt.load_config(os.path.join(run, "predictor_config.json")))
    pre, _ = factory.create_model("lsun_bedroom_ldm", "random", device="cpu")
    assert (cfg.sigma_min, cfg.sigma_max) == (0.006, pre.sigma_max)

    cli_sample.main(["--dataset_name=lsun_bedroom_ldm", f"--predictor={run}",
                     "--seeds=0-2", "--device=cpu", "--outdir=amed"])
    assert "student=amed steps=3 NFE=3" in capsys.readouterr().out
    pred = load_jax_params(cli_train.predictor_from_config(cfg),
                           ckpt.load_params(os.path.join(run, "predictor.npz"))["params"])
    t_steps = get_schedule(3, cfg.sigma_min, cfg.sigma_max, "polynomial", 7.0)
    with torch.no_grad():
        lat = TA.amed_sampler(TA.bind_with_bottleneck(pre), pred.eval(),
                              stacked_randn([0, 1, 2], (8, 8, 3), device="cpu"), t_steps,
                              afs=True).x
    _pngs_equal("amed", [0, 1, 2], S.to_uint8(pre.latent_diffusion.decode_in_chunks(lat.numpy())))
