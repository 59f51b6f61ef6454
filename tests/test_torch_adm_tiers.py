"""The 256 px pixel tiers through the port's sampling and AMED paths against
the JAX package's: ``generate`` with integer labels, one AMED training step
of the consistency-models tier and one of the classifier-guided tier, and
both CLIs on ``lsun_bedroom``, ``lsun_cat`` and ``imagenet256``.

The nets are the tiny stand-ins of ``test_torch_adm.py`` with unit-scale
weights from a numpy seed; the CLIs run on a smaller stand-in (8x8 images,
one level, so a 1000-trajectory AMED iteration takes seconds).  Both
packages sample on the port's per-seed latents and labels (the JAX
package's generators draw others).  f32 on the CPU, where the port's
attention is its plain version, which autograd differentiates twice: the
classifier-guided AMED step carries the second-order term through the
classifier's gradient on both sides.

Bounds: the classifier's second derivative 1e-4 * max; CM's samples
1e-5 * max; CG's 1e-5 * sigma_max * max (an f32
difference in eps reaches D = clamp(x - sigma * eps) sigma-fold, and the
first step from sigma_max = 157 hands D's difference on to the sample);
one SGD AMED step: loss within 1e-4 relative, each layer's params within
5e-4 of the step's largest move.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sampler_tpu import sampling as JSAMP
from diff_sampler_tpu.models import adm as JADM
from diff_sampler_tpu.models.factory import _capture_middle
from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.solvers import amed as JA
from diff_sampler_tpu.training import amed as JT
from diff_sampler_tpu.utils import rng as JRNG
from diff_sampler_tpu_torch import sampling as S
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed as cli_train
from diff_sampler_tpu_torch.models import adm as TADM
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models.convert import load_jax_params, params_to_jax
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.ops import get_schedule
from diff_sampler_tpu_torch.solvers import amed as TA
from diff_sampler_tpu_torch.training import amed as TT
from diff_sampler_tpu_torch.utils import checkpoint as ckpt
from diff_sampler_tpu_torch.utils.image import encode_png
from diff_sampler_tpu_torch.utils.rng import stacked_randint, stacked_randn
from test_torch_adm import (RES, TINY_ADM, TINY_CLASSIFIER, TINY_CM, _as_jax_arrays,
                            port_and_jax)

# The CLIs' stand-ins: one 8x8 level (the middle block still pools to 64
# predictor inputs), the classifier's pool over 65 tokens
TINY_CLI = dict(TINY_CM, image_size=8, channel_mult=(1,), attention_resolutions=(1,))
TINY_CLI_ADM = dict(TINY_ADM, image_size=8, channel_mult=(1,), attention_resolutions=(1,))
TINY_CLI_CLASSIFIER = dict(TINY_CLASSIFIER, image_size=8, channel_mult=(1,),
                           attention_resolutions=(1,))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _cm_pair(setting, seed):
    """(the port's CMPrecond from its factory on ``setting``, the JAX
    package's over the same weights: ``test_torch_adm.port_and_jax``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(factory, "CM_LSUN_SETTING", setting)
        pre_t, _ = factory.create_model("lsun_bedroom", "random", device="cpu")
    params = port_and_jax(pre_t.net, seed=seed)[1]
    _as_jax_arrays(params)
    net = JADM.ADMUNet(**setting)
    pre_j = JP.CMPrecond(model_fn=lambda x, t, y: net.apply({"params": params}, x, t, None),
                         img_resolution=setting["image_size"], img_channels=3, label_dim=0,
                         model_fn_bottleneck=_capture_middle(net, params))
    return pre_t, pre_j


@pytest.fixture(scope="module")
def tiers():
    """{"cm": (port CMPrecond, JAX CMPrecond), "adm": (port CGPrecond, JAX
    CGPrecond)} over one set of weights each: the port's factory on the
    tiny settings, its nets loaded through ``test_torch_adm.port_and_jax``,
    the JAX preconditioners over the same params."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(factory, "IMAGENET256_SETTING", TINY_ADM)
        mp.setattr(factory, "IMAGENET256_CLASSIFIER_SETTING", TINY_CLASSIFIER)
        cg_t, _ = factory.create_model("imagenet256", "random", guidance_rate=2.0, device="cpu")
    p_net, p_cls = port_and_jax(cg_t.net, seed=12)[1], port_and_jax(cg_t.classifier, seed=13)[1]
    for tree in (p_net, p_cls):
        _as_jax_arrays(tree)
    net, cls = JADM.ADMUNet(**TINY_ADM), JADM.ADMClassifier(**TINY_CLASSIFIER)
    cg_j = JP.CGPrecond(model_fn=lambda x, t, y: net.apply({"params": p_net}, x, t, y),
                        classifier_fn=lambda x, t: cls.apply({"params": p_cls}, x, t),
                        img_resolution=RES, img_channels=3, label_dim=7, guidance_rate=2.0,
                        model_fn_bottleneck=_capture_middle(net, p_net))
    return {"cm": _cm_pair(TINY_CM, seed=11), "adm": (cg_t, cg_j)}


@pytest.fixture
def port_draws(monkeypatch):
    """The JAX package's ``generate`` on the port's per-seed latents and
    labels."""
    monkeypatch.setattr(JSAMP, "stacked_randn", lambda seeds, shape, *a: jnp.asarray(
        stacked_randn(np.asarray(seeds).tolist(), shape, device="cpu").numpy()))
    monkeypatch.setattr(JRNG, "stacked_randint", lambda seeds, shape, lo, hi: jnp.asarray(
        stacked_randint(np.asarray(seeds).tolist(), shape, lo, hi, device="cpu").numpy()))


@pytest.mark.parametrize("tier", ["cm", "adm"])
def test_generate_matches_jax(tiers, tier, port_draws):
    """``generate`` (euler, NFE 2, poly-7) at two batch splits against the
    JAX package's ``generate``; the classifier-guided tier draws an integer
    label per seed (``label_kind="int"``), the same class for a seed at any
    split, and ``class_idx`` pins one."""
    pre_t, pre_j = tiers[tier]
    seeds = [5, 2, 9]
    cfg = S.SolverConfig(solver="euler", num_steps=3)
    kw = dict(label_dim=7, label_kind="int") if tier == "adm" else {}
    seen = []
    den = bind(pre_t)
    spy = S.BoundDenoiser(lambda x, t, y=None: seen.append(y) or den(x, t, y),
                          den.sigma_min, den.sigma_max)
    full = S.generate(spy, seeds, (RES, RES, 3), cfg, max_batch_size=3, device="cpu", **kw)
    split = S.generate(spy, seeds, (RES, RES, 3), cfg, max_batch_size=2, device="cpu", **kw)
    np.testing.assert_array_equal(split, full)
    jcfg = JSAMP.SolverConfig(solver="euler", num_steps=3)
    jkw = (dict(label_dim=7, label_kind="int",
                denoise_with_labels=lambda x, t, y: pre_j(x, t, class_labels=y))
           if tier == "adm" else {})
    want = JSAMP.generate(JP.bind(pre_j), seeds, (RES, RES, 3), jcfg, max_batch_size=2, **jkw)
    # CG: an f32 difference in eps reaches D sigma-fold, and the first step
    # from sigma_max (157) hands D's difference on to the sample
    _close(full, want, rel=1e-5 * (pre_t.sigma_max if tier == "adm" else 1.0), what=tier)
    if tier == "cm":
        assert seen == [None] * 6
        return
    classes = stacked_randint(seeds, (), 0, 7, device="cpu")
    assert all(y.dtype == torch.int64 for y in seen)
    assert torch.equal(seen[0], classes)  # batch 3, then batches of 2 (the last padded)
    assert torch.equal(torch.cat([seen[2], seen[4][:1]]), classes)
    assert torch.equal(seen[4], classes[2:].repeat(2))
    pinned = S.generate(spy, seeds, (RES, RES, 3), cfg, max_batch_size=3, device="cpu",
                        label_dim=7, label_kind="int", class_idx=4)
    assert (seen[-1] == 4).all() and not np.array_equal(pinned, full)


def _sgd_step_parity(den_t, den_j, cfg, lat, cond=None, factory_t=None, factory_j=None):
    """One SGD(0.1) AMED trajectory on both sides from the same predictor:
    the losses and the updated params."""
    cfg_j = JT.AMEDConfig(**{k: getattr(cfg, k) for k in JT.AMEDConfig.__dataclass_fields__
                             if hasattr(cfg, k)})
    pred_j = JA.AMEDPredictor(scale_dir=cfg.scale_dir, scale_time=cfg.scale_time)
    p0 = jax.tree.map(np.asarray, pred_j.init(jax.random.key(3), jnp.zeros((2, 64)),
                                              jnp.asarray(1.0), jnp.asarray(0.5))["params"])
    pred_t = load_jax_params(TA.AMEDPredictor(scale_dir=cfg.scale_dir,
                                              scale_time=cfg.scale_time), p0)
    opt = optax.sgd(0.1)
    args = () if cond is None else (jnp.asarray(cond),)
    new, _, metrics = jax.jit(JT.make_amed_train_step(
        pred_j, den_j, cfg_j, opt, denoise_factory=factory_j))(
        p0, opt.init(p0), jnp.asarray(lat), *args)
    step = TT.make_amed_train_step(pred_t, den_t, cfg, torch.optim.SGD(pred_t.parameters(),
                                                                       lr=0.1),
                                   denoise_factory=factory_t)
    loss_t = float(step(torch.from_numpy(lat), *(() if cond is None
                                                 else (torch.from_numpy(cond),)))["loss"])
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


def _amed_cfg(pre, num_steps=3):
    return TT.AMEDConfig(num_steps=num_steps, M=1, sampler_stu="amed", sampler_tea="euler",
                         sigma_min=pre.sigma_min, sigma_max=pre.sigma_max)


def test_cm_amed_step_matches_jax():
    """The middle-block tap pooled over channels, then one AMED trajectory
    of one segment (student amed, teacher euler, M=1) on both sides, on the
    CLIs' one-level 8x8 stand-in."""
    pre_t, pre_j = _cm_pair(TINY_CLI, seed=14)
    den_t, den_j = TA.bind_with_bottleneck(pre_t), JA.bind_with_bottleneck(pre_j)
    assert not any(p.requires_grad for p in pre_t.net.parameters())
    x = np.random.RandomState(20).randn(2, 8, 8, 3).astype(np.float32) * 3.0
    s = np.array([3.0, 0.2], np.float32)
    d_j, b_j = jax.jit(den_j.fn)(jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        d_t, b_t = den_t.with_bottleneck(torch.from_numpy(x), torch.from_numpy(s))
    assert b_t.shape == (2, 64)
    _close(d_t.numpy(), d_j, what="D")
    _close(b_t.numpy(), b_j, what="pooled tap")
    lat = np.random.RandomState(21).randn(2, 8, 8, 3).astype(np.float32)
    _sgd_step_parity(den_t, den_j, _amed_cfg(pre_t, num_steps=2), lat)


@pytest.mark.slow
def test_cg_amed_step_matches_jax(tiers):
    """One AMED trajectory through the classifier-guided tier, its labels
    bound per microbatch through ``denoise_factory``: the student's loss is
    differentiated through the classifier's gradient, a second-order
    derivative that the plain attention carries on the CPU on both sides.
    One segment (two knots): a second segment would start from the first
    one's update, and through the clamp of D the two sides' f32 differences
    grow there to 5e-4 of the move."""
    pre_t, pre_j = tiers["adm"]
    lat = np.random.RandomState(22).randn(2, RES, RES, 3).astype(np.float32)
    labels = np.array([6, 1])
    _sgd_step_parity(None, None, _amed_cfg(pre_t, num_steps=2), lat, cond=labels,
                     factory_t=lambda y: TA.bind_with_bottleneck(pre_t, class_labels=y),
                     factory_j=lambda y: JA.bind_with_bottleneck(pre_j, class_labels=y))


def test_cg_gradient_keeps_its_graph_only_for_a_differentiating_caller(tiers):
    """Under ``torch.no_grad`` (every sampler) the class-score gradient is
    taken all the same and comes back without a graph.  With an input that
    needs a gradient it keeps its graph: d sum(grad log p(y | x)) / dx, a
    second derivative through the classifier and its attention's recorded
    backward, against ``jax.grad`` of the JAX package's ``_cond_grad`` at
    1e-4 of its max (a gradient's bar; 1.6e-5 measured on one CPU, where
    the attention backward's plain pieces, which leave out the lse's
    dependence on q and k, were 50% off); and d sum(D) / dx differs from the same with the
    classifier's gradient held constant."""
    pre_t, pre_j = tiers["adm"]
    x = np.random.RandomState(23).randn(2, RES, RES, 3).astype(np.float32)
    s, y, t = np.array([0.8, 0.5], np.float32), np.array([3, 0]), np.array([300.0, 200.0])
    with torch.no_grad():
        d = pre_t(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(y))
    assert not d.requires_grad and d.grad_fn is None
    want = jax.jit(jax.grad(lambda x: pre_j._cond_grad(
        x, jnp.asarray(t, jnp.float32), jnp.asarray(y)).sum()))(jnp.asarray(x))
    xv = torch.from_numpy(x).requires_grad_()
    pre_t._cond_grad(xv, torch.from_numpy(t).float(), torch.from_numpy(y)).sum().backward()
    _close(xv.grad.numpy(), want, rel=1e-4, what="second derivative")

    def grad_of_d(detach_guidance):
        xv = torch.from_numpy(x).requires_grad_()
        real = pre_t._cond_grad
        if detach_guidance:
            pre_t._cond_grad = lambda *a: real(*a).detach()
        try:
            pre_t(xv, torch.from_numpy(s), torch.from_numpy(y)).sum().backward()
        finally:
            pre_t._cond_grad = real
        return xv.grad

    full, first_order = grad_of_d(False), grad_of_d(True)
    assert torch.isfinite(full).all()
    assert (full - first_order).abs().max() > 1e-3 * full.abs().max()


@pytest.fixture
def tiny_cli(monkeypatch, tmp_path):
    monkeypatch.setattr(factory, "CM_LSUN_SETTING", TINY_CLI)
    monkeypatch.setattr(factory, "IMAGENET256_SETTING", TINY_CLI_ADM)
    monkeypatch.setattr(factory, "IMAGENET256_CLASSIFIER_SETTING", TINY_CLI_CLASSIFIER)
    monkeypatch.chdir(tmp_path)


def _pngs_equal(outdir, seeds, images):
    for i, seed in enumerate(seeds):
        with open(os.path.join(outdir, "000000", f"{seed:06d}.png"), "rb") as f:
            assert f.read() == encode_png(images[i]), seed


def test_sample_cli_on_imagenet256_writes_generates_images(tiny_cli, monkeypatch, capsys):
    """cli.sample --dataset_name=imagenet256 --guidance_type=cg: one integer
    label per seed, the PNGs byte for byte ``generate``'s images on the
    same net; ``cg`` is refused off imagenet256."""
    seeds = [0, 1, 2]
    asked = []
    real = cli_sample.generate
    monkeypatch.setattr(cli_sample, "generate", lambda *a, **kw: asked.append(
        (kw["label_dim"], kw["label_kind"])) or real(*a, **kw))
    cli_sample.main(["--dataset_name=imagenet256", "--model_path=random", "--guidance_type=cg",
                     "--guidance_rate=2.0", "--solver=euler", "--num_steps=3", "--seeds=0-2",
                     "--batch=2", "--device=cpu", "--outdir=out"])
    assert "source: adm" in capsys.readouterr().out and asked == [(7, "int")]
    pre, _ = factory.create_model("imagenet256", "random", guidance_rate=2.0, device="cpu")
    images = S.generate(bind(pre), seeds, (8, 8, 3), S.SolverConfig(solver="euler", num_steps=3),
                        max_batch_size=2, device="cpu", label_dim=7, label_kind="int")
    _pngs_equal("out", seeds, S.to_uint8(images))
    for name in ("lsun_bedroom", "cifar10"):
        with pytest.raises(NotImplementedError, match="cg applies to imagenet256"):
            cli_sample.main([f"--dataset_name={name}", "--guidance_type=cg", "--device=cpu"])


@pytest.mark.parametrize("name", ["lsun_bedroom", "lsun_cat", "imagenet256"])
def test_train_amed_dry_run_accepts_the_256_px_tiers(name, capsys, tmp_path):
    cli_train.main([f"--dataset_name={name}", "-n", f"--outdir={tmp_path}"])
    assert f'"dataset_name": "{name}"' in capsys.readouterr().out
    assert not os.listdir(tmp_path)


def _sample_predictor_pngs(name, model, run, cfg, pre, cond):
    """cli.sample --predictor on seeds 0-2: its PNGs are the AMED sampler's
    images over ``pre`` bound with ``cond``."""
    cli_sample.main([f"--dataset_name={name}", *model, f"--predictor={run}", "--seeds=0-2",
                     "--device=cpu", "--outdir=amed"])
    pred = load_jax_params(cli_train.predictor_from_config(cfg),
                           ckpt.load_params(os.path.join(run, "predictor.npz"))["params"])
    t_steps = get_schedule(cfg.num_steps, cfg.sigma_min, cfg.sigma_max, "polynomial", 7.0)
    with torch.no_grad():
        x = TA.amed_sampler(TA.bind_with_bottleneck(pre, **cond), pred.eval(),
                            stacked_randn([0, 1, 2], (8, 8, 3), device="cpu"), t_steps,
                            afs=cfg.afs).x
    _pngs_equal("amed", [0, 1, 2], S.to_uint8(x.numpy()))


def test_lsun_cat_trains_and_samples_through_the_amed_clis(tiny_cli, capsys):
    """train_amed on lsun_cat from a reference file (it has no zoo file),
    then sample --predictor."""
    torch.save(TADM.reference_state_dict(factory.create_model(
        "lsun_bedroom", "random", device="cpu")[0].net), "cat.pt")
    model = ["--model_path=cat.pt"]
    run = cli_train.main(["--dataset_name=lsun_cat", *model, "--batch=1000", "--num_steps=2",
                          "--total_kimg=1", "--device=cpu", "--outdir=exps"])
    assert os.path.basename(run) == "00000-lsun_cat-2-2-amed-heun"
    cfg = cli_train.AMEDConfig(**ckpt.load_config(os.path.join(run, "predictor_config.json")))
    pre, _ = factory.create_model("lsun_cat", "cat.pt", device="cpu")
    assert (cfg.sigma_min, cfg.sigma_max) == (pre.sigma_min, pre.sigma_max)
    _sample_predictor_pngs("lsun_cat", model, run, cfg, pre, {})
    assert "student=amed steps=2 NFE=2" in capsys.readouterr().out


def test_imagenet256_trainer_draws_a_label_per_trajectory(tiny_cli, capsys):
    """``train_amed.build_trainer`` on imagenet256: the conditioning of
    iteration i is ``stacked_randint`` of its trajectories' seeds, and one
    step with it trains the predictor through classifier guidance; a run
    directory of it samples through cli.sample --predictor on each seed's
    integer label."""
    cfg = cli_train.AMEDConfig(dataset_name="imagenet256", num_steps=2, batch=4,
                               guidance_type="cg", guidance_rate=2.0)
    pre, cfg, pred, step, label_fn = cli_train.build_trainer(cfg, "random", "cpu", seed=10)
    assert (cfg.sigma_min, cfg.sigma_max) == (pre.sigma_min, pre.sigma_max)
    assert torch.equal(label_fn(1), stacked_randint([14, 15, 16, 17], (), 0, 7, device="cpu"))
    before = {k: v.clone() for k, v in pred.state_dict().items()}
    metrics = step(stacked_randn([10, 11, 12, 13], (8, 8, 3), device="cpu"), label_fn(0))
    assert math.isfinite(float(metrics["loss"]))
    assert any((pred.state_dict()[k] - v).abs().max() > 0 for k, v in before.items())
    run = ckpt.create_run_dir("exps", "imagenet256")
    ckpt.save_config(os.path.join(run, "predictor_config.json"), cfg)
    ckpt.save_params(os.path.join(run, "predictor.npz"), params_to_jax(pred.state_dict()))
    _sample_predictor_pngs("imagenet256", ["--guidance_rate=2.0"], run, cfg, pre,
                           dict(class_labels=stacked_randint([0, 1, 2], (), 0, 7, device="cpu")))
