"""The port's AMED predictor, samplers and trainer against the JAX package's.

One tiny EDM SongUNet (16x16, 16 channels, mult [1, 2], 4 blocks per level,
attention at 8x8: the net of tests/test_amed.py) is built on both sides from
one set of weights: the port's seeded init with every weight redrawn at unit
scale, so that the zero-init output convs do not hide the net (and its
attention) from the outputs and from the gradients.  The latents
are one numpy draw handed to both sides.  f32 on the CPU, where the port's
attention takes its plain version (kernels K1/K2 are checked on the card).
Bounds: predictor 1e-6; the bottleneck tap and the sampler outputs
1e-4 * max|x| (the U-Net parity bar); the net's gradient by x, sigma and the
qkv weights 1e-4 of each one's max; one SGD training step: loss within 1e-4
relative, params within 1e-3, while the step moves them by over 1.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.ops import get_schedule
from diff_sampler_tpu.solvers import amed as JA
from diff_sampler_tpu.training import amed as JT
from diff_sampler_tpu_torch.models.convert import load_jax_params, params_to_jax
from diff_sampler_tpu_torch.models.factory import init_params
from diff_sampler_tpu_torch.models.precond import EDMPrecond
from diff_sampler_tpu_torch.solvers import amed as TA
from diff_sampler_tpu_torch.training import amed as TT

RES, CH = 16, 3
UNET_KW = dict(model_channels=16, channel_mult=[1, 2], num_blocks=4, attn_resolutions=[8],
               dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU,
    where torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rescaled(params, seed, gain=1.0):
    rng = np.random.RandomState(seed)

    def draw(a):
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        return (gain * rng.randn(*a.shape) / math.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, params)


def _unit_port():
    """The port's net: its seeded init, every weight redrawn at unit scale."""
    port = init_params(EDMPrecond(img_resolution=RES, img_channels=CH,
                                  model_kwargs=UNET_KW).eval(), seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for p in port.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                    / math.sqrt(fan_in))
    return port


def _jax_net():
    return JP.EDMPrecond(img_resolution=RES, img_channels=CH, label_dim=0,
                         model_type="SongUNet", model_kwargs=UNET_KW)


@pytest.fixture(scope="module")
def unit_nets():
    """(JAX BottleneckDenoiser with jitted calls, the port's) over one set of
    weights, ``_unit_port``'s."""
    port = _unit_port()
    den = JA.bind_with_bottleneck(_jax_net(), params_to_jax(port.state_dict()),
                                  JA.bottleneck_module_name(0, RES))
    den_j = JA.BottleneckDenoiser(jax.jit(den.fn), jax.jit(den.plain_fn), den.sigma_min,
                                  den.sigma_max)
    return den_j, TA.bind_with_bottleneck(port)


def _predictors(seed, gain=None, **kw):
    pred_j = JA.AMEDPredictor(**kw)
    params = pred_j.init(jax.random.key(seed), jnp.zeros((2, 64)), jnp.asarray(1.0),
                         jnp.asarray(0.5))["params"]
    if gain is not None:
        params = _rescaled(params, seed, gain)
    params = jax.tree.map(np.asarray, params)
    pred_t = load_jax_params(TA.AMEDPredictor(**kw), params)
    return pred_j, params, pred_t


def test_predictor_matches_jax():
    pred_j, params, pred_t = _predictors(1, gain=0.5, scale_dir=0.05, scale_time=0.1)
    bott = np.random.RandomState(0).randn(3, 64).astype(np.float32)
    want = pred_j.apply({"params": params}, jnp.asarray(bott), jnp.asarray(2.5),
                        jnp.asarray(0.7))
    with torch.no_grad():
        got = pred_t(torch.from_numpy(bott), torch.tensor(2.5), torch.tensor(0.7))
    for name, g, w in zip(("r", "scale_dir", "scale_time"), got, want):
        assert g.shape == (3, 1, 1, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)


def test_predictor_heads_off_give_ones_and_no_params():
    pred = init_params(TA.AMEDPredictor(scale_dir=0.0, scale_time=0.0))
    assert pred.fc_scale_dir is None and pred.fc_scale_time is None
    r, sd, st = pred(torch.zeros(2, 64), 1.0, 0.5)
    assert torch.equal(sd, torch.ones_like(r)) and torch.equal(st, torch.ones_like(r))


def test_bottleneck_tap_matches_jax(unit_nets):
    den_j, den_t = unit_nets
    x = np.random.RandomState(1).randn(3, RES, RES, CH).astype(np.float32) * 5
    s = np.array([10.0, 1.0, 0.3], np.float32)
    d_j, b_j = den_j.with_bottleneck(jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        d_t, b_t = den_t.with_bottleneck(torch.from_numpy(x), torch.from_numpy(s))
    assert b_t.shape == (3, 64)
    for got, want in ((d_t, d_j), (b_t, b_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_bind_with_bottleneck_freezes_the_net():
    port = EDMPrecond(img_resolution=RES, img_channels=CH, model_kwargs=UNET_KW).eval()
    TA.bind_with_bottleneck(port)
    assert not any(p.requires_grad for p in port.parameters())
    with pytest.raises(ValueError, match="eval mode"):
        TA.bind_with_bottleneck(port.train())


def test_net_gradient_matches_jax():
    """The backward through the net, which the training step barely sees at
    this size: there the predictor's gradient flows almost all through
    c_skip * x (cutting the attention's gradient moves the SGD step's params
    by ~2e-4, under that test's 1e-3 bound).  d sum(D(x, sigma) * g) by x,
    sigma and the attention blocks' qkv weights, against jax.grad, each
    within 1e-4 of its own max.  The qkv weights take their gradient through
    the attention backward alone (K2's plain version on the CPU), so a wrong
    dq, dk or dv shows there."""
    port = _unit_port()
    params = params_to_jax(port.state_dict())
    qkv = {name: blk["qkv"] for name, blk in params["model"].items() if "qkv" in blk}
    assert len(qkv) == 6

    def with_qkv(q):
        model = {**params["model"], **{n: {**params["model"][n], "qkv": q[n]} for n in q}}
        return {**params, "model": model}

    rng = np.random.RandomState(9)
    x = (2 * rng.randn(2, RES, RES, CH)).astype(np.float32)
    s = np.array([5.0, 0.5], np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    net = _jax_net()
    want_q, want_x, want_s = jax.jit(jax.grad(
        lambda q, x, s: (net.apply({"params": with_qkv(q)}, x, s) * g).sum(),
        argnums=(0, 1, 2)))(qkv, jnp.asarray(x), jnp.asarray(s))
    xt, st = torch.from_numpy(x).requires_grad_(), torch.from_numpy(s).requires_grad_()
    (port(xt, st) * torch.from_numpy(g)).sum().backward()
    got_q = params_to_jax({n: p.grad for n, p in port.named_parameters() if ".qkv." in n})
    pairs = [("x", xt.grad.numpy(), want_x), ("sigma", st.grad.numpy(), want_s)]
    pairs += [(f"{n}/qkv/{leaf}", got_q["model"][n]["qkv"][leaf], want_q[n][leaf])
              for n in qkv for leaf in ("kernel", "bias")]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert np.abs(want).max() > 1e-3, name  # the comparison is not vacuous
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["amed", "euler", "ipndm", "dpm", "dpmpp"])
def test_amed_samplers_match_jax(unit_nets, mode):
    den_j, den_t = unit_nets
    pred_j, params, pred_t = _predictors(2, scale_dir=0.01, scale_time=0.02)
    t_steps = get_schedule(4, 0.002, 80.0, "polynomial", 7.0)
    lat = np.random.RandomState(2).randn(2, RES, RES, CH).astype(np.float32)
    want = JA.AMED_SOLVER_REGISTRY[mode](
        den_j, lambda b, tc, tn: pred_j.apply({"params": params}, b, tc, tn),
        jnp.asarray(lat), t_steps, max_order=3).x
    with torch.no_grad():
        got = TA.AMED_SOLVER_REGISTRY[mode](den_t, pred_t, torch.from_numpy(lat), t_steps,
                                            max_order=3).x
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def _jax_step(den_j, cfg, opt, lat, seed=3):
    pred_j, params, _ = _predictors(seed, scale_dir=cfg.scale_dir, scale_time=cfg.scale_time)
    step = jax.jit(JT.make_amed_train_step(pred_j, den_j, cfg, opt))
    new, _, metrics = step(params, opt.init(params), jnp.asarray(lat))
    return jax.tree.map(np.asarray, new), float(metrics["loss"])


def _torch_step(den_t, cfg, lat, make_opt, seed=3):
    _, _, pred_t = _predictors(seed, scale_dir=cfg.scale_dir, scale_time=cfg.scale_time)
    step = TT.make_amed_train_step(pred_t, den_t, cfg, make_opt(pred_t.parameters()))
    metrics = step(torch.from_numpy(lat))
    return pred_t, float(metrics["loss"])


def _moved(pred_t, seed=3):
    """The largest change of any parameter from its initial value."""
    init = _predictors(seed, scale_dir=pred_t.scale_dir, scale_time=pred_t.scale_time)[2]
    return max((a - b).abs().max().item()
               for a, b in zip(pred_t.state_dict().values(), init.state_dict().values()))


def _assert_params_close(pred_t, params_j, atol, rtol=0.0):
    state = pred_t.state_dict()
    for layer, leaves in params_j.items():
        np.testing.assert_allclose(state[f"{layer}.weight"].numpy(), leaves["kernel"].T,
                                   rtol=rtol, atol=atol, err_msg=layer)
        np.testing.assert_allclose(state[f"{layer}.bias"].numpy(), leaves["bias"], rtol=rtol,
                                   atol=atol, err_msg=layer)


def test_train_step_matches_jax_with_sgd(unit_nets):
    """One trajectory, SGD(0.1): the update is linear in the gradient, so the
    params compare directly (Adam would amplify rounding on near-zero
    gradients).  At unit scale the gradient flows through the net's
    backward, attention included, and the step moves the params by far more
    than the bound."""
    den_j, den_t = unit_nets
    cfg = TT.AMEDConfig(num_steps=3, M=1, sampler_stu="amed", sampler_tea="heun")
    lat = np.random.RandomState(4).randn(4, RES, RES, CH).astype(np.float32)
    params_j, loss_j = _jax_step(den_j, cfg, optax.sgd(0.1), lat)
    pred_t, loss_t = _torch_step(den_t, cfg, lat, lambda p: torch.optim.SGD(p, lr=0.1))
    assert math.isfinite(loss_t) and abs(loss_t - loss_j) <= 1e-4 * abs(loss_j)
    assert _moved(pred_t) > 1.0
    _assert_params_close(pred_t, params_j, atol=1e-3)


def test_grad_accumulation_matches_full_batch(unit_nets):
    """batch_gpu microbatches sum their gradients into one update per
    segment: the same step as the full batch, up to summation order."""
    _, den_t = unit_nets
    cfg = TT.AMEDConfig(num_steps=3, M=1, sampler_stu="amed", sampler_tea="heun")
    lat = np.random.RandomState(5).randn(4, RES, RES, CH).astype(np.float32)
    out = {}
    for bg in (None, 2):
        out[bg] = _torch_step(den_t, dataclasses.replace(cfg, batch_gpu=bg), lat,
                              lambda p: torch.optim.SGD(p, lr=0.1))
    (pa, la), (pb, lb) = out[None], out[2]
    assert abs(la - lb) <= 1e-4 * abs(la)
    assert _moved(pa) > 1.0
    for (name, a), b in zip(pa.state_dict().items(), pb.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2, atol=1e-3, err_msg=name)


def test_remat_traj_matches(unit_nets):
    """torch.utils.checkpoint around the frozen-net calls recomputes the same
    activations: the segment gradient within 1e-5 of its scale, and a full
    Adam step's loss equal and params within 2 * lr (Adam maps any nonzero
    gradient to a step of ~lr)."""
    _, den_t = unit_nets
    cfg = TT.AMEDConfig(num_steps=3, M=1, sampler_stu="amed", sampler_tea="heun")
    lat = torch.from_numpy(np.random.RandomState(6).randn(4, RES, RES, CH).astype(np.float32))
    t_steps = get_schedule(cfg.num_steps, cfg.sigma_min, cfg.sigma_max, cfg.schedule_type,
                           cfg.schedule_rho)
    seg_t = t_steps[0:2]
    x_in = lat * float(t_steps[0])
    tea = torch.from_numpy(np.random.RandomState(7).randn(*x_in.shape).astype(np.float32))
    _, _, pred = _predictors(8, scale_dir=cfg.scale_dir, scale_time=cfg.scale_time)
    grads = []
    for remat in (False, True):
        res, _, _ = TA._amed_family(den_t, pred, x_in / float(seg_t[0]), seg_t, mode="amed",
                                    train=True, step_idx=0, total_num_steps=cfg.num_steps,
                                    remat=remat)
        loss = ((res.x - tea) ** 2).sum() / x_in.shape[0]
        grads.append(torch.autograd.grad(loss, list(pred.parameters())))
    gscale = max(g.abs().max().item() for g in grads[0])
    assert gscale > 1.0  # the comparison below is not vacuous
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * gscale)

    out = {}
    for remat in (False, True):
        out[remat] = _torch_step(den_t, dataclasses.replace(cfg, remat_traj=remat),
                                 lat.numpy(), lambda p: torch.optim.Adam(p, lr=cfg.lr))
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-6)
    for a, b in zip(out[True][0].state_dict().values(), out[False][0].state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2 * cfg.lr)


def test_teacher_slice_indices_match_jax():
    from diff_sampler_tpu.training.sfd import teacher_slice_indices

    for n, m in ((2, 0), (4, 1), (6, 3)):
        assert TT.teacher_slice_indices(n, m) == teacher_slice_indices(n, m)


def test_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(TT.AMEDConfig)]
            == [f.name for f in dataclasses.fields(JT.AMEDConfig)])
    assert dataclasses.asdict(TT.AMEDConfig()) == dataclasses.asdict(JT.AMEDConfig())
