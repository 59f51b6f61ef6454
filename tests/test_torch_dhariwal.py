"""The port's ImageNet-64 path (EDMPrecond over the class-conditional
DhariwalUNet) against the JAX package's.

One tiny DhariwalUNet (16x16, 64 channels, mult [1, 2], 3 blocks per level,
attention at 8x8 with 2 heads of d=64, 5 classes) is built on both sides
from one set of weights: the port's seeded init with every weight redrawn
at unit scale, since the net's zero-init layers (conv1, proj, out_conv) are
exactly zero at init and would hide the net and its attention.  Inputs are
numpy draws handed to both sides.  f32 on the CPU, where the port's
attention takes its plain versions (kernels K1 / K2 run on the card).
Bounds: D(x, sigma), the pooled ``enc_8x8_block2`` tap and the sampler
output 1e-4 * max (the U-Net parity bar); the gradient by x, sigma and the
qkv weights 1e-4 of each one's max; one SGD AMED step: loss within 1e-4
relative, each layer's params within twice the larger of the two sides'
own f32 spreads on that layer, measured in the test (floor 5e-5 of the
step's largest move, ~11).  The 17 blocks at unit scale amplify f32
rounding, most of all in ``fc_r``'s weight columns fed by the U-Net's
bottleneck tap: on one CPU the port was 2.7e-4 of the move from the
jitted JAX step and 3.0e-4 from the eager one, while jitted and eager JAX
differ by only 3.1e-5 there (they share their convolutions' rounding);
the port's own f32 step is 8.6e-5 from its f64 step and the JAX step
3.0e-4 from its x64 step, so the jitted-vs-eager gap alone undercounts
the JAX side's spread.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sampler_tpu.models.factory import build_edm_model as jax_build_edm_model
from diff_sampler_tpu.models.precond import EDMPrecond as JEDMPrecond
from diff_sampler_tpu.models.precond import bind as jax_bind
from diff_sampler_tpu.solvers import amed as JA
from diff_sampler_tpu.solvers import samplers as JS
from diff_sampler_tpu.training import amed as JT
from diff_sampler_tpu_torch import sampling as S
from diff_sampler_tpu_torch.models.convert import (absent_from_jax, load_jax_params,
                                                   params_from_jax, params_to_jax)
from diff_sampler_tpu_torch.models.factory import build_edm_model, init_params
from diff_sampler_tpu_torch.models.precond import BoundDenoiser, EDMPrecond, bind
from diff_sampler_tpu_torch.solvers import amed as TA
from diff_sampler_tpu_torch.training import amed as TT
from diff_sampler_tpu_torch.utils.rng import stacked_randint

RES, CH, LABELS = 16, 3, 5
TINY = dict(model_channels=64, channel_mult=[1, 2], num_blocks=3, attn_resolutions=[8],
            dropout=0.0)
SIGMAS = np.array([80.0, 10.0, 1.0, 0.1], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU,
    where torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_net():
    return JEDMPrecond(img_resolution=RES, img_channels=CH, label_dim=LABELS,
                       model_type="DhariwalUNet", model_kwargs=TINY)


def _unit_port():
    """The port's net: its seeded init, every weight redrawn at unit scale."""
    port = init_params(EDMPrecond(img_resolution=RES, img_channels=CH, label_dim=LABELS,
                                  model_type="DhariwalUNet", model_kwargs=TINY).eval(), seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for p in port.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                    / math.sqrt(fan_in))
    return port


@pytest.fixture(scope="module")
def nets():
    """(JAX module, its params, the port's module) over one set of weights."""
    port = _unit_port()
    return _jax_net(), params_to_jax(port.state_dict()), port


def _onehot(idx):
    return np.eye(LABELS, dtype=np.float32)[np.asarray(idx)]


def _inputs(seed, n=4):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, RES, RES, CH) * SIGMAS[:n, None, None, None]).astype(np.float32)
    return x, SIGMAS[:n]


def _close(got, want, rel=1e-4, what=""):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def test_param_tree_matches_jax_init(nets):
    """Every JAX param has its port parameter of the same shape and back:
    ``map_label`` (no bias), ``out_norm`` and ``out_conv`` at the top, no
    ``map_augment``."""
    net, _, port = nets
    shapes = jax.eval_shape(net.init, jax.random.key(0), jnp.zeros((1, RES, RES, CH)),
                            jnp.ones((1,)))["params"]
    want = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    got = {k: v for k, v in port.state_dict().items() if not absent_from_jax(k)}
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    assert {"model.map_label.weight", "model.out_norm.weight",
            "model.out_conv.weight"} <= set(got)
    assert "model.map_label.bias" not in got
    assert not any("map_augment" in k for k in port.state_dict())


def test_full_width_imagenet64_net_matches_jax_and_has_22_attention_sites():
    """EDM_ARCHS['imagenet64'] on both sides: the same keys and shapes, 296M
    parameters, and 22 attention sites at d=64 -- 7 at 32x32 (6 heads), 7 at
    16x16 (9 heads), 8 at 8x8 (12 heads)."""
    net = jax_build_edm_model("imagenet64")
    shapes = jax.eval_shape(net.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.ones((1,)))["params"]
    want = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    module = build_edm_model("imagenet64", device="meta")
    got = module.state_dict()
    assert set(want) == {k for k in got if not absent_from_jax(k)}
    assert all(tuple(want[k].shape) == tuple(got[k].shape) for k in want)
    assert 295e6 < sum(p.numel() for p in module.parameters()) < 297e6
    sites = [(name.split(".")[2].split("_")[0], m.num_heads, m.qkv.weight.shape[0] // 3)
             for name, m in module.named_modules() if getattr(m, "num_heads", 0)]
    assert sorted(set(sites)) == [("16x16", 9, 576), ("32x32", 6, 384), ("8x8", 12, 768)]
    assert [s[0] for s in sites].count("32x32") == 7
    assert [s[0] for s in sites].count("16x16") == 7
    assert [s[0] for s in sites].count("8x8") == 8
    assert all(c // h == 64 for _, h, c in sites)


@pytest.mark.parametrize("labelled", [True, False], ids=["one-hot labels", "no labels"])
def test_denoiser_matches_jax(nets, labelled):
    net, params, port = nets
    x, s = _inputs(1)
    labels = _onehot([0, 3, 4, 1]) if labelled else None
    ref = jax.jit(lambda x, s, c: net.apply({"params": params}, x, s, c))(
        jnp.asarray(x), jnp.asarray(s), None if labels is None else jnp.asarray(labels))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(s),
                   None if labels is None else torch.from_numpy(labels))
    _close(got.numpy(), ref)
    # the net's output is not just c_skip * x: the unit-scale weights show
    assert np.abs(got.numpy() - x * 0.25 / (s[:, None, None, None] ** 2 + 0.25)).max() > 0.1


def test_no_labels_is_a_zero_one_hot_row(nets):
    _, _, port = nets
    x, s = (torch.from_numpy(a) for a in _inputs(2, n=2))
    with torch.no_grad():
        a = port(x, s)
        b = port(x, s, torch.zeros(1, LABELS))
        c = port(x, s, torch.from_numpy(_onehot([2, 2])))
    assert torch.equal(a, b) and not torch.allclose(a, c)


def test_bottleneck_tap_matches_jax(nets):
    """The AMED tap of a conditional net, ``enc_8x8_block2``, pooled over
    channels to 64 values, with the net bound without labels (as both
    packages' AMED does on the EDM tier)."""
    net, params, port = nets
    name = TA.bottleneck_module_name(LABELS, RES)
    assert name == JA.bottleneck_module_name(LABELS, RES) == "enc_8x8_block2"
    den_j = JA.bind_with_bottleneck(net, params, name)
    x, s = _inputs(3)
    d_j, b_j = jax.jit(den_j.fn)(jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        d_t, act = port.with_bottleneck(torch.from_numpy(x), torch.from_numpy(s), name)
    assert act.shape == (4, 8, 8, 128)
    b_t = TA._pool_bottleneck(act)
    _close(d_t.numpy(), d_j, what="D")
    _close(b_t.numpy(), b_j, what="tap")


def test_net_gradient_matches_jax(nets):
    """d sum(D(x, sigma, labels) * g) by x, sigma and the qkv weights of the
    attention blocks, against jax.grad.  The qkv weights take their gradient
    through the attention backward alone (K2's plain version on the CPU)."""
    net, params, _ = nets
    port = _unit_port()
    qkv = {name: blk["qkv"] for name, blk in params["model"].items() if "qkv" in blk}
    assert len(qkv) == 8  # enc_8x8_block0-2, dec_8x8_in0, dec_8x8_block0-3

    def with_qkv(q):
        model = {**params["model"], **{n: {**params["model"][n], "qkv": q[n]} for n in q}}
        return {**params, "model": model}

    x, s = _inputs(4, n=2)
    labels = _onehot([1, 4])
    g = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    want_q, want_x, want_s = jax.jit(jax.grad(
        lambda q, x, s: (net.apply({"params": with_qkv(q)}, x, s, jnp.asarray(labels))
                         * g).sum(), argnums=(0, 1, 2)))(qkv, jnp.asarray(x), jnp.asarray(s))
    xt, st = torch.from_numpy(x).requires_grad_(), torch.from_numpy(s).requires_grad_()
    (port(xt, st, torch.from_numpy(labels)) * torch.from_numpy(g)).sum().backward()
    got_q = params_to_jax({n: p.grad for n, p in port.named_parameters() if ".qkv." in n})
    pairs = [("x", xt.grad.numpy(), want_x), ("sigma", st.grad.numpy(), want_s)]
    pairs += [(f"{n}/qkv/{leaf}", got_q["model"][n]["qkv"][leaf], want_q[n][leaf])
              for n in qkv for leaf in ("kernel", "bias")]
    for name, got, want in pairs:
        assert np.abs(np.asarray(want)).max() > 1e-3, name  # not vacuous
        _close(got, want, what=name)


def test_ipndm_with_labels_matches_jax(nets):
    """The slice as a whole: ipndm on the poly-7 schedule over the labelled
    net, the same latents and labels on both sides."""
    net, params, port = nets
    cfg = S.SolverConfig(solver="ipndm", num_steps=4)
    t_steps = cfg.resolve_t_steps(0.002, 80.0)
    lat = np.random.RandomState(6).randn(3, RES, RES, CH).astype(np.float32)
    labels = _onehot([4, 0, 2])
    den_j = jax_bind(net, params, class_labels=jnp.asarray(labels))
    want = jax.jit(lambda z: JS.get_sampler("ipndm")(den_j, z, t_steps).x)(jnp.asarray(lat))
    got = S.build_sample_fn(bind(port, torch.from_numpy(labels)), cfg)(torch.from_numpy(lat))
    _close(got.numpy(), want)


def test_generate_draws_each_seeds_label_at_any_batch_split():
    """Labels are one-hot draws of ``stacked_randint`` per seed, padded like
    the latents; ``class_idx`` pins one class."""
    seen = {}

    def denoise(x, t, labels):
        seen.setdefault(x.shape[0], []).append(labels.clone())
        return x * 0 + labels.argmax(1).float()[:, None, None, None]

    den = BoundDenoiser(denoise, 0.002, 80.0)
    cfg = S.SolverConfig(solver="euler", num_steps=2)
    seeds = [11, 3, 7, 20, 5]
    want = stacked_randint(seeds, (), 0, 7, device="cpu").numpy()
    for batch in (5, 2):
        out = S.generate(den, seeds, (2, 2, 1), cfg, max_batch_size=batch, device="cpu",
                         label_dim=7)
        # one euler step from sigma 80 to 0.002 lands within 1e-4 * |x0| of
        # D, whose every pixel is the class index
        np.testing.assert_array_equal(np.rint(out[:, 0, 0, 0]), want)
    padded = seen[2][-1]  # the last batch of two holds seed 5 twice
    assert padded.shape == (2, 7) and torch.equal(padded[0], padded[1])
    pinned = S.generate(den, seeds, (2, 2, 1), cfg, max_batch_size=2, device="cpu",
                        label_dim=7, class_idx=6)
    assert (np.rint(pinned) == 6).all()


def test_generate_with_labels_is_per_seed(nets):
    """On the tiny net: image i depends on seed i alone, at any batch size."""
    _, _, port = nets
    cfg = S.SolverConfig(solver="ipndm", num_steps=3)
    den = bind(port)
    seeds = [4, 9, 1]
    full = S.generate(den, seeds, (RES, RES, CH), cfg, max_batch_size=3, device="cpu",
                      label_dim=LABELS)
    split = S.generate(den, [9], (RES, RES, CH), cfg, max_batch_size=2, device="cpu",
                       label_dim=LABELS)
    assert np.isfinite(full).all()
    np.testing.assert_allclose(split[0], full[1], rtol=0, atol=1e-5 * np.abs(full).max())


def _predictors(seed, **kw):
    pred_j = JA.AMEDPredictor(**kw)
    params = pred_j.init(jax.random.key(seed), jnp.zeros((2, 64)), jnp.asarray(1.0),
                         jnp.asarray(0.5))["params"]
    params = jax.tree.map(np.asarray, params)
    return pred_j, params, load_jax_params(TA.AMEDPredictor(**kw), params)


@contextlib.contextmanager
def _float64_torch():
    """Run the port in float64 where its code asks for float32: ``.float()``
    and ``.to(torch.float32)`` of a float64 tensor keep it in float64, and
    the factories' ``dtype=torch.float32`` gives float64.  Test-only: the
    port's AMED step then runs in f64 end to end on ``.double()`` modules."""
    f32, f64 = torch.float32, torch.float64
    names = ("tensor", "as_tensor", "arange", "zeros", "ones", "empty", "full")
    factories = {n: getattr(torch, n) for n in names}
    to_float, to = torch.Tensor.float, torch.Tensor.to

    def factory(fn):
        def make(*args, **kw):
            if kw.get("dtype") is f32:
                kw["dtype"] = f64
            return fn(*args, **kw)
        return make

    def keep_float(self, *args, **kw):
        return self if self.dtype is f64 else to_float(self, *args, **kw)

    def keep_to(self, *args, **kw):
        if self.dtype is f64:
            args = tuple(f64 if a is f32 else a for a in args)
            if kw.get("dtype") is f32:
                kw["dtype"] = f64
        return to(self, *args, **kw)

    try:
        for n, fn in factories.items():
            setattr(torch, n, factory(fn))
        torch.Tensor.float, torch.Tensor.to = keep_float, keep_to
        yield
    finally:
        for n, fn in factories.items():
            setattr(torch, n, fn)
        torch.Tensor.float, torch.Tensor.to = to_float, to


def _amed_sgd_steps(net, params):
    """One SGD(0.1) AMED step on the ImageNet-64 tier's net, bound without
    labels, five ways: the JAX step jitted, eagerly and jitted with x64 on
    (f64 params and latents; the JAX package's explicit f32 casts stay), and
    the port's step in f32 and in f64.  Returns (loss of the port's f32
    step, loss of the jitted JAX step, the largest move of the port's f32
    params, {layer: {"kernel" / "bias": {way: array}}}), kernels as the JAX
    package lays them out."""
    port = _unit_port()
    name = TA.bottleneck_module_name(LABELS, RES)
    den = JA.bind_with_bottleneck(net, params, name)
    den_j = JA.BottleneckDenoiser(jax.jit(den.fn), jax.jit(den.plain_fn), den.sigma_min,
                                  den.sigma_max)
    cfg = TT.AMEDConfig(dataset_name="imagenet64", num_steps=3, M=1, sampler_stu="amed",
                        sampler_tea="heun")
    lat = np.random.RandomState(7).randn(2, RES, RES, CH).astype(np.float32)
    pred_j, p0, pred_t = _predictors(3, scale_dir=cfg.scale_dir, scale_time=cfg.scale_time)
    opt = optax.sgd(0.1)
    new, _, metrics = jax.jit(JT.make_amed_train_step(pred_j, den_j, cfg, opt))(
        p0, opt.init(p0), jnp.asarray(lat))
    with jax.disable_jit():
        eager, _, _ = JT.make_amed_train_step(pred_j, den_j, cfg, opt)(
            p0, opt.init(p0), jnp.asarray(lat))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        to64 = lambda tree: jax.tree.map(lambda v: np.asarray(v, np.float64), tree)
        den64 = JA.bind_with_bottleneck(net, to64(params), name)
        den64 = JA.BottleneckDenoiser(jax.jit(den64.fn), jax.jit(den64.plain_fn),
                                      den64.sigma_min, den64.sigma_max)
        p0_64 = to64(p0)
        new64, _, _ = jax.jit(JT.make_amed_train_step(pred_j, den64, cfg, opt))(
            p0_64, opt.init(p0_64), jnp.asarray(lat, jnp.float64))
        new64 = jax.tree.map(np.asarray, new64)
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert all(v.dtype == np.float64 for v in jax.tree.leaves(new64))
    step = TT.make_amed_train_step(pred_t, TA.bind_with_bottleneck(port), cfg,
                                   torch.optim.SGD(pred_t.parameters(), lr=0.1))
    loss_t = float(step(torch.from_numpy(lat))["loss"])
    _, _, pred64 = _predictors(3, scale_dir=cfg.scale_dir, scale_time=cfg.scale_time)
    pred64 = pred64.double()
    with _float64_torch():
        step64 = TT.make_amed_train_step(pred64, TA.bind_with_bottleneck(_unit_port().double()),
                                         cfg, torch.optim.SGD(pred64.parameters(), lr=0.1))
        assert step64(torch.from_numpy(lat).double())["loss"].dtype == torch.float64
    state, state64 = pred_t.state_dict(), pred64.state_dict()
    moved = max(np.abs(state[f"{layer}.weight"].numpy() - leaves["kernel"].T).max()
                for layer, leaves in p0.items())
    new, eager = jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, eager)
    steps = {}
    for layer in new:
        steps[layer] = {k: {"jit": new[layer][k], "eager": eager[layer][k],
                            "jit64": new64[layer][k],
                            "port": state[f"{layer}.{w}"].numpy().T,
                            "port64": state64[f"{layer}.{w}"].numpy().T}
                        for k, w in (("kernel", "weight"), ("bias", "bias"))}
    return loss_t, float(metrics["loss"]), moved, steps


def _spread(ways) -> float:
    """A layer parameter's own f32 spread: the largest of jitted vs eager
    JAX, the port's f32 vs f64 step and the JAX f32 vs x64 step."""
    gap = lambda a, b: np.abs(ways[a] - ways[b]).max()
    return max(gap("jit", "eager"), gap("port", "port64"), gap("jit", "jit64"))


def test_amed_train_step_matches_jax_with_sgd(nets):
    """One AMED trajectory on the ImageNet-64 tier's net, bound without
    labels on both sides, SGD(0.1) (the update is linear in the gradient).
    Each side's own f32 spread is measured here, layer by layer: jitted
    against eager JAX, the port's f32 step against its f64 step, and the
    jitted JAX step against the same step with x64 on and f64 params and
    latents (the JAX package's explicit f32 casts stay).  The port's f32
    params are held to both the jitted and the eager JAX step within twice
    the largest of the three (floor 5e-5 of the largest move), and so is the
    port's f64 step: a port that computed another function would sit far
    from both."""
    net, params, _ = nets
    loss_t, loss_j, moved, steps = _amed_sgd_steps(net, params)
    assert math.isfinite(loss_t) and abs(loss_t - loss_j) <= 1e-4 * abs(loss_j)
    assert moved > 1.0
    for layer, params_of in steps.items():
        atol = max(2 * max(_spread(ways) for ways in params_of.values()), 5e-5 * moved)
        for k, ways in params_of.items():
            for way in ("port", "port64"):
                for ref in ("jit", "eager"):
                    np.testing.assert_allclose(ways[way], ways[ref], rtol=0, atol=atol,
                                               err_msg=f"{layer} {k}: {way} vs {ref}")


if __name__ == "__main__":
    # each layer's gaps between the ways of the SGD step, as shares of the
    # largest move: JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dhariwal.py
    torch.set_num_threads(1)
    port = _unit_port()
    _, _, moved, steps = _amed_sgd_steps(_jax_net(), params_to_jax(port.state_dict()))
    pairs = [("port", "jit"), ("port", "eager"), ("jit", "eager"), ("port", "port64"),
             ("jit", "jit64"), ("port64", "jit"), ("port64", "eager")]
    print(f"largest move {moved:.6g}")
    for layer, params_of in steps.items():
        for k, ways in params_of.items():
            print(f"{layer} {k}: " + ", ".join(
                f"{a} vs {b} {np.abs(ways[a] - ways[b]).max() / moved:.3g}" for a, b in pairs))
