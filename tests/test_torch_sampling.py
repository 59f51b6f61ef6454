"""The port's slice as a whole: seeds -> sampler -> denoiser -> images.

``build_sample_fn`` with a tiny EDM net and ipndm (NFE 5) runs against the
JAX package's on the same latents and the same redrawn weights: f32, max
abs error <= 1e-4 * max|x|.  ``generate`` keeps the per-seed contract, and
the CLI writes PNGs that decode to what ``generate`` returns.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from diff_sampler_tpu import sampling as JSAMP
from diff_sampler_tpu.models.precond import EDMPrecond as JEDMPrecond
from diff_sampler_tpu.models.precond import bind as jbind
from diff_sampler_tpu_torch import sampling as S
from diff_sampler_tpu_torch.cli import sample as cli
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models.convert import load_jax_params
from diff_sampler_tpu_torch.models.precond import EDMPrecond, bind
from diff_sampler_tpu_torch.utils.image import encode_png, parse_int_list
from diff_sampler_tpu_torch.utils.rng import stacked_randint, stacked_randn

TINY = dict(model_channels=16, channel_mult=[1, 2], num_blocks=1, attn_resolutions=[8],
            dropout=0.0)
SHAPE = (16, 16, 3)


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


def _tiny_port(seed=0):
    return factory.init_params(EDMPrecond(16, 3, model_kwargs=TINY), seed).eval()


@pytest.mark.parametrize("solver,num_steps,nfe", [("ipndm", 6, 5), ("heun", 3, 4)])
def test_sample_fn_matches_jax(solver, num_steps, nfe):
    net = JEDMPrecond(img_resolution=16, img_channels=3, model_kwargs=TINY)
    params = jax.jit(net.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                               jnp.ones((1,)))["params"]
    params = _rescaled(params, seed=0)
    lat = np.random.RandomState(1).randn(3, *SHAPE).astype(np.float32)
    jcfg = JSAMP.SolverConfig(solver=solver, num_steps=num_steps)
    ref = np.asarray(jax.jit(JSAMP.build_sample_fn(jbind(net, params), jcfg))(jnp.asarray(lat)))

    port = load_jax_params(EDMPrecond(16, 3, model_kwargs=TINY).eval(), params)
    cfg = S.SolverConfig(solver=solver, num_steps=num_steps)
    assert cfg.nfe() == jcfg.nfe() == nfe
    ours = S.build_sample_fn(bind(port), cfg)(torch.from_numpy(lat)).numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny_den():
    return bind(_tiny_port())


def test_generate_rows_are_per_seed(tiny_den):
    cfg = S.SolverConfig(solver="ipndm", num_steps=4)
    seeds = list(range(10))
    full = S.generate(tiny_den, seeds, SHAPE, cfg, max_batch_size=10, device="cpu")
    split = S.generate(tiny_den, seeds, SHAPE, cfg, max_batch_size=3, device="cpu")
    some = S.generate(tiny_den, [7, 2], SHAPE, cfg, max_batch_size=3, device="cpu")
    assert full.shape == (10, *SHAPE) and full.dtype == np.float32
    assert np.isfinite(full).all()
    # the CPU's conv kernels may block a batch of 3 and of 10 differently
    tol = 1e-6 * np.abs(full).max()
    np.testing.assert_allclose(split, full, rtol=0, atol=tol)
    np.testing.assert_allclose(some, full[[7, 2]], rtol=0, atol=tol)


def test_generate_same_with_callback_and_in_seed_order(tiny_den):
    cfg = S.SolverConfig(solver="euler", num_steps=3)
    seeds = [5, 1, 9, 4, 0]
    plain = S.generate(tiny_den, seeds, SHAPE, cfg, max_batch_size=2, device="cpu")
    got = []
    cb = S.generate(tiny_den, seeds, SHAPE, cfg, max_batch_size=2, device="cpu",
                    batch_callback=lambda start, x: got.append((start, x.copy())))
    assert np.array_equal(plain, cb)
    assert [s for s, _ in got] == [0, 2, 4]
    assert np.array_equal(np.concatenate([x for _, x in got]), plain)


def test_to_uint8_matches_jax():
    x = np.random.RandomState(0).randn(4, 8, 8, 3).astype(np.float32) * 1.5
    np.testing.assert_array_equal(S.to_uint8(x), JSAMP.to_uint8(x))


def test_solver_config_nfe_matches_jax():
    for solver in ("euler", "heun", "ipndm", "ipndm_v"):
        for afs in (False, True):
            for dtz in (False, True):
                kw = dict(solver=solver, num_steps=7, afs=afs, denoise_to_zero=dtz)
                assert S.SolverConfig(**kw).nfe() == JSAMP.SolverConfig(**kw).nfe()
    for kw in (dict(num_steps=9), dict(num_steps=5, schedule_type="logsnr")):
        np.testing.assert_array_equal(S.SolverConfig(**kw).resolve_t_steps(0.002, 80.0),
                                      JSAMP.SolverConfig(**kw).resolve_t_steps(0.002, 80.0))


def test_stacked_randn_rows_depend_only_on_their_seed():
    a = stacked_randn([3, 5, 7], (4, 4, 3), device="cpu")
    b = stacked_randn([5], (4, 4, 3), device="cpu")
    assert a.shape == (3, 4, 4, 3) and a.dtype == torch.float32
    assert torch.equal(a[1], b[0]) and not torch.equal(a[0], a[1])
    assert stacked_randn([5], (2,), dtype=torch.bfloat16, device="cpu").dtype == torch.bfloat16
    r = stacked_randint([3, 5], (6,), 0, 10, device="cpu")
    assert torch.equal(r[1], stacked_randint([5], (6,), 0, 10, device="cpu")[0])
    assert r.min() >= 0 and r.max() < 10


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_encode_png_round_trips(channels, tmp_path):
    img = np.random.RandomState(channels).randint(0, 256, (5, 7, channels), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(encode_png(img))
    back = np.asarray(PIL.Image.open(path))
    np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_parse_int_list():
    assert parse_int_list("1,2,5-8") == [1, 2, 5, 6, 7, 8]
    assert parse_int_list([3, 4]) == [3, 4]


def test_cli_writes_pngs_of_generate_output(tmp_path, monkeypatch):
    monkeypatch.setitem(factory.EDM_ARCHS, "tiny16", (
        dict(img_resolution=16, img_channels=3, label_dim=0, model_type="SongUNet"),
        TINY))
    outdir = tmp_path / "out"
    cli.main(["--dataset_name=tiny16", "--model_path=random", "--solver=ipndm",
              "--num_steps=3", "--seeds=998-1000", "--batch=2", "--device=cpu",
              f"--outdir={outdir}"])
    files = sorted(os.path.relpath(os.path.join(d, f), outdir)
                   for d, _, fs in os.walk(outdir) for f in fs)
    assert files == ["000000/000998.png", "000000/000999.png", "001000/001000.png"]

    module, _ = factory.create_model("tiny16", "random", device="cpu")
    want = S.to_uint8(S.generate(bind(module), [998, 999, 1000], SHAPE,
                                 S.SolverConfig(solver="ipndm", num_steps=3),
                                 max_batch_size=2, device="cpu"))
    for img, name in zip(want, files):
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(outdir / name)), img)


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--dataset_name=cifar10", "--device=cuda"])


def test_generate_runs_on_the_card_by_default(tiny_den):
    """With no ``device``, generate draws its latents on CUDA: on a machine
    without a card (as where the tier-1 tests run) it raises instead of
    running on the CPU."""
    assert not torch.cuda.is_available()
    cfg = S.SolverConfig(solver="euler", num_steps=2)
    with pytest.raises((RuntimeError, AssertionError)):
        S.generate(tiny_den, [0, 1], SHAPE, cfg)
