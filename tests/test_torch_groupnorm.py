"""The port's GroupNorm (+ affine) (+ SiLU) against the JAX package's.

On a CPU tensor ``groupnorm_silu`` is its plain version,
``reference_groupnorm_silu`` (kernel K3 runs on the card, where
``tests/test_torch_kernels_cuda.py`` holds it against this plain version).
Here the plain version meets the JAX package's default path ``_jnp_gn`` and
its Pallas kernel ``_pallas_gn`` in interpret mode, across eps 1e-5 / 1e-6,
SiLU on and off, f32 / bf16 and group sizes 7, 21 and 49 (the LSUN LDM
U-Net's 224, 672 and 1568 channels over 32 groups), on a ragged H * W.

Tolerances, relative to max(1, max|JAX out|): f32 1e-5 (f32 sums in other
orders; the Pallas kernel takes the group means through a matmul); bf16 2^-7,
one bf16 step at the largest output, where the two f32 results straddle a
rounding boundary.  Gradients (by x, scale and bias, against ``jax.vjp`` of
``_jnp_gn``) 1e-5 of each one's max.

It also holds ``gn_route``, the pure-Python choice of K3's route, at every
GroupNorm shape of the five tiers' nets and of both decoders, its constants
against the C source, and the rows of each cluster rank.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops.pallas_groupnorm import _jnp_gn, _pallas_gn
from diff_sampler_tpu_torch.models import adm, layers
from diff_sampler_tpu_torch.models.factory import create_model
from diff_sampler_tpu_torch.ops import groupnorm as G

GROUPS = 32
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _inputs(c, seed, hw=(3, 5), n=2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, *hw, c) * 3 + 1).astype(np.float32)
    # a different offset per group, so a group mixed up shows
    x += np.repeat(rng.randn(GROUPS), c // GROUPS).astype(np.float32)
    return x, (1 + 0.5 * rng.randn(c)).astype(np.float32), rng.randn(c).astype(np.float32)


def _to(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax_in(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _assert_close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("cg", [7, 21, 49])
def test_plain_version_matches_jnp_gn(cg, eps, silu, dtype):
    x, scale, bias = _inputs(GROUPS * cg, seed=cg)
    want = _jnp_gn(_jax_in(x, dtype), jnp.asarray(scale), jnp.asarray(bias), GROUPS, eps, silu)
    got = G.groupnorm_silu(_to(x, dtype), torch.from_numpy(scale), torch.from_numpy(bias),
                           groups=GROUPS, eps=eps, apply_silu=silu)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)], ids=["silu", "no-silu"])
@pytest.mark.parametrize("cg", [7, 21, 49])
def test_plain_version_matches_the_pallas_kernel_in_interpret_mode(cg, silu, eps, dtype):
    x, scale, bias = _inputs(GROUPS * cg, seed=100 + cg)
    want = _pallas_gn(_jax_in(x, dtype), jnp.asarray(scale), jnp.asarray(bias), GROUPS, eps,
                      silu, interpret=True)
    got = G.reference_groupnorm_silu(_to(x, dtype), torch.from_numpy(scale),
                                     torch.from_numpy(bias), groups=GROUPS, eps=eps,
                                     apply_silu=silu)
    _assert_close(got, want, dtype)


def _vjp_jax(x, scale, bias, g, eps, silu):
    _, vjp = jax.vjp(lambda *a: _jnp_gn(*a, GROUPS, eps, silu), jnp.asarray(x),
                     jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
def test_plain_gradient_matches_jax_vjp(silu):
    x, scale, bias = _inputs(GROUPS * 7, seed=3)
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    out = G.groupnorm_silu(*leaves, groups=GROUPS, eps=1e-6, apply_silu=silu)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip(("x", "scale", "bias"), got, _vjp_jax(x, scale, bias, g, 1e-6, silu)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def test_kernel_function_backward_is_the_plain_vjp(monkeypatch):
    """``_GroupNormK3``'s backward, with its forward's launch replaced by the
    plain version (no card here): the gradient by x alone (a frozen net) and
    by all three equals plain autograd's, bit for bit."""
    monkeypatch.setattr(G, "_launch", lambda x, s, b, groups, eps, silu:
                        G.reference_groupnorm_silu(x, s, b, groups=groups, eps=eps,
                                                   apply_silu=silu))
    x, scale, bias = _inputs(GROUPS * 21, seed=5)
    g = torch.from_numpy(np.random.RandomState(6).randn(*x.shape).astype(np.float32))
    for need in ((True, False, False), (True, True, True)):
        leaves = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((x, scale, bias), need)]
        got = torch.autograd.grad(G._GroupNormK3.apply(*leaves, GROUPS, 1e-5, True),
                                  [t for t in leaves if t.requires_grad], g)
        want = torch.autograd.grad(G.reference_groupnorm_silu(*leaves, groups=GROUPS),
                                   [t for t in leaves if t.requires_grad], g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_tensor_runs_the_plain_version_and_other_devices_raise():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(GROUPS * 7, seed=7))
    before = G.groupnorm_silu.launches
    assert torch.equal(G.groupnorm_silu(x, scale, bias, groups=GROUPS),
                       G.reference_groupnorm_silu(x, scale, bias, groups=GROUPS))
    assert G.groupnorm_silu.launches == before
    meta = torch.empty(2, 3, 5, GROUPS * 7, device="meta")
    with pytest.raises(ValueError, match="no GroupNorm kernel for device meta"):
        G.groupnorm_silu(meta, scale.to("meta"), bias.to("meta"), groups=GROUPS)


# The K3 route (``gn_route``), a pure function of the shape, here on the
# CPU: the GroupNorm shapes of every tier's net and of both decoders, read
# off full-width models built on the meta device (no weights, no compute).
def _record_shapes(monkeypatch, build):
    shapes = []

    def record(x, scale, bias, *, groups, eps=1e-5, apply_silu=True):
        shapes.append((*x.shape, groups))
        return torch.empty_like(x)

    for module in (layers, adm):
        monkeypatch.setattr(module, "groupnorm_silu", record)
        monkeypatch.setattr(module, "sdpa", lambda q, k, v, scale=None: torch.empty_like(q))
    with torch.no_grad():
        build()
    return sorted(set(shapes))


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _net_call(dataset, batch):
    def call():
        net, _ = create_model(dataset, "random", device="meta")
        if dataset in ("cifar10", "ffhq", "imagenet64"):
            res = 32 if dataset == "cifar10" else 64
            labels = (_meta(batch, 1000),) if dataset == "imagenet64" else ()
            net(_meta(batch, res, res, 3), _meta(batch), *labels)
        else:
            unet = net.latent_diffusion.unet
            ctx = (_meta(batch, 77, 768),) if dataset == "ms_coco" else ()
            unet(_meta(batch, 64, 64, unet.in_channels), _meta(batch), *ctx)
    return call


def _decode_call(dataset, batch):
    def call():
        net, _ = create_model(dataset, "random", device="meta")
        ld = net.latent_diffusion
        z = 3 if dataset == "lsun_bedroom_ldm" else 4
        ld.decode_first_stage(_meta(batch, 64, 64, z))
    return call


# (tier, sampling batch per net call in bf16, AMED microbatch in f32) of the
# five tiers' nets (SD guided: two rows per image)
NET_TIERS = [("cifar10", 256, 512), ("ffhq", 256, 512), ("imagenet64", 256, 128),
             ("lsun_bedroom_ldm", 64, 128), ("ms_coco", 16, 16)]
# The bf16 levels that take the stream route: their slab (1.75-7.5 MiB a
# sample) fits no cluster of at most 8 blocks, nor 16 blocks two to an SM.
# The timed sweep of both routes found the stream faster at every such
# shape it measured (PERF.md §6, K3); several fit no cluster at all.
STREAM_LEVELS = {
    "ffhq": {(64, 64, 256), (64, 64, 384)},
    "imagenet64": {(32, 32, 960), (64, 64, 384), (64, 64, 576)},
    "lsun_bedroom_ldm": {(32, 32, 896), (32, 32, 1120), (64, 64, 224), (64, 64, 448),
                         (64, 64, 672)},
    "ms_coco": {(32, 32, 960), (32, 32, 1280), (32, 32, 1920), (64, 64, 320), (64, 64, 640),
                (64, 64, 960)},
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tier,bf16_batch,f32_batch", NET_TIERS,
                         ids=[t[0] for t in NET_TIERS])
def test_route_of_every_net_level(monkeypatch, tier, bf16_batch, f32_batch, dtype):
    """Every bf16 U-Net level whose slab a cluster holds (at most 8 blocks,
    or 16 two to an SM) takes the one-kernel slab route, the rest the
    two-kernel stream; every route fits a block's shared memory and a
    cluster of at most 16."""
    batch = bf16_batch if dtype == "bfloat16" else f32_batch
    shapes = _record_shapes(monkeypatch, _net_call(tier, batch))
    assert len(shapes) >= 4
    for n, h, w, c, groups in shapes:
        assert n == batch
        route = G.gn_route(n, h, w, c, getattr(torch, dtype), groups=groups)
        assert route.smem <= G.SMEM_LIMIT == 232448 and 0 <= route.cluster <= 16
        assert route.kernels == (1 if route.kind == "slab" else 2)
        elt = 2 if dtype == "bfloat16" else 4
        slabs = [G._slab_route(n, h * w, c, groups, elt, 16 // elt, s) for s in (8, 16)]
        holds = slabs[0] is not None or (
            slabs[1] is not None and 2 * (slabs[1].smem + 1024) <= 233472)
        assert (route.kind == "slab") == holds, (n, h, w, c)
        if dtype == "bfloat16":
            assert (route.kind == "stream") == ((h, w, c) in STREAM_LEVELS.get(tier, ())), \
                (n, h, w, c)
        if route.kind == "slab":
            assert route.cluster in G.CLUSTER_SIZES and route.threads == G.SLAB_THREADS


@pytest.mark.parametrize("tier", ["lsun_bedroom_ldm", "ms_coco"], ids=["vq", "kl"])
def test_decoders_take_the_stream_route(monkeypatch, tier):
    """The VQ and KL decoders' slabs (8-32 MB a sample at 64x64 and up) fit no
    cluster: two kernels, statistics (with the finalize) and apply."""
    shapes = _record_shapes(monkeypatch, _decode_call(tier, 16))
    assert {h for _, h, _, _, _ in shapes} >= {64, 256}
    for n, h, w, c, groups in shapes:
        route = G.gn_route(n, h, w, c, torch.float32, groups=groups)
        assert (route.kind, route.kernels, route.cluster) == ("stream", 2, 0), (h, w, c)
        assert route.smem <= G.SMEM_LIMIT and route.rows * -(-h * w // route.rows) >= h * w


def test_route_constants_mirror_the_kernel_source():
    """The route's constants and shared-memory layouts are the C source's."""
    src = (Path(G.__file__).resolve().parent.parent / "csrc" / "groupnorm.cu").read_text()
    assert f"constexpr int kMaxCluster = {G.MAX_CLUSTER};" in src
    assert f"constexpr int kSmemLimit = {G.SMEM_LIMIT};" in src
    assert f"constexpr int kSlabThreads = {G.SLAB_THREADS};" in src
    assert f"constexpr int kStreamThreads = {G.STREAM_THREADS};" in src
    assert "threads != kSlabThreads ||" in src and "threads != kStreamThreads ||" in src
    # slab_layout: rows of x, lanes' f32 partials (8-byte aligned), then per
    # group 8 + 8 + 4 + 4 bytes; stream_smem: the lanes' f32 (mean, M2)
    for line in ("s.lane = align_up(rows * c * elt, 16);",
                 "s.psum = align_up(s.lane + static_cast<long long>(lanes_of(threads, c, elt)) "
                 "* c * 4, 8);", "s.pm2 = s.psum + 8LL * groups;",
                 "s.gmean = s.pm2 + 8LL * groups;", "s.ginv = s.gmean + 4LL * groups;",
                 "s.bytes = s.ginv + 4LL * groups;",
                 "return 8LL * lanes_of(kStreamThreads, c, elt) * c;",
                 "const int ncol = (c * elt + 15) / 16;",
                 "return threads / ncol > 1 ? threads / ncol : 1;",
                 "constexpr int S = kRegs * static_cast<int>(sizeof(T)) / 16;",
                 "const int r0 = static_cast<int>(static_cast<long long>(rank) * hw / cs);"):
        assert line in src, line
    # one hand-computed layout: bf16 [*, 32, 32, 256] over 8 ranks, 256
    # threads over 32 columns of 8 channels: 128 rows x 512 B, 8 lanes x 256
    # x 4 B, 32 groups; the lanes follow the channels' bytes, not the load
    assert G._slab_smem(1024, 256, 32, 8, 256, 2) == 65536 + 8192 + 32 * 24
    assert G._stream_route(16, 65536, 128, 4, 4).smem == 8 * 8 * 128
    assert G._stream_route(16, 65536, 128, 4, 1).smem == 8 * 8 * 128


@pytest.mark.parametrize("hw,cluster", [(1, 1), (15, 4), (63, 16), (64, 16), (1024, 3),
                                        (1024, 8), (4096, 16), (4096, 7), (100, 9),
                                        (65536, 13)])
def test_cluster_ranks_cover_the_image_once(hw, cluster):
    """Rank r of a slab cluster takes rows [r * hw // cs, (r + 1) * hw //
    cs): every row once, in rank order, no rank more than ceil(hw / cs)
    rows (the rows its shared memory is sized for), ragged included."""
    spans = G.cluster_rows(hw, cluster)
    assert len(spans) == cluster and spans[0][0] == 0 and spans[-1][1] == hw
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [b - a for a, b in spans]
    assert min(sizes) >= hw // cluster and max(sizes) <= -(-hw // cluster)
    covered = np.zeros(hw, np.int64)
    for a, b in spans:
        covered[a:b] += 1
    assert (covered == 1).all()
