"""The port's direct 3x3 conv entry points (kernel K4's wrappers) on the
CPU, where they take the plain version, against the JAX package's Pallas
kernel in interpret mode.

The shapes of ``tests/test_pallas_conv.py``, both entry points, f32 within
1e-5 of max|ref| (both sum in f32, in other orders) and bf16 within 2^-7 of
max|ref| (one bf16 step of the largest output, for an element whose f32 sums
straddle a rounding boundary).  b ~ 0.5 in the GroupNorm fold, so a halo
computed as silu(b) in place of 0 would show (by ~1.6 at 8x8x128).

The bf16 kernel's tile plan (``conv_plan``) is checked here too, with no
card: its tiles cover every output pixel exactly once, each tap's halo view
reads the right image pixel, the TMA boxes and strides and the shared
memory fit, and its constants are the C source's.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops import pallas_conv as J
from diff_sampler_tpu_torch.cli import conv_variants as CV
from diff_sampler_tpu_torch.ops import conv as C

SHAPES = [(2, 8, 8, 128, 128), (3, 4, 4, 128, 256), (1, 8, 4, 256, 128)]
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    a = (1 + 0.1 * rng.randn(n, cin)).astype(np.float32)
    b = (0.5 + 0.1 * rng.randn(n, cin)).astype(np.float32)
    return x, wt, bias, a, b


def _check(ours, ref, dtype):
    ref = np.asarray(ref.astype(jnp.float32))
    ours = ours.float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
def test_conv3x3_matches_jax_interpret(n, h, w, cin, cout, dtype):
    x, wt, bias, _, _ = _inputs(n, h, w, cin, cout)
    ref = J.conv3x3(jnp.asarray(x).astype(dtype), jnp.asarray(wt), jnp.asarray(bias),
                    interpret=True)
    ours = C.conv3x3(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(wt),
                     torch.from_numpy(bias))
    assert ours.dtype == getattr(torch, dtype)
    _check(ours, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
def test_gn_silu_conv3x3_matches_jax_interpret(n, h, w, cin, cout, dtype):
    x, wt, bias, a, b = _inputs(n, h, w, cin, cout, seed=1)
    ref = J.gn_silu_conv3x3(jnp.asarray(x).astype(dtype), jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(wt), jnp.asarray(bias), interpret=True)
    ours = C.gn_silu_conv3x3(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(a),
                             torch.from_numpy(b), torch.from_numpy(wt), torch.from_numpy(bias))
    _check(ours, ref, dtype)


def test_halo_is_zero_after_the_prologue():
    """Padding before the prologue (silu(b) at the border) moves the output
    far past the tolerance; the port's plain version agrees with the JAX
    kernel, whose padded scratch is zero."""
    x, wt, _, a, b = _inputs(2, 8, 8, 128, 128, seed=2)
    ref = np.asarray(J.gn_silu_conv3x3(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(wt), interpret=True))
    ours = C.gn_silu_conv3x3(*(torch.from_numpy(v) for v in (x, a, b, wt))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    wrong = C.gn_silu_conv3x3(*(torch.from_numpy(v) for v in (xp, a, b, wt))).numpy()[:, 1:-1, 1:-1]
    assert np.abs(wrong - ref).max() > 100 * 1e-5 * np.abs(ref).max()


def test_supported_holds_wherever_jax_holds():
    for n, h, w in [(1, 1, 1), (5, 8, 8), (3, 7, 5), (256, 32, 32)]:
        for cin in (8, 96, 128, 256, 384):
            for cout in (8, 96, 128, 256, 384):
                if J.supported(n, h, w, cin, cout):
                    assert C.supported(n, h, w, cin, cout)
    assert C.supported(3, 7, 5, 128, 384) and C.supported(2, 4, 4, 24, 40)
    assert not C.supported(2, 8, 8, 12, 128) and not C.supported(2, 8, 8, 128, 100)
    assert not C.supported(0, 8, 8, 128, 128)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, wt, bias, a, b = (torch.from_numpy(v) for v in _inputs(1, 4, 4, 128, 128, seed=3))
    before = C.conv3x3.launches
    assert torch.equal(C.conv3x3(x, wt, bias), C.reference_conv3x3(x, wt, bias))
    assert torch.equal(C.gn_silu_conv3x3(x, a, b, wt, bias),
                       C.reference_conv3x3(x, wt, bias, a, b))
    assert C.conv3x3.launches == before


# The bf16 kernel's tile plan (ops/conv.py::conv_plan, the mirror of
# csrc/conv3x3.cu's tiling), checked without a card.  Shape families: one
# pixel, W = 1, narrow and ragged images, patches of whole rows (W <= 32),
# images cut into 32-column patches (W = 33, 64, 300 and W + 2 > 256), the
# CIFAR-10 and FFHQ main shapes, channels below, between and above 64 / 128.
PLAN_SHAPES = [(1, 1, 1, 8, 8), (2, 9, 1, 8, 8), (2, 7, 5, 72, 120), (3, 7, 5, 128, 384),
               (4, 9, 11, 24, 40), (2, 5, 6, 136, 72), (2, 8, 8, 128, 128), (2, 9, 31, 256, 8),
               (2, 9, 32, 8, 384), (2, 9, 33, 256, 128), (2, 4, 64, 72, 120), (2, 3, 300, 128, 8),
               (1, 300, 3, 16, 16), (1, 2, 600, 8, 16), (256, 32, 32, 256, 256),
               (256, 64, 64, 128, 128)]


def _plan_pixels(n, h, w, cin, cout):
    """Every (tile, M row) of the plan as the kernel maps it: the output
    pixel it stores (or none), and for each tap the halo pixel its ldmatrix
    reads, as image coordinates."""
    p = C.conv_plan(n, h, w, cin, cout)
    t = np.arange(p.tiles)
    co, t = t % p.co_tiles, t // p.co_tiles
    tx, t = t % p.tiles_x, t // p.tiles_x
    ty, img = t % p.tiles_y, t // p.tiles_y
    m = np.arange(C.CONV_M)
    r, c = m // p.tile_w, m % p.tile_w
    y = (ty * p.tile_h)[:, None] + r[None]
    x = (tx * p.tile_w)[:, None] + c[None]
    stored = (r < p.tile_h)[None] & (y < h) & (x < w)
    return p, img, co, y, x, stored, r, c


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_covers_every_output_once(n, h, w, cin, cout):
    p, img, co, y, x, stored, _, _ = _plan_pixels(n, h, w, cin, cout)
    hits = np.zeros((n, h, w, p.co_tiles), np.int64)
    sel = np.broadcast_to(stored, y.shape)
    np.add.at(hits, (np.broadcast_to(img[:, None], y.shape)[sel], y[sel], x[sel],
                     np.broadcast_to(co[:, None], y.shape)[sel]), 1)
    assert (hits == 1).all()
    assert p.co_tiles * C.CONV_N >= cout > (p.co_tiles - 1) * C.CONV_N
    assert p.chunks * C.CONV_K >= cin > (p.chunks - 1) * C.CONV_K


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_halo_views_read_the_taps(n, h, w, cin, cout):
    """The consumers' address of output row m at tap (dy, dx), halo pixel
    p0 + dy * (tile_w + 2) + dx with p0 = r * (tile_w + 2) + c, lies in the
    halo box and is image pixel (y + dy - 1, x + dx - 1); the prologue's
    multiply-shift gives the halo row of every pixel it visits."""
    p, _, _, y, x, stored, r, c = _plan_pixels(n, h, w, cin, cout)
    hw2 = p.tile_w + 2
    box_pixels = p.halo_box[1] * p.halo_box[2]
    for dy in range(3):
        for dx in range(3):
            q = r * hw2 + c + dy * hw2 + dx
            assert q[r < p.tile_h].max() < box_pixels
            hr, hc = q // hw2, q % hw2
            y0, x0 = y - r[None], x - c[None]
            assert (np.where(stored, y0 + hr[None] - 1, y + dy - 1) == y + dy - 1).all()
            assert (np.where(stored, x0 + hc[None] - 1, x + dx - 1) == x + dx - 1).all()
    inv = (65536 + hw2 - 1) // hw2
    pix = np.arange(box_pixels + 3 * 12)
    assert ((pix * inv) >> 16 == pix // hw2).all()


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_fits_tma_and_shared_memory(n, h, w, cin, cout):
    p = C.conv_plan(n, h, w, cin, cout)
    assert 1 <= p.tile_h * p.tile_w <= C.CONV_M
    assert p.tile_w <= min(w, C.MAX_TILE_W) and p.tile_h <= h
    assert p.halo_box[1] * p.halo_box[2] <= C.HALO_MAX
    for box in (p.halo_box, p.w_box):
        assert all(1 <= d <= C.MAX_BOX for d in box)
        assert box[0] * 2 == 128  # one 128-byte swizzle row: 64 bf16 channels
    # global strides in bytes (all but the innermost dim): x [N, H, W, Cin],
    # w as [3 * 3, Cout, Cin]
    for stride in (2 * cin, 2 * cin * w, 2 * cin * w * h, 2 * cin, 2 * cin * cout):
        assert stride % 16 == 0
    assert p.smem <= C.SMEM_LIMIT
    assert p.smem == 1024 + C.HALO_STAGES * C.HALO_MAX * 128 + C.B_STAGES * C.CONV_N * 128 \
        + 8 * (3 * C.HALO_STAGES + 2 * C.B_STAGES) + C.EPI_BYTES


def test_conv_plan_constants_mirror_the_kernel_source():
    """The plan's constants, shared-memory sum and refusals are the C
    source's."""
    src = (Path(C.__file__).resolve().parent.parent / "csrc" / "conv3x3.cu").read_text()
    for name, value in (("kConvM", C.CONV_M), ("kConvN", C.CONV_N), ("kConvK", C.CONV_K),
                        ("kHaloMax", C.HALO_MAX), ("kHaloStages", C.HALO_STAGES),
                        ("kBStages", C.B_STAGES), ("kMaxBox", C.MAX_BOX)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int kEpiRows = 16, kEpiCols = 32;" in src
    assert C.EPI_BYTES == 8 * 16 * 32 * 2 and "constexpr int kConsumerWarps = 8;" in src
    for line in ("constexpr int kHaloBytes = kHaloMax * kConvK * 2;",
                 "constexpr int kBBytes = kConvN * kConvK * 2;",
                 "constexpr int kEpiBytes = kConsumerWarps * kEpiRows * kEpiCols * 2;",
                 "constexpr int kBarBytes = 8 * (3 * kHaloStages + 2 * kBStages);",
                 "1024 + kHaloStages * kHaloBytes + kBStages * kBBytes + kBarBytes + kEpiBytes;",
                 "tile_w < 1 || tile_h * tile_w > kConvM || (tile_h + 2) * (tile_w + 2) > kHaloMax ||",
                 "tile_w + 2 > kMaxBox || tile_h + 2 > kMaxBox",
                 "const cuuint32_t wbox[3] = {kConvK, kConvN, 1};"):
        assert line in src, line
    assert re.search(r"xbox\[4\] = \{kConvK, static_cast<cuuint32_t>\(tile_w \+ 2\),\s+"
                     r"static_cast<cuuint32_t>\(tile_h \+ 2\), 1\}", src)
    # the tile order of tile_of: output channels fastest, then columns, rows, images
    assert re.search(r"const int co = t % g.co_tiles;\s+t /= g.co_tiles;\s+"
                     r"const int tx = t % g.tiles_x;\s+t /= g.tiles_x;\s+"
                     r"const int ty = t % g.tiles_y;\s+r.n = t / g.tiles_y;", src)
    # the consumers' halo addressing that test_conv_plan_halo_views_read_the_taps mirrors
    assert "p0[mi] = r < g.tile_h ? r * hw2 + c : 0;" in src
    assert "const int shift = (tap / 3) * hw2 + tap % 3;" in src


def test_conv_variants_patch_the_kernel_source():
    """``cli/conv_variants.py`` times patched copies of ``csrc/conv3x3.cu``:
    each string a variant replaces occurs in the source exactly once."""
    src = (Path(C.__file__).resolve().parent.parent / "csrc" / "conv3x3.cu").read_text()
    assert set(CV.VARIANTS) == {"noprologue", "nostore", "tanh", "ilp4"}
    for name, patches in CV.VARIANTS.items():
        for old, _ in patches:
            assert src.count(old) == 1, name
