"""The port's direct 3x3 conv entry points (kernel K4's wrappers) on the
CPU, where they take the plain version, against the JAX package's Pallas
kernel in interpret mode.

The shapes of ``tests/test_pallas_conv.py``, both entry points, f32 within
1e-5 of max|ref| (both sum in f32, in other orders) and bf16 within 2^-7 of
max|ref| (one bf16 step of the largest output, for an element whose f32 sums
straddle a rounding boundary).  b ~ 0.5 in the GroupNorm fold, so a halo
computed as silu(b) in place of 0 would show (by ~1.6 at 8x8x128).

The kernels' tile plans (``conv_plan``, bf16 and f32) are checked here too,
with no card: their tiles cover every output pixel exactly once, each tap's
halo view reads the right image pixel, the TMA boxes and strides and the
shared memory fit, and their constants are the C source's.  So is the f32
kernel's arithmetic: ``split_tf32`` against a numpy emulation of
cvt.rna.tf32.f32, and a float64 emulation of the 3xTF32 conv on split
inputs against the plain version and the JAX kernel.
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


def _rna_tf32(x):
    """cvt.rna.tf32.f32 emulated in float64: x rounded to multiples of its
    TF32 step (10 mantissa bits; below the normal range the step of the
    smallest binade, 2^-136, as f32's subnormals keep their exponent), to
    nearest with ties away from zero."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)  # |x| in [2^(e-1), 2^e)
    step = np.ldexp(1.0, np.maximum(e, -125) - 11)
    with np.errstate(over="ignore"):
        return np.copysign(np.floor(np.abs(x64) / step + 0.5) * step, x64).astype(np.float32)


def test_split_tf32_matches_cvt_rna():
    """``split_tf32`` (int32 bit operations) against the float64 emulation:
    ties (1 + 2^-11 goes up, -(1 + 2^-11) down), negatives, subnormals,
    +-0, large magnitudes up to a carry into the next binade; hi + lo is x
    to within lo's own rounding (2^-22 of x)."""
    rng = np.random.RandomState(0)
    tie = 1 + 2.0 ** -11
    special = np.array([0.0, -0.0, tie, -tie, 1 + 3 * 2.0 ** -11, 1 - 2.0 ** -24, 2.0 ** -126,
                        1e-40, -3e-39, 1.4e-45, 65504.0, -1e30, 3e38, 3.4e38,
                        float(np.float32(2.0 ** 128 - 2.0 ** 104))], np.float32)
    x = np.concatenate([special, rng.randn(4096).astype(np.float32),
                        (rng.randn(512) * 1e-39).astype(np.float32),
                        (rng.randn(512) * 1e37).astype(np.float32)])
    hi, lo = (t.numpy() for t in C.split_tf32(torch.from_numpy(x)))
    want_hi = _rna_tf32(x)
    want_lo = _rna_tf32(x - want_hi)
    assert np.array_equal(hi.view(np.int32), want_hi.view(np.int32))
    assert np.array_equal(lo.view(np.int32), want_lo.view(np.int32))
    assert hi[2] == 1 + 2.0 ** -10 and hi[3] == -(1 + 2.0 ** -10) and lo[2] == -2.0 ** -11
    assert (hi.view(np.int32) & 0x1FFF == 0).all() and (lo.view(np.int32) & 0x1FFF == 0).all()
    finite = np.isfinite(hi)
    assert not finite[special.size - 1]  # rounds past the largest f32: inf, as the carry says
    hi, lo, x = hi[finite].astype(np.float64), lo[finite], x[finite]
    assert (np.abs(hi + lo - x) <= 2.0 ** -22 * np.abs(x) + 2.0 ** -136).all()


def _conv_3xtf32_f64(z, w, bias):
    """The f32 kernel's arithmetic in float64: z and w each split into TF32
    hi and lo, every product summed as lo(z) hi(w) + hi(z) lo(w) + hi(z)
    hi(w), lo lo dropped, then the bias."""
    n, h, wd, cin = z.shape
    zh, zl = (t.numpy().astype(np.float64) for t in C.split_tf32(torch.from_numpy(z)))
    wh, wl = (t.numpy().astype(np.float64) for t in C.split_tf32(torch.from_numpy(w)))
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    zh, zl = np.pad(zh, pad), np.pad(zl, pad)
    out = np.zeros((n, h, wd, w.shape[-1]))
    for dy in range(3):
        for dx in range(3):
            sh, sl = zh[:, dy:dy + h, dx:dx + wd], zl[:, dy:dy + h, dx:dx + wd]
            out += sl @ wh[dy, dx] + sh @ wl[dy, dx] + sh @ wh[dy, dx]
    return out + bias


@pytest.mark.parametrize("fused", [False, True], ids=["conv3x3", "gn_silu_conv3x3"])
@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
def test_3xtf32_conv_within_tolerance_of_plain_and_jax(n, h, w, cin, cout, fused):
    """3xTF32, as the f32 kernel sums it (in exact arithmetic: the card's
    own sums are held by the chip run), lies within the f32 tolerance, 1e-5
    of max|out|, of the plain version and of the JAX kernel in interpret
    mode."""
    x, wt, bias, a, b = _inputs(n, h, w, cin, cout, seed=4)
    xt, wtt, bt = torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias)
    if fused:
        at, btt = torch.from_numpy(a), torch.from_numpy(b)
        z = torch.nn.functional.silu(xt * at[:, None, None] + btt[:, None, None]).numpy()
        plain = C.reference_conv3x3(xt, wtt, bt, at, btt).numpy()
        ref = np.asarray(J.gn_silu_conv3x3(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(wt), jnp.asarray(bias), interpret=True))
    else:
        z = x
        plain = C.reference_conv3x3(xt, wtt, bt).numpy()
        ref = np.asarray(J.conv3x3(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                                   interpret=True))
    got = _conv_3xtf32_f64(z, wt, bias)
    for want in (plain, ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


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


def _plan_pixels(n, h, w, cin, cout, dtype=torch.bfloat16):
    """Every (tile, M row) of the plan as the kernel maps it: the output
    pixel it stores (or none), and for each tap the halo pixel its ldmatrix
    reads, as image coordinates."""
    p = C.conv_plan(n, h, w, cin, cout, dtype)
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


def _covers_every_output_once(n, h, w, cin, cout, dtype, tile_n, chunk):
    p, img, co, y, x, stored, _, _ = _plan_pixels(n, h, w, cin, cout, dtype)
    hits = np.zeros((n, h, w, p.co_tiles), np.int64)
    sel = np.broadcast_to(stored, y.shape)
    np.add.at(hits, (np.broadcast_to(img[:, None], y.shape)[sel], y[sel], x[sel],
                     np.broadcast_to(co[:, None], y.shape)[sel]), 1)
    assert (hits == 1).all()
    assert (p.tile_n, p.chunk) == (tile_n, chunk)
    assert p.co_tiles * tile_n >= cout > (p.co_tiles - 1) * tile_n
    assert p.chunks * chunk >= cin > (p.chunks - 1) * chunk


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_covers_every_output_once(n, h, w, cin, cout):
    _covers_every_output_once(n, h, w, cin, cout, torch.bfloat16, C.CONV_N, C.CONV_K)


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_f32_covers_every_output_once(n, h, w, cin, cout):
    _covers_every_output_once(n, h, w, cin, cout, torch.float32, C.CONV_N32, C.CONV_K32)


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_halo_views_read_the_taps(n, h, w, cin, cout):
    _halo_views_read_the_taps(n, h, w, cin, cout, torch.bfloat16)


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_f32_halo_views_read_the_taps(n, h, w, cin, cout):
    _halo_views_read_the_taps(n, h, w, cin, cout, torch.float32)


def _halo_views_read_the_taps(n, h, w, cin, cout, dtype):
    """The consumers' address of output row m at tap (dy, dx), halo pixel
    p0 + dy * (tile_w + 2) + dx with p0 = r * (tile_w + 2) + c, lies in the
    halo box and is image pixel (y + dy - 1, x + dx - 1); the prologue's
    multiply-shift gives the halo row of every pixel it visits."""
    p, _, _, y, x, stored, r, c = _plan_pixels(n, h, w, cin, cout, dtype)
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


def _fits_tma_and_shared_memory(n, h, w, cin, cout, dtype):
    p = C.conv_plan(n, h, w, cin, cout, dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    assert 1 <= p.tile_h * p.tile_w <= C.CONV_M
    assert p.tile_w <= min(w, C.MAX_TILE_W) and p.tile_h <= h
    assert p.halo_box[1] * p.halo_box[2] <= C.HALO_MAX
    for box in (p.halo_box, p.w_box):
        assert all(1 <= d <= C.MAX_BOX for d in box)
        assert box[0] * elt == 128  # one 128-byte swizzle row: 64 bf16 or 32 f32 channels
    # global strides in bytes (all but the innermost dim): x [N, H, W, Cin],
    # w as [3 * 3, Cout, Cin]
    for stride in (elt * cin, elt * cin * w, elt * cin * w * h, elt * cin, elt * cin * cout):
        assert stride % 16 == 0
    assert p.smem <= C.SMEM_LIMIT
    return p


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_fits_tma_and_shared_memory(n, h, w, cin, cout):
    p = _fits_tma_and_shared_memory(n, h, w, cin, cout, torch.bfloat16)
    assert p.smem == 1024 + C.HALO_STAGES * C.HALO_MAX * 128 + C.B_STAGES * C.CONV_N * 128 \
        + 8 * (3 * C.HALO_STAGES + 2 * C.B_STAGES) + C.EPI_BYTES


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_SHAPES)
def test_conv_plan_f32_fits_tma_and_shared_memory(n, h, w, cin, cout):
    """f32: each B stage holds the tiles of w_hi and w_lo; no epilogue
    staging."""
    p = _fits_tma_and_shared_memory(n, h, w, cin, cout, torch.float32)
    assert p.smem == 1024 + C.HALO_STAGES * C.HALO_MAX * 128 \
        + C.B_STAGES32 * 2 * C.CONV_N32 * 128 + 8 * (3 * C.HALO_STAGES + 2 * C.B_STAGES32)


def test_conv_plan_constants_mirror_the_kernel_source():
    """The plan's constants, shared-memory sums and refusals are the C
    source's, for both kernels."""
    src = (Path(C.__file__).resolve().parent.parent / "csrc" / "conv3x3.cu").read_text()
    for name, value in (("kConvM", C.CONV_M), ("kConvN", C.CONV_N), ("kConvK", C.CONV_K),
                        ("kHaloMax", C.HALO_MAX), ("kHaloStages", C.HALO_STAGES),
                        ("kBStages", C.B_STAGES), ("kMaxBox", C.MAX_BOX),
                        ("kConvN32", C.CONV_N32), ("kConvK32", C.CONV_K32),
                        ("kBStages32", C.B_STAGES32)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int kEpiRows = 16, kEpiCols = 32;" in src
    assert C.EPI_BYTES == 8 * 16 * 32 * 2 and "constexpr int kConsumerWarps = 8;" in src
    for line in ("constexpr int kHaloBytes = kHaloMax * kConvK * 2;",
                 "constexpr int kBBytes = kConvN * kConvK * 2;",
                 "constexpr int kEpiBytes = kConsumerWarps * kEpiRows * kEpiCols * 2;",
                 "constexpr int kBarBytes = 8 * (3 * kHaloStages + 2 * kBStages);",
                 "1024 + kHaloStages * kHaloBytes + kBStages * kBBytes + kBarBytes + kEpiBytes;",
                 "constexpr int kBTile32 = kConvN32 * kConvK32 * 4;",
                 "constexpr int kBBytes32 = 2 * kBTile32;",
                 "constexpr int kBarBytes32 = 8 * (3 * kHaloStages + 2 * kBStages32);",
                 "1024 + kHaloStages * kHaloBytes + kBStages32 * kBBytes32 + kBarBytes32;",
                 "tile_w < 1 || tile_h * tile_w > kConvM || (tile_h + 2) * (tile_w + 2) > kHaloMax ||",
                 "tile_w + 2 > kMaxBox || tile_h + 2 > kMaxBox",
                 "const cuuint32_t wbox[3] = {static_cast<cuuint32_t>(chunk), "
                 "static_cast<cuuint32_t>(tile_n), 1};",
                 "tile_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kConvN32, kConvK32))",
                 "tile_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kConvN, kConvK))"):
        assert line in src, line
    assert re.search(r"xbox\[4\] = \{static_cast<cuuint32_t>\(chunk\), "
                     r"static_cast<cuuint32_t>\(tile_w \+ 2\),\s+"
                     r"static_cast<cuuint32_t>\(tile_h \+ 2\), 1\}", src)
    # the tile order of tile_of: output channels fastest, then columns, rows, images
    assert re.search(r"const int co = t % g.co_tiles;\s+t /= g.co_tiles;\s+"
                     r"const int tx = t % g.tiles_x;\s+t /= g.tiles_x;\s+"
                     r"const int ty = t % g.tiles_y;\s+r.n = t / g.tiles_y;", src)
    assert "r.n0 = co * kN;" in src
    assert "tile_of<kConvN>(g, tile)" in src and "tile_of<kConvN32>(g, tile)" in src
    # the consumers' halo addressing that test_conv_plan_halo_views_read_the_taps
    # mirrors, the same in both kernels
    assert src.count("p0[mi] = r < g.tile_h ? r * hw2 + c : 0;") == 2
    assert src.count("const int shift = (tap / 3) * hw2 + tap % 3;") == 2


def test_conv_variants_patch_the_kernel_source():
    """``cli/conv_variants.py`` times patched copies of ``csrc/conv3x3.cu``:
    each string a variant replaces occurs in the source exactly once."""
    src = (Path(C.__file__).resolve().parent.parent / "csrc" / "conv3x3.cu").read_text()
    assert set(CV.VARIANTS) == {"noprologue", "nostore", "tanh", "ilp4"}
    assert set(CV.F32_VARIANTS) == {"nofold", "fold1", "fold3", "fold5", "noprologue", "nostore"}
    for name, patches in [*CV.VARIANTS.items(), *CV.F32_VARIANTS.items()]:
        for old, _ in patches:
            assert src.count(old) == 1, name
