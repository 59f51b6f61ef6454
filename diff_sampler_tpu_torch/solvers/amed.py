"""AMED: a trainable per-step midpoint predictor and the samplers it drives.

Counterpart of ``diff_sampler_tpu/solvers/amed.py``:

  * ``AMEDPredictor``: the small MLP that maps the channel-pooled U-Net
    bottleneck (8x8 = 64 values) and (t_cur, t_next) embeddings to r (the
    geometric-midpoint exponent), scale_dir (c_n) and scale_time (a_n);
  * the bottleneck tap: ``EDMPrecond.with_bottleneck`` returns the encoder
    activation explicitly (the JAX package uses ``capture_intermediates``,
    the reference a forward hook); ``CMPrecond``, ``CGPrecond`` and
    ``CFGPrecond`` return their U-Net's middle block (under doubled-batch
    guidance, its conditional half);
  * the AMED solver and the euler / ipndm / dpm / dpmpp plugins, which insert
    a predicted midpoint into every step (two denoiser calls per step).

The midpoint is per sample and carries a gradient, so the step coefficients
are computed on the device, as in the JAX package.  In training
(``train=True``) gradients flow through the frozen net into the predictor's
outputs; ``jax.lax.stop_gradient`` becomes ``detach`` and ``jax.checkpoint``
becomes ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.layers import Linear, positional_embedding
from ..models.precond import CFGPrecond, CGPrecond, CMPrecond
from .samplers import SampleResult, dynamic_thresholding

__all__ = [
    "AMEDPredictor",
    "BottleneckDenoiser",
    "bottleneck_module_name",
    "bind_with_bottleneck",
    "amed_sampler",
    "amed_euler_sampler",
    "amed_ipndm_sampler",
    "amed_dpm_2_sampler",
    "amed_dpm_pp_sampler",
    "AMED_SOLVER_REGISTRY",
]


class AMEDPredictor(nn.Module):
    """The AMED MLP.  Layer names are the JAX package's flax names, so its
    params convert both ways (``models.convert``).

    scale_dir / scale_time are range half-widths s: the head outputs
    2*s*sigmoid(.) + (1 - s) in [1-s, 1+s]; 0 disables the head (output 1).
    Parameters are allocated uninitialised; ``models.factory.init_params``
    draws them (xavier uniform, zero biases)."""

    def __init__(self, hidden_dim: int = 128, output_dim: int = 1,
                 bottleneck_input_dim: int = 64, bottleneck_output_dim: int = 4,
                 noise_channels: int = 8, scale_dir: float = 0.0, scale_time: float = 0.0,
                 device=None):
        super().__init__()
        init = dict(init_mode="xavier_uniform", device=device)
        in_dim = 2 * noise_channels + bottleneck_output_dim
        self.noise_channels = noise_channels
        self.scale_dir, self.scale_time = scale_dir, scale_time
        self.map_layer0 = Linear(noise_channels, noise_channels, **init)
        self.enc_layer0 = Linear(bottleneck_input_dim, hidden_dim, **init)
        self.enc_layer1 = Linear(hidden_dim, bottleneck_output_dim, **init)
        self.fc_r = Linear(in_dim, output_dim, **init)
        self.fc_scale_dir = Linear(in_dim, output_dim, **init) if scale_dir else None
        self.fc_scale_time = Linear(in_dim, output_dim, **init) if scale_time else None

    def _time_emb(self, t, batch: int):
        t = torch.as_tensor(t, dtype=torch.float32, device=self.fc_r.weight.device)
        e = positional_embedding(t.reshape(1), self.noise_channels, endpoint=True)
        e = e.reshape(1, 2, -1).flip(1).reshape(1, -1)  # swap sin/cos
        return F.silu(self.map_layer0(e)).expand(batch, -1)

    def forward(self, bottleneck, t_cur, t_next):
        """bottleneck: [B, 64] (or [B, 8, 8]); t_cur, t_next: scalars.
        Returns r, scale_dir, scale_time, each [B, 1, 1, 1]."""
        b = bottleneck.reshape(bottleneck.shape[0], -1).float()
        emb = torch.cat([self._time_emb(t_cur, b.shape[0]), self._time_emb(t_next, b.shape[0])],
                        dim=1)
        b = self.enc_layer1(F.silu(self.enc_layer0(b)))
        out = torch.cat([b, emb], dim=1)

        def head(layer, s):
            return 2.0 * s * torch.sigmoid(layer(out)) + (1.0 - s)

        r = torch.sigmoid(self.fc_r(out))
        sd = head(self.fc_scale_dir, self.scale_dir) if self.scale_dir else torch.ones_like(r)
        st = head(self.fc_scale_time, self.scale_time) if self.scale_time else torch.ones_like(r)
        shape = (-1, 1, 1, 1)
        return r.reshape(shape), sd.reshape(shape), st.reshape(shape)


def bottleneck_module_name(label_dim: int, img_resolution: int,
                           model_source: str = "edm") -> str:
    """The per-tier bottleneck tap, as a JAX module name."""
    if model_source in ("ldm", "sd") or img_resolution == 256:
        return "middle_block"
    return "enc_8x8_block2" if label_dim else "enc_8x8_block3"


@dataclasses.dataclass
class BottleneckDenoiser:
    """``denoise(x, t) -> D(x, t)``; ``with_bottleneck(x, t)`` -> (D(x, t),
    pooled bottleneck [B, 64]).  Autograd records through both: the caller
    decides with ``torch.no_grad``.  ``sigma_fn`` / ``sigma_inv_fn``: as on
    ``BoundDenoiser``."""

    fn: Callable
    plain_fn: Callable
    sigma_min: float
    sigma_max: float
    sigma_fn: Optional[Callable] = None
    sigma_inv_fn: Optional[Callable] = None

    def __call__(self, x, t):
        return self.plain_fn(x, t)

    def with_bottleneck(self, x, t):
        return self.fn(x, t)


def _pool_bottleneck(act, cfg_doubled: bool = False):
    """NHWC activation -> [B, h*w], the mean over channels (the reference
    mean-pools the hooked bottleneck); ``cfg_doubled`` keeps the conditional
    half of a doubled-batch classifier-free-guidance call
    (solvers_amed.py:33-39)."""
    pooled = act.mean(dim=-1).reshape(act.shape[0], -1)
    if cfg_doubled:
        pooled = pooled[pooled.shape[0] // 2:]
    return pooled


def bind_with_bottleneck(precond, cfg_doubled: bool = False, **cond) -> BottleneckDenoiser:
    """Bind a preconditioner so each call can also yield the channel-pooled
    bottleneck: an EDMPrecond at ``bottleneck_module_name`` (without
    conditioning); a CMPrecond or CGPrecond (the 256 px pixel tiers) at its
    ADMUNet's middle block, a CGPrecond with its integer ``class_labels=``
    bound; a CFGPrecond (the latent tiers) at its U-Net's middle block,
    with its conditioning keywords (``condition=``,
    ``unconditional_condition=``) bound and its sigma maps carried; under
    doubled-batch guidance ``cfg_doubled`` pools the conditional half.  The
    nets are frozen in place: every parameter stops requiring a gradient,
    so a backward through them computes input gradients only.  They must be
    in eval mode (dropout off)."""
    if precond.training:
        raise ValueError("bind_with_bottleneck() needs the module in eval mode: call .eval()")
    maps = ()
    if isinstance(precond, CFGPrecond):
        precond.latent_diffusion.requires_grad_(False)
        maps = (precond.sigma, precond.sigma_inv)
    elif isinstance(precond, (CMPrecond, CGPrecond)):
        for net in (precond.net, getattr(precond, "classifier", None)):
            if net is not None:
                net.requires_grad_(False)
    else:
        if cfg_doubled or cond:
            raise TypeError("an EDMPrecond is bound without conditioning (the AMED trainer "
                            "binds the EDM nets without labels)")
        precond.requires_grad_(False)
        name = bottleneck_module_name(precond.label_dim, precond.img_resolution)

        def fn(x, t):
            out, act = precond.with_bottleneck(x, t, name)
            return out, _pool_bottleneck(act)

        return BottleneckDenoiser(fn, precond, precond.sigma_min, precond.sigma_max)

    def fn_tap(x, t):
        out, act = precond.with_bottleneck(x, t, **cond)
        return out, _pool_bottleneck(act, cfg_doubled)

    def plain(x, t):
        return precond(x, t, **cond)

    return BottleneckDenoiser(fn_tap, plain, precond.sigma_min, precond.sigma_max, *maps)


_AB = [
    np.array([1.0]),
    np.array([3.0, -1.0]) / 2.0,
    np.array([23.0, -16.0, 5.0]) / 12.0,
    np.array([55.0, -59.0, 37.0, -9.0]) / 24.0,
]


def _ab_combo(d, buffer: List, order: int):
    w = _AB[order - 1]
    out = float(w[0]) * d
    for k in range(1, order):
        out = out + float(w[k]) * buffer[-k]
    return out


def _amed_family(
    denoise_b: BottleneckDenoiser,
    predictor: Callable,
    latents,
    t_steps,
    *,
    mode: str,  # 'amed' | 'euler' | 'ipndm' | 'dpm' | 'dpmpp'
    afs: bool = False,
    denoise_to_zero: bool = False,
    return_inters: bool = False,
    max_order: int = 4,
    predict_x0: bool = True,
    lower_order_final: bool = True,
    buffer_in: Optional[List] = None,
    buffer_t_in: Optional[List] = None,
    train: bool = False,
    step_idx: Optional[int] = None,
    total_num_steps: Optional[int] = None,
    bottleneck_dim: int = 64,
    dtype=torch.float32,
    remat: bool = False,
):
    """The AMED solver family in one function: a Python loop over steps,
    two denoiser calls per step (the predicted midpoint).

    ``predictor(bottleneck, t_cur, t_next) -> (r, scale_dir, scale_time)``.
    In training (``train=True``) the call covers ONE segment
    (t_steps = [t_cur, t_next]); ``step_idx``/``total_num_steps`` give its
    place in the full schedule (the dpmpp order bookkeeping) and the
    multistep buffers carry across calls.  Returns SampleResult, or in
    training (SampleResult, (buffer, buffer_t), (r, sd, st)).

    ``remat=True`` wraps each frozen-net call in ``torch.utils.checkpoint``:
    the backward recomputes the net's activations instead of storing them.
    """
    t = np.asarray(t_steps, dtype=np.float64)
    n = len(t) - 1
    dev = latents.device

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    x = latents.to(dtype) * scalar(t[0])
    inters = [x]
    buffer: List = list(buffer_in) if buffer_in else []  # eps (ipndm) / model (dpmpp)
    buf_t: List = list(buffer_t_in) if buffer_t_in else []
    r = sd = st = None
    n_total = total_num_steps if total_num_steps is not None else len(t)
    n_steps_eff = 2 * n_total - 1  # the predictor doubles the step count (dpmpp)

    def dpmpp_order(step_cur):
        if lower_order_final:
            return step_cur if step_cur < max_order else min(max_order, n_steps_eff - step_cur)
        return min(max_order, step_cur)

    if remat:
        def den_wb(xx, tt):
            return checkpoint(denoise_b.with_bottleneck, xx, tt, use_reentrant=False)

        def den(xx, tt):
            return checkpoint(denoise_b, xx, tt, use_reentrant=False)
    else:
        den_wb, den = denoise_b.with_bottleneck, denoise_b

    for i in range(n):
        t_cur, t_next = scalar(t[i]), scalar(t[i + 1])
        if train:
            use_afs = afs and (step_idx == 0 if mode != "ipndm" else len(buffer) == 0)
            step_cur = 2 * step_idx + 1
        else:
            use_afs = afs and (len(buffer) == 0 if mode in ("ipndm", "dpmpp") else i == 0)
            step_cur = 2 * i + 1

        if use_afs:
            d_cur = x / torch.sqrt(1.0 + t_cur ** 2)
            denoised = x - t_cur * d_cur
            bott = torch.zeros((latents.shape[0], bottleneck_dim), dtype=dtype, device=dev)
        else:
            denoised, bott = den_wb(x, t_cur)
            d_cur = (x - denoised) / t_cur

        r, sd, st = predictor(bott, t_cur, t_next)
        r, sd, st = r.to(dtype), sd.to(dtype), st.to(dtype)
        t_mid = (t_next ** r) * (t_cur ** (1.0 - r))

        x_cur = x
        if mode in ("amed", "euler", "dpm"):
            x = x_cur + (t_mid - t_cur) * d_cur
        elif mode == "ipndm":
            order = min(max_order, len(buffer) + 1)
            x = x_cur + (t_mid - t_cur) * _ab_combo(d_cur, buffer, order)
            _push(buffer, d_cur.detach(), max_order - 1)
        elif mode == "dpmpp":
            m0 = dynamic_thresholding(denoised) if predict_x0 else d_cur
            _push_unbounded(buffer, m0, 3)
            _push_unbounded(buf_t, t_cur, 3)
            x = _dpmpp_update_traced(x_cur, buffer, buf_t, t_mid,
                                     min(dpmpp_order(step_cur), len(buffer)), predict_x0)
        else:
            raise ValueError(mode)

        # Second (midpoint) evaluation at scale_time * t_mid.
        denoised_mid = den(x, (st * t_mid).reshape(-1))
        d_mid = (x - denoised_mid) / t_mid

        if mode == "amed":
            x = x_cur + sd * (t_next - t_cur) * d_mid
        elif mode == "euler":
            x = x + sd * (t_next - t_mid) * d_mid
        elif mode == "dpm":
            x = x_cur + sd * (t_next - t_cur) * (
                (1.0 / (2.0 * r)) * d_mid + (1.0 - 1.0 / (2.0 * r)) * d_cur)
        elif mode == "ipndm":
            order = min(max_order, len(buffer) + 1)
            x = x + sd * (t_next - t_mid) * _ab_combo(d_mid, buffer, order)
            _push(buffer, d_mid.detach(), max_order - 1)
        elif mode == "dpmpp":
            m_mid = dynamic_thresholding(denoised_mid) if predict_x0 else d_mid
            _push_unbounded(buffer, m_mid, 3)
            _push_unbounded(buf_t, t_mid, 3)
            x = _dpmpp_update_traced(x, buffer, buf_t, t_next,
                                     min(dpmpp_order(step_cur + 1), len(buffer)),
                                     predict_x0, scale_dir=sd)
            buffer = [m.detach() for m in buffer]
            buf_t = [tt.detach() for tt in buf_t]
        if return_inters:
            inters.append(x)

    if denoise_to_zero:
        x = denoise_b(x, scalar(t[-1]))
        if return_inters:
            inters.append(x)

    xs = torch.stack(inters) if return_inters else None
    if train:
        return SampleResult(x=x, xs=xs), (buffer, buf_t), (r, sd, st)
    return SampleResult(x=x, xs=xs)


def _push(buf: List, v, maxlen: int):
    if maxlen <= 0:
        return
    if len(buf) == maxlen:
        del buf[0]
    buf.append(v)


def _push_unbounded(buf: List, v, keep: int):
    buf.append(v)
    if len(buf) > keep:
        del buf[0]


def _dpmpp_update_traced(x, buf_m, buf_t, t_to, order, predict_x0, scale_dir=None):
    """DPM-Solver++ multistep update with per-sample times (the dpm_pp plugin
    of the AMED reference)."""
    t = t_to
    m0, t0 = buf_m[-1], buf_t[-1]
    lam_t, lam0 = -torch.log(t), -torch.log(t0)
    h = lam_t - lam0
    sd = scale_dir if scale_dir is not None else 1.0
    if predict_x0:
        phi_1 = torch.expm1(-h)
        if order == 1:
            return (t / t0) * x - sd * phi_1 * m0
        lam1 = -torch.log(buf_t[-2])
        r0 = (lam0 - lam1) / h
        d1_0 = (m0 - buf_m[-2]) / r0
        if order == 2:
            return (t / t0) * x - sd * (phi_1 * m0 + 0.5 * phi_1 * d1_0)
        lam2 = -torch.log(buf_t[-3])
        r1 = (lam1 - lam2) / h
        d1_1 = (buf_m[-2] - buf_m[-3]) / r1
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (d1_0 - d1_1) / (r0 + r1)
        phi_2 = phi_1 / h + 1.0
        phi_3 = phi_2 / h - 0.5
        return (t / t0) * x - sd * (phi_1 * m0 - phi_2 * d1 + phi_3 * d2)
    phi_1 = torch.expm1(h)
    if order == 1:
        return x - sd * t * phi_1 * m0
    lam1 = -torch.log(buf_t[-2])
    r0 = (lam0 - lam1) / h
    d1_0 = (m0 - buf_m[-2]) / r0
    if order == 2:
        return x - sd * (t * phi_1 * m0 + 0.5 * t * phi_1 * d1_0)
    lam2 = -torch.log(buf_t[-3])
    r1 = (lam1 - lam2) / h
    d1_1 = (buf_m[-2] - buf_m[-3]) / r1
    d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
    d2 = (d1_0 - d1_1) / (r0 + r1)
    phi_2 = phi_1 / h - 1.0
    phi_3 = phi_2 / h - 0.5
    return x - sd * (t * phi_1 * m0 + t * phi_2 * d1 + t * phi_3 * d2)


def _make(mode):
    def sampler(denoise_b, predictor, latents, t_steps, **kw):
        return _amed_family(denoise_b, predictor, latents, t_steps, mode=mode, **kw)

    sampler.__name__ = f"amed_{mode}_sampler"
    return sampler


amed_sampler = _make("amed")
amed_euler_sampler = _make("euler")
amed_ipndm_sampler = _make("ipndm")
amed_dpm_2_sampler = _make("dpm")
amed_dpm_pp_sampler = _make("dpmpp")

AMED_SOLVER_REGISTRY = {
    "amed": amed_sampler,
    "euler": amed_euler_sampler,
    "ipndm": amed_ipndm_sampler,
    "dpm": amed_dpm_2_sampler,
    "dpmpp": amed_dpm_pp_sampler,
}
