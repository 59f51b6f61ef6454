"""Driver of a sampling job: ``sampling.generate`` on one long seed list, as
``cli/sample.py`` hands it to the library, closed loop: the next batch goes
out when the previous one returns.

Traffic parameters (``traffic/<name>.json``): ``batch``; the solver
(``solver``, ``num_steps``, ``max_order``, ``schedule_type``,
``schedule_rho``); ``guidance_rate`` (classifier-free guidance on drawn
contexts where ``contexts`` is set: [77, 768] per seed and one for the empty
prompt); ``decode`` (each batch's latents decoded through
``LatentDiffusion.decode_in_chunks`` in ``generate``'s ``batch_callback``,
``decode_chunk`` at a time); ``seed_list`` (the length of the list, more
than a window reaches); ``trace_batches`` (the batches a traced run records).

The window starts once the first batch has been handed back, when the
pipeline is full: ``generate`` hands batch i back only after enqueueing
batch i+1, which the launch queue lets run only a little ahead of the
device (and a decode queues behind it), so the first batch comes back after
about two batches of device time.  It ends at the callback of the first
batch handed back once ``--seconds`` have passed.  The images handed
back (decoded, where the job decodes) after the first batch, over the
window's time, are the rate.  The first batch counts in set-up, so no work
falls between set-up and the window.
A traced run records its first ``trace_batches`` batches under the profiler
as a ``generate`` call of their own, then goes on untraced.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import weights
from ..core import image_seeds, load_module, stream_seed
from ..inputs import latents, span
from ..reference import solvers as ref_solvers
from ..work import call_work


class StopWindow(Exception):
    """Raised from the batch callback once the window has run its time."""


SPANS = ("generate", "denoiser call", "batch callback", "decode")


def run(ctx) -> dict:
    cfg, traffic, check = ctx.config, ctx.traffic, ctx.check
    device = ctx.device
    from diff_sampler_tpu_torch.models.precond import bind
    from diff_sampler_tpu_torch.sampling import SolverConfig, generate

    ref_mod = load_module("reference", cfg["reference"])
    batch, guided = traffic["batch"], traffic.get("contexts", False)
    with ctx.phase("weights"):
        names = ref_mod.checkpoint_names(ref_mod.build(cfg, device="meta"))
        state = weights.draw(names, ctx.seed, device)
    with ctx.phase("build"):
        module = load_module("programs", cfg["program"]["builder"]).build(
            cfg, state, dtype=ctx.dtype, device=device,
            guidance_rate=traffic.get("guidance_rate", 1.0))
        del state
    with ctx.phase("inputs"):
        shape = ref_mod.latents_shape(cfg)
        seeds = image_seeds(ctx.seed, traffic["seed_list"])
        warm = image_seeds(stream_seed(ctx.seed, 9), batch)
        contexts = uc = None
        cond = {}
        if guided:
            c = cfg["model"]["context"]
            g = torch.Generator(device=device).manual_seed(stream_seed(ctx.seed, 2))
            # per-seed contexts stay on the host, as the CLI's encoded captions
            # do: ``generate`` moves each batch's rows
            contexts = torch.randn((len(seeds) + batch, c["tokens"], c["dim"]), generator=g,
                                   device=device).cpu()
            uc = torch.randn((1, c["tokens"], c["dim"]), generator=g, device=device)
            cond["unconditional_condition"] = uc
        solver = SolverConfig(solver=traffic["solver"], num_steps=traffic["num_steps"],
                              schedule_type=traffic["schedule_type"],
                              schedule_rho=traffic["schedule_rho"],
                              max_order=traffic.get("max_order"))
        nfe = traffic["num_steps"] - 1
        if solver.nfe() != nfe:
            raise RuntimeError(f"the system counts {solver.nfe()} NFE where the job has {nfe}")
        den = bind(module, **cond)
        decode = module.latent_diffusion.decode_in_chunks if traffic.get("decode") else None

    traced = {"on": False}
    if ctx.trace:
        fn = den.fn

        def spanned(*a, **k):
            with span(traced["on"], "denoiser call"):
                return fn(*a, **k)

        den = dataclasses.replace(den, fn=spanned)

    delivered, offsets = [], {"base": 0}
    clock = {"t0": None, "first": 0, "stop_after": None, "decode_s": 0.0}

    def on_batch(start, x):
        with span(traced["on"], "batch callback"):
            if decode is not None:
                if traced["on"]:
                    ctx.sync()
                t = time.perf_counter()
                with span(traced["on"], "decode"):
                    x = decode(x, chunk=traffic["decode_chunk"])
                clock["decode_s"] += time.perf_counter() - t
            delivered.append((offsets["base"] + start, np.array(x, dtype=np.float32)))
        stop = clock["stop_after"]
        if stop is None:
            return
        now = time.perf_counter()
        clock["end"] = now
        if clock["t0"] is None:
            clock["t0"], clock["first"] = now, len(delivered)
        elif now - clock["t0"] >= stop:
            raise StopWindow

    def gen(lo, hi):
        offsets["base"] = lo
        with span(traced["on"], "generate"):
            generate(den, seeds[lo:hi], shape, solver, max_batch_size=batch, device=device,
                     per_seed_cond=None if contexts is None else contexts[lo:hi],
                     batch_callback=on_batch)

    with ctx.phase("warmup"):
        generate(den, warm, shape, solver, max_batch_size=batch, device=device,
                 per_seed_cond=None if contexts is None else contexts[-batch:],
                 batch_callback=(lambda s, x: decode(x, chunk=traffic["decode_chunk"]))
                 if decode is not None else None)
        ctx.sync()

    # a traced run counts the work of its batches in set-up (a traced run
    # reports no set-up time)
    work = batch_work(ref_mod, cfg, traffic, shape, nfe) if ctx.trace else None
    ctx.window_start()
    prof = None
    lo = 0
    if ctx.trace:
        t0 = time.perf_counter()
        k = traffic["trace_batches"] * batch
        prof = torch.profiler.profile(activities=ctx.profiler_activities())
        prof.start()
        traced["on"] = True
        gen(0, k)
        ctx.sync()
        traced_s = time.perf_counter() - t0
        traced_decode_s = clock["decode_s"]
        traced["on"] = False
        prof.stop()
        lo = k
    clock["stop_after"] = ctx.seconds
    filled = time.perf_counter()
    try:
        gen(lo, len(seeds))
    except StopWindow:
        pass
    ctx.sync()
    if clock["first"] == len(delivered):
        raise RuntimeError("the seed list ran out before a second batch came back")
    if not ctx.trace:
        ctx.setup["first batch"] = clock["t0"] - filled
        ctx.setup_s += clock["t0"] - filled
    window_s = clock["end"] - clock["t0"]
    n_images = sum(len(x) for _, x in delivered[clock["first"]:])
    if sum(len(x) for _, x in delivered) < lo:
        raise RuntimeError("the traced batches did not all come back")
    out = {"units": n_images, "window_s": window_s,
           "attempted": sum(len(x) for _, x in delivered),
           "peak_bytes": ctx.peak_bytes(),
           "e2e": {"images_per_s": n_images / window_s}}
    if prof is not None:
        out["trace"] = {"prof": prof, "spans": SPANS, "window_s": traced_s,
                        "work": work.scaled(traffic["trace_batches"]),
                        "decode_s": traced_decode_s if decode is not None else None}

    # the comparison: a sample drawn from the seed of the images handed back
    del den, module, decode
    ctx.free()
    index = {}
    for start, x in delivered:
        for i in range(len(x)):
            index[start + i] = (x, i)
    bad = sum(int(not np.isfinite(img).all()) for _, x in delivered for img in x)
    rng = np.random.default_rng(stream_seed(ctx.seed, 4))
    positions = sorted(rng.choice(sorted(index), size=min(check["images"], len(index)),
                                  replace=False).tolist())
    got = np.stack([index[p][0][index[p][1]] for p in positions])
    ref = ref_mod.build(cfg, device=device)
    ref.load_state_dict(weights.draw(ref_mod.checkpoint_names(ref), ctx.seed, device),
                        assign=True)
    den_ref = ref_mod.denoiser(ref, cfg, traffic)
    if traffic["schedule_type"] == "discrete":
        t_steps = ref_mod.discrete_schedule(ref, traffic["num_steps"], traffic["schedule_rho"])
    else:
        lo_s, hi_s = ref_mod.sigma_range(cfg, ref)
        t_steps = ref_solvers.polynomial_schedule(traffic["num_steps"], lo_s, hi_s,
                                                  traffic["schedule_rho"])
    solve = ref_solvers.SOLVERS[traffic["solver"]]
    order = {"max_order": traffic["max_order"]} if traffic.get("max_order") else {}
    want = []
    with ctx.reference_precision(), torch.no_grad():
        rows = check["reference_rows"]
        for i in range(0, len(positions), rows):
            pos = positions[i:i + rows]
            lat = latents([seeds[p] for p in pos], shape, device)
            cond = (contexts[pos].to(device), uc) if guided else None
            x = solve(lambda x, s: den_ref(x, s, cond), lat, t_steps, **order)
            if traffic.get("decode"):
                x = ref_mod.decode(ref, x)
            want.append(x.float().cpu().numpy())
    out["failed"] = bad
    out["readings"] = compare(got, np.concatenate(want))
    return out


def batch_work(ref_mod, cfg, traffic, shape, nfe: int):
    """The work of one batch, counted from the reference on the meta
    device: ``nfe`` denoiser calls (CFG's doubled rows inside) and, where the
    job decodes, the decode."""
    batch = traffic["batch"]
    ref = ref_mod.build(cfg, device="meta")
    den_ref = ref_mod.denoiser(ref, cfg, traffic)
    if traffic.get("contexts"):
        c = cfg["model"]["context"]
        call = call_work(lambda x, ctx, uc: den_ref(x, 1.0, (ctx, uc)), (batch,) + tuple(shape),
                         (batch, c["tokens"], c["dim"]), (1, c["tokens"], c["dim"]))
    else:
        call = call_work(lambda x: den_ref(x, 1.0, None), (batch,) + tuple(shape))
    work = call.scaled(nfe)
    if traffic.get("decode"):
        work += call_work(lambda z: ref_mod.decode(ref, z), (batch,) + tuple(shape))
    return work


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """Per answer, the L2 distance from the reference over the reference's
    L2 norm, and the largest element distance over the reference's largest
    magnitude; their worst over the sample, and the mean of the first."""
    got = got.reshape(len(got), -1).astype(np.float64)
    want = want.reshape(len(want), -1).astype(np.float64)
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    peak = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    return {"worst_rel_l2": float(np.nan_to_num(rel.max(), nan=np.inf)),
            "mean_rel_l2": float(np.nan_to_num(rel.mean(), nan=np.inf)),
            "worst_rel_max": float(np.nan_to_num(peak.max(), nan=np.inf))}
