"""Sampling CLI of the port: seeds -> per-seed PNGs, a grid or a trajectory.

Counterpart of ``diff_sampler_tpu/cli/sample.py`` for the pixel EDM tiers,
the 256 px pixel tiers (the consistency-models ``lsun_bedroom`` /
``lsun_cat`` and the classifier-guided ``imagenet256``), the unconditional
latent tiers and Stable Diffusion, on random weights or a reference
checkpoint.  It takes the JAX CLI's solver, schedule, guidance and
GITS flags (the reference's SOLVER_FLAGS, SCHEDULE_FLAGS, ADDITIONAL_FLAGS,
GUIDANCE_FLAGS and GITS_FLAGS):

  python -m diff_sampler_tpu_torch.cli.sample --dataset_name=cifar10 \\
      --model_path=random --solver=ipndm --num_steps=6 --seeds=0-255 \\
      --batch=256 --bf16=True --device=cuda --outdir=out/
  # a reference checkpoint: EDM's .pkl, or None for the zoo's file in
  # ./src, ./models or ./checkpoints (nothing is downloaded)
  ... --dataset_name=cifar10 --model_path=edm-cifar10-32x32-uncond-vp.pkl
  # UniPC on FFHQ-64, one grid
  ... --dataset_name=ffhq --solver=unipc --variant=bh2 --grid=True
  # GITS: search the schedule before sampling
  ... --dp=True --num_steps_tea=61 --num_warmup=256 --metric=dev --coeff=1.15
  python -m diff_sampler_tpu_torch.cli.sample --dataset_name=lsun_bedroom_ldm \\
      --model_path=random --solver=ipndm --num_steps=6 --seeds=0-63 \\
      --bf16=True --device=cuda --outdir=out/
  # ImageNet-256 ADM under classifier guidance (the classifier file is found
  # beside the model's, or in the offline roots)
  ... --dataset_name=imagenet256 --model_path=256x256_diffusion.pt \
      --guidance_type=cg --guidance_rate=1.0 --bf16=True
  # Stable Diffusion v1.5 from its checkpoint, one prompt under guidance 7.5
  python -m diff_sampler_tpu_torch.cli.sample --dataset_name=ms_coco \\
      --model_path=v1-5-pruned-emaonly.ckpt --prompt="a photograph of an astronaut" \\
      --guidance_rate=7.5 --seeds=0-7 --batch=8 --bf16=True --device=cuda

The pixel tiers default to the poly-7 schedule.  A latent tier samples
latents on the model's ``discrete`` schedule (rho 1) where the schedule is
left at ``polynomial`` and no ``--t_steps`` is given, then decodes them
through its first stage, 16 at a time in f32, to PNGs; it refuses
``--return_inters`` (the trajectory lives in latent space).

Stable Diffusion (``ms_coco``) needs the checkpoint's CLIP text encoder
(random weights have none) and a CLIP BPE vocab file
(``utils.bpe.find_vocab_file``: ``$CLIP_BPE_VOCAB``, ``assets/``,
``~/.cache/clip``).  With ``--prompt`` every seed gets that prompt's
context; without, seed s gets MS-COCO caption ``s % len(captions)`` from
the zoo's captions CSV (``MS-COCO_val2014_30k_captions.csv`` in an offline
root), encoded 64 at a time.  At ``--guidance_rate`` other than 1 each net
call also runs the empty prompt's context (classifier-free guidance).

With ``--dp=True`` the GITS search runs first, on that schedule at
``--num_steps_tea`` points with the ``--solver_tea`` teacher over
``--num_warmup`` seeds (on SD without ``--prompt``, warmup seed i with
caption i), and sampling then takes its ``dp_list`` of the teacher's
schedule.  ``--return_inters=True`` writes ``trajectory.npz`` (key ``xs``,
[num_points, N, H, W, C]), or with ``--grid=True`` renders every point into
``grid.png``.

A class-conditional net samples each seed with its own random class label,
as the JAX CLI does: one-hot for ``imagenet64``, an integer for
``imagenet256``, whose noisy classifier then guides every net call at
``--guidance_rate`` (``--guidance_type=cg`` names that guidance; the JAX CLI
ignores the flag on the pixel tiers).  With ``--predictor``
(an AMED run directory, its ``predictor.npz`` or the experiment number
under ``./exps``) it samples with the trained AMED predictor instead, and
every solver setting comes from the predictor's config sidecar; an EDM net
is bound without labels there, as the JAX CLI binds it for AMED,
``imagenet256`` takes each seed's integer label, and Stable Diffusion
samples on the prompt or caption contexts above.

PNG writes of a pixel tier's batch i run on the host while the device
samples batch i+1 (``sampling.generate``'s batch callback); a latent tier, a
grid and a trajectory are written after sampling.
"""

from __future__ import annotations

import argparse
import ast
import os
import time

import numpy as np
import torch

from ..gits.search import GITSConfig, gits_schedule
from ..models.convert import load_jax_params
from ..models.factory import ADM_TIERS, EDM_ARCHS, LDM_CONFIGS, create_model
from ..models.precond import CFGPrecond, CGPrecond, bind
from ..models.zoo import find_file
from ..ops import get_schedule
from ..sampling import SolverConfig, generate, generate_batches, to_uint8
from ..solvers import SOLVER_REGISTRY
from ..solvers.amed import AMED_SOLVER_REGISTRY, bind_with_bottleneck
from ..training.amed import AMEDConfig, predictor_from_config
from ..training.conditioning import load_captions
from ..utils import checkpoint as ckpt
from ..utils.image import parse_int_list, save_grid, save_images


def _bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected True or False, got {s!r}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.sample",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_name", required=True,
                   choices=sorted(EDM_ARCHS) + sorted(ADM_TIERS) + sorted(LDM_CONFIGS))
    p.add_argument("--model_path", default="random",
                   help="'random' (seeded random weights), a reference checkpoint file "
                        "(.pkl / .pt / .ckpt), or None for the zoo's file in the offline roots")
    p.add_argument("--predictor", default=None,
                   help="AMED predictor: run dir, predictor.npz, or experiment number")
    p.add_argument("--batch", dest="max_batch_size", type=int, default=64)
    p.add_argument("--seeds", default="0-63")
    p.add_argument("--grid", type=_bool, default=False, help="one grid.png of every image")
    p.add_argument("--outdir", default=None)
    p.add_argument("--subdirs", type=_bool, default=True,
                   help="PNGs in a subdirectory per 1000 seeds")
    p.add_argument("--bf16", type=_bool, default=False, help="bfloat16 inner model")
    p.add_argument("--device", default="cuda")
    # SOLVER_FLAGS
    p.add_argument("--solver", choices=sorted(SOLVER_REGISTRY), default="ipndm")
    p.add_argument("--num_steps", type=int, default=6)
    p.add_argument("--afs", type=_bool, default=False, help="analytic first step")
    p.add_argument("--denoise_to_zero", type=_bool, default=False)
    p.add_argument("--return_inters", type=_bool, default=False,
                   help="save the whole trajectory: trajectory.npz, or every point in the grid")
    # SCHEDULE_FLAGS
    p.add_argument("--schedule_type", default="polynomial",
                   choices=["polynomial", "logsnr", "time_uniform", "discrete"])
    p.add_argument("--schedule_rho", type=float, default=7.0)
    p.add_argument("--sigma_min", type=float, default=None,
                   help="lowest noise level [default: the model's]")
    p.add_argument("--sigma_max", type=float, default=None,
                   help="highest noise level [default: the model's]")
    p.add_argument("--t_steps", default=None,
                   help="explicit sigma list, e.g. '[80.0, 10.0, 1.0, 0.002]'")
    # ADDITIONAL_FLAGS
    p.add_argument("--max_order", type=int, default=None)
    p.add_argument("--predict_x0", type=_bool, default=True)
    p.add_argument("--lower_order_final", type=_bool, default=True)
    p.add_argument("--variant", choices=["bh1", "bh2"], default="bh2")
    p.add_argument("--deis_mode", choices=["tab", "rhoab"], default="tab")
    p.add_argument("--r", type=float, default=0.5)
    # GUIDANCE_FLAGS
    p.add_argument("--guidance_type", choices=["cfg", "cg"], default=None,
                   help="ms_coco: cfg (classifier-free); imagenet256: cg (classifier guidance)")
    p.add_argument("--guidance_rate", type=float, default=1.0)
    p.add_argument("--prompt", default=None,
                   help="ms_coco: one prompt for every seed [default: a caption per seed]")
    # GITS_FLAGS
    p.add_argument("--dp", type=_bool, default=False, help="run the GITS schedule search")
    p.add_argument("--metric", choices=["l1", "l2", "dev"], default="dev")
    p.add_argument("--coeff", type=float, default=1.15)
    p.add_argument("--num_warmup", type=int, default=256)
    p.add_argument("--num_steps_tea", type=int, default=61)
    p.add_argument("--solver_tea", choices=sorted(SOLVER_REGISTRY), default="ipndm")
    return p


def main(argv=None) -> dict:
    """Runs the CLI; returns what a caller may check: the GITS ``dp_list``
    and search seconds (None without ``--dp``) and the output directory."""
    args = _parser().parse_args(argv)
    if args.model_path == "None":
        args.model_path = None
    if args.dataset_name != "ms_coco" and (args.guidance_type == "cfg"
                                           or args.prompt is not None):
        raise NotImplementedError("--prompt and --guidance_type=cfg apply to ms_coco only")
    if args.dataset_name != "imagenet256" and args.guidance_type == "cg":
        raise NotImplementedError("--guidance_type=cg applies to imagenet256 only (its noisy "
                                  "classifier)")
    if args.dp and args.dataset_name == "imagenet256":
        raise NotImplementedError("GITS on imagenet256: its warmup trajectories would need "
                                  "class labels, which the JAX CLI does not bind either")
    latent = args.dataset_name in LDM_CONFIGS
    if args.return_inters and latent:
        raise ValueError("--return_inters is not supported for latent models: the trajectory "
                         "lives in latent space (use the library and decode each point)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but CUDA is not available (pass --device=cpu)")
    seeds = parse_int_list(args.seeds)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    module, source = create_model(args.dataset_name, args.model_path,
                                  guidance_rate=args.guidance_rate, dtype=dtype, device=device)
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    summary = dict(dp_list=None, gits_seconds=None, outdir=None)
    cond, per_seed_cond, captions = {}, None, None
    if source == "sd":
        ld = module.latent_diffusion
        if ld.cond_stage_model is None:
            raise ValueError("ms_coco sampling needs the checkpoint's CLIP text encoder: pass "
                             "--model_path (the 'random' weights have none)")
        if args.prompt is None:
            # one MS-COCO caption per seed (sample.py:171-180, 276-291)
            captions = load_captions(find_file("prompts"))
            per_seed_cond = ld.encode_in_chunks([captions[s % len(captions)] for s in seeds])
        else:
            cond["condition"] = ld.get_learned_conditioning([args.prompt])
        if args.guidance_rate != 1.0:
            cond["unconditional_condition"] = ld.get_learned_conditioning([""])
    if args.predictor is not None:
        summary["outdir"] = _amed_sample(module, args.predictor, seeds, shape,
                                         args.max_batch_size, args.outdir, args.grid,
                                         args.subdirs, args.dataset_name, device, cond,
                                         per_seed_cond)
        return summary
    den = bind(module, **cond)
    # a latent tier samples on the model's discrete schedule, unless a
    # schedule or a sigma list was asked for; the GITS teacher runs on it too
    if latent and args.schedule_type == "polynomial" and args.t_steps is None:
        args.schedule_type, args.schedule_rho = "discrete", 1.0
    dp_list = None
    if args.dp:
        gcfg = GITSConfig(num_steps=args.num_steps, num_steps_tea=args.num_steps_tea,
                          num_warmup=args.num_warmup, solver_tea=args.solver_tea,
                          solver=args.solver, metric=args.metric, coeff=args.coeff,
                          schedule_type=args.schedule_type, schedule_rho=args.schedule_rho,
                          afs=args.afs, batch_size=args.max_batch_size)
        gits_kw = {}
        if captions is not None:
            # the warmup trajectories run on captions too (gits_utils.py:63-110):
            # warmup seed i with caption i
            uc = cond.get("unconditional_condition")
            gits_kw = dict(
                per_seed_cond=ld.encode_in_chunks([captions[i % len(captions)]
                                                   for i in range(args.num_warmup)]),
                denoise_with_cond=lambda x, t, c: module(x, t, condition=c,
                                                         unconditional_condition=uc))
        t0 = time.perf_counter()
        dp_list, dp_sigmas = gits_schedule(den, shape, gcfg, device=device, **gits_kw)
        summary.update(dp_list=dp_list, gits_seconds=time.perf_counter() - t0)
        print(f"GITS search: {summary['gits_seconds']:.1f}s ({gcfg.num_warmup} warmup x "
              f"{gcfg.num_steps_tea - 1}-step {gcfg.solver_tea} teacher)")
        print(f"GITS dp_list: {dp_list}")
        print(f"GITS schedule: {np.round(dp_sigmas, 4).tolist()}")
        args.num_steps = args.num_steps_tea
    cfg = SolverConfig(
        solver=args.solver, num_steps=args.num_steps, schedule_type=args.schedule_type,
        schedule_rho=args.schedule_rho, afs=args.afs, denoise_to_zero=args.denoise_to_zero,
        max_order=args.max_order, predict_x0=args.predict_x0,
        lower_order_final=args.lower_order_final, variant=args.variant,
        deis_mode=args.deis_mode, r=args.r,
        t_steps=tuple(ast.literal_eval(args.t_steps)) if args.t_steps else None,
        dp_list=tuple(dp_list) if dp_list else None, sigma_min=args.sigma_min,
        sigma_max=args.sigma_max)
    print(f"Solver: {args.solver} | NFE: {cfg.nfe()} | schedule: "
          f"{cfg.schedule_type}(rho={cfg.schedule_rho}) | source: {source} | "
          f"device: {device}")
    out_base = args.outdir or f"samples/{args.dataset_name}-{args.solver}-{args.num_steps}"
    summary["outdir"] = out_base
    if latent:
        latents = generate(den, seeds, shape, cfg, max_batch_size=args.max_batch_size,
                           device=device, per_seed_cond=per_seed_cond)
        _decode_and_save(module, latents, seeds, out_base, args.grid, args.subdirs)
        return summary

    stream = not args.return_inters and not args.grid

    def save_batch(start, chunk):
        save_images(to_uint8(chunk), seeds[start:start + len(chunk)], out_base,
                    subdirs=args.subdirs)

    images = generate(den, seeds, shape, cfg, max_batch_size=args.max_batch_size,
                      device=device, label_dim=module.label_dim,
                      label_kind="int" if source == "adm" else "onehot",
                      return_inters=args.return_inters,
                      batch_callback=save_batch if stream else None)
    if args.return_inters:
        # [num_points, N, ...]: the grid renders every point, else the raw array
        if args.grid:
            _save(images.reshape((-1,) + images.shape[2:]),
                  range(images.shape[0] * images.shape[1]), out_base, True, False)
        else:
            os.makedirs(out_base, exist_ok=True)
            np.savez(os.path.join(out_base, "trajectory.npz"), xs=images)
            print(f"Saved trajectory {images.shape} to {out_base}/trajectory.npz")
    elif stream:
        print(f"Saved {len(seeds)} images to {out_base} (streamed)")
    else:
        _save(images, seeds, out_base, args.grid, args.subdirs)
    return summary


def _save(images, seeds, out_base, grid, subdirs):
    """[-1, 1] images to ``{out_base}/grid.png`` or to per-seed PNGs."""
    images = to_uint8(images)
    if grid:
        save_grid(images, os.path.join(out_base, "grid.png"))
        print(f"Saved grid to {out_base}/grid.png")
    else:
        save_images(images, seeds, out_base, subdirs=subdirs)
        print(f"Saved {len(images)} images to {out_base}")


def _decode_and_save(module, latents, seeds, out_base, grid=False, subdirs=True):
    """A latent tier's samples through its first stage to PNGs."""
    images = module.latent_diffusion.decode_in_chunks(latents)
    if grid:
        _save(images, seeds, out_base, True, subdirs)
        return
    save_images(to_uint8(images), seeds, out_base, subdirs=subdirs)
    print(f"Saved {len(seeds)} images ({images.shape[1]}x{images.shape[2]}, decoded) to "
          f"{out_base}")


def _resolve_snapshot(path_or_exp, outdir_base="./exps"):
    """AMED run dir / its predictor.npz / experiment number under
    ``outdir_base`` -> (npz path, the run's predictor_config.json)."""
    path = str(path_or_exp)
    if path.isdigit():
        run_dir = ckpt.find_run_dir(outdir_base, int(path))
        if run_dir is None:
            raise FileNotFoundError(f"no experiment #{path} in {outdir_base}")
        path = run_dir
    npz = os.path.join(path, "predictor.npz") if os.path.isdir(path) else path
    cfg_path = os.path.join(os.path.dirname(npz), "predictor_config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"no predictor_config.json beside {npz}: the solver "
                                "settings of the predictor are unknown")
    return npz, ckpt.load_config(cfg_path)


def build_amed_sample_fn(module, predictor, device, cfg_doubled: bool = False, **cond):
    """(``(latents, condition=None) -> samples`` under ``torch.no_grad``,
    its AMEDConfig) for an AMED predictor (run dir, .npz or experiment
    number) over ``module``, bound with ``cond`` as ``bind_with_bottleneck``
    binds it; a ``condition`` passed to the call (a batch's per-seed
    contexts, or a CGPrecond's integer labels) replaces the bound one.
    Every solver setting comes from the predictor's config sidecar."""
    npz, cfg_dict = _resolve_snapshot(predictor)
    cfg = AMEDConfig(**{k: v for k, v in cfg_dict.items()
                        if k in AMEDConfig.__dataclass_fields__})
    pred = load_jax_params(predictor_from_config(cfg, device=device),
                           ckpt.load_params(npz)["params"]).eval()
    den_b = bind_with_bottleneck(module, cfg_doubled=cfg_doubled, **cond)
    t_steps = get_schedule(cfg.num_steps, cfg.sigma_min, cfg.sigma_max, cfg.schedule_type,
                           cfg.schedule_rho, sigma_fn=den_b.sigma_fn,
                           sigma_inv_fn=den_b.sigma_inv_fn)
    sampler = AMED_SOLVER_REGISTRY[cfg.sampler_stu]

    key = "class_labels" if isinstance(module, CGPrecond) else "condition"

    @torch.no_grad()
    def sample_fn(latents, condition=None):
        den = den_b if condition is None else bind_with_bottleneck(
            module, cfg_doubled=cfg_doubled, **{**cond, key: condition})
        return sampler(den, pred, latents, t_steps, afs=cfg.afs, max_order=cfg.max_order,
                       predict_x0=cfg.predict_x0, lower_order_final=cfg.lower_order_final).x

    return sample_fn, cfg


def _amed_sample(module, predictor, seeds, shape, max_batch_size, outdir, grid, subdirs,
                 dataset_name, device, cond, per_seed_cond) -> str:
    """AMED sampling with every setting from the predictor's config;
    returns the output directory.  Stable Diffusion samples on the contexts
    ``main`` built (``cond``: the prompt's and the empty prompt's;
    ``per_seed_cond``: a caption's per seed), the batch doubled under
    guidance as the trainer doubles it."""
    cfg_doubled = (isinstance(module, CFGPrecond) and module.guidance_rate != 1.0
                   and cond.get("unconditional_condition") is not None)
    sample_fn, cfg = build_amed_sample_fn(module, predictor, device, cfg_doubled=cfg_doubled,
                                          **cond)
    nfe = 2 * (cfg.num_steps - 1) - (1 if cfg.afs else 0)
    print(f"AMED: student={cfg.sampler_stu} steps={cfg.num_steps} NFE={nfe} "
          f"(restored from predictor config) | device: {device}")
    out_base = outdir or f"samples/{dataset_name}-amed-{cfg.sampler_stu}"
    if isinstance(module, CFGPrecond):
        latents = generate_batches(sample_fn, seeds, shape, max_batch_size=max_batch_size,
                                   device=device, per_seed_cond=per_seed_cond)
        _decode_and_save(module, latents, seeds, out_base, grid, subdirs)
        return out_base

    def save_batch(start, chunk):
        save_images(to_uint8(chunk), seeds[start:start + len(chunk)], out_base,
                    subdirs=subdirs)

    # an EDM net is bound without labels (see the module docstring), a
    # CGPrecond with each seed's integer label
    images = generate_batches(sample_fn, seeds, shape, max_batch_size=max_batch_size,
                              device=device, label_dim=module.label_dim if isinstance(
                                  module, CGPrecond) else 0, label_kind="int",
                              batch_callback=None if grid else save_batch)
    if grid:
        _save(images, seeds, out_base, True, subdirs)
    else:
        print(f"Saved {len(seeds)} images to {out_base}")
    return out_base


if __name__ == "__main__":
    main()
