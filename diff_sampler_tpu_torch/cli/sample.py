"""Sampling CLI of the port: seeds -> per-seed PNGs.

Counterpart of ``diff_sampler_tpu/cli/sample.py`` for the pixel EDM tier
and the unconditional latent tier, with random weights:

  python -m diff_sampler_tpu_torch.cli.sample --dataset_name=cifar10 \\
      --model_path=random --solver=ipndm --num_steps=6 --seeds=0-255 \\
      --batch=256 --bf16=True --device=cuda --outdir=out/
  python -m diff_sampler_tpu_torch.cli.sample --dataset_name=lsun_bedroom_ldm \\
      --model_path=random --solver=ipndm --num_steps=6 --seeds=0-63 \\
      --bf16=True --device=cuda --outdir=out/

The pixel tiers default to the poly-7 schedule.  A latent tier samples 64x64
latents on the model's ``discrete`` schedule (rho 1) in place of that
default, then decodes them through its VQ first stage, 16 at a time in f32,
to 256x256 PNGs.

Stable Diffusion (``ms_coco``) needs prompts and the CLIP text encoder,
which come with a later slice: until then it samples through the library,
``bind(precond, condition=ctx, unconditional_condition=uc)`` -> ``generate``
-> ``latent_diffusion.decode_in_chunks``, and this CLI refuses it.

A class-conditional net (``--dataset_name=imagenet64``) samples each seed
with its own random class label, as the JAX CLI does.  With ``--predictor``
(an AMED run directory, its ``predictor.npz`` or the experiment number
under ``./exps``) it samples with the trained AMED predictor instead, and
every solver setting comes from the predictor's config sidecar; the net is
bound without labels there, as the JAX CLI binds an EDM net for AMED.

PNG writes of a pixel tier's batch i run on the host while the device
samples batch i+1 (``sampling.generate``'s batch callback); a latent tier
writes after the decode.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..models.convert import load_jax_params
from ..models.factory import EDM_ARCHS, LDM_CONFIGS, create_model
from ..models.precond import CFGPrecond, bind
from ..ops import get_schedule
from ..sampling import SolverConfig, generate, generate_batches, to_uint8
from ..solvers import SOLVER_REGISTRY
from ..solvers.amed import AMED_SOLVER_REGISTRY, bind_with_bottleneck
from ..training.amed import AMEDConfig, predictor_from_config
from ..utils import checkpoint as ckpt
from ..utils.image import parse_int_list, save_images


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
                   choices=sorted(EDM_ARCHS) + sorted(LDM_CONFIGS))
    p.add_argument("--model_path", default="random",
                   help="'random' (seeded random weights); checkpoints are not ported yet")
    p.add_argument("--predictor", default=None,
                   help="AMED predictor: run dir, predictor.npz, or experiment number")
    p.add_argument("--batch", dest="max_batch_size", type=int, default=64)
    p.add_argument("--seeds", default="0-63")
    p.add_argument("--outdir", default=None)
    p.add_argument("--bf16", type=_bool, default=False, help="bfloat16 inner model")
    p.add_argument("--device", default="cuda")
    p.add_argument("--solver", choices=sorted(SOLVER_REGISTRY), default="ipndm")
    p.add_argument("--num_steps", type=int, default=6)
    return p


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.dataset_name == "ms_coco":
        raise NotImplementedError("ms_coco sampling needs --prompt and the CLIP text encoder "
                                  "(ROADMAP slice 4); sample it through the library: bind(pre, "
                                  "condition=ctx, unconditional_condition=uc) -> generate")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but CUDA is not available (pass --device=cpu)")
    seeds = parse_int_list(args.seeds)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    module, source = create_model(args.dataset_name, args.model_path, dtype=dtype,
                                  device=device)
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    if args.predictor is not None:
        _amed_sample(module, args.predictor, seeds, shape, args.max_batch_size, args.outdir,
                     args.dataset_name, device)
        return
    den = bind(module)
    # a latent tier samples on the model's discrete schedule
    sched = dict(schedule_type="discrete", schedule_rho=1.0) if source == "ldm" else {}
    cfg = SolverConfig(solver=args.solver, num_steps=args.num_steps, **sched)
    print(f"Solver: {args.solver} | NFE: {cfg.nfe()} | schedule: "
          f"{cfg.schedule_type}(rho={cfg.schedule_rho}) | source: {source} | "
          f"device: {device}")
    out_base = args.outdir or f"samples/{args.dataset_name}-{args.solver}-{args.num_steps}"
    if source == "ldm":
        latents = generate(den, seeds, shape, cfg, max_batch_size=args.max_batch_size,
                           device=device)
        _decode_and_save(module, latents, seeds, out_base)
        return

    def save_batch(start, chunk):
        save_images(to_uint8(chunk), seeds[start:start + len(chunk)], out_base)

    generate(den, seeds, shape, cfg, max_batch_size=args.max_batch_size, device=device,
             label_dim=module.label_dim, batch_callback=save_batch)
    print(f"Saved {len(seeds)} images to {out_base}")


def _decode_and_save(module, latents, seeds, out_base):
    """A latent tier's samples through its first stage to PNGs."""
    images = module.latent_diffusion.decode_in_chunks(latents)
    save_images(to_uint8(images), seeds, out_base)
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
    """(``latents -> samples`` under ``torch.no_grad``, its AMEDConfig) for
    an AMED predictor (run dir, .npz or experiment number) over ``module``,
    bound with ``cond`` as ``bind_with_bottleneck`` binds it: every solver
    setting comes from the predictor's config sidecar."""
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

    @torch.no_grad()
    def sample_fn(latents):
        return sampler(den_b, pred, latents, t_steps, afs=cfg.afs, max_order=cfg.max_order,
                       predict_x0=cfg.predict_x0, lower_order_final=cfg.lower_order_final).x

    return sample_fn, cfg


def _amed_sample(module, predictor, seeds, shape, max_batch_size, outdir, dataset_name,
                 device):
    sample_fn, cfg = build_amed_sample_fn(module, predictor, device)
    nfe = 2 * (cfg.num_steps - 1) - (1 if cfg.afs else 0)
    print(f"AMED: student={cfg.sampler_stu} steps={cfg.num_steps} NFE={nfe} "
          f"(restored from predictor config) | device: {device}")
    out_base = outdir or f"samples/{dataset_name}-amed-{cfg.sampler_stu}"
    if isinstance(module, CFGPrecond):
        latents = generate_batches(lambda latents, _: sample_fn(latents), seeds, shape,
                                   max_batch_size=max_batch_size, device=device)
        _decode_and_save(module, latents, seeds, out_base)
        return

    def save_batch(start, chunk):
        save_images(to_uint8(chunk), seeds[start:start + len(chunk)], out_base)

    # the net is bound without labels (see the module docstring)
    generate_batches(lambda latents, _: sample_fn(latents), seeds, shape,
                     max_batch_size=max_batch_size, device=device, batch_callback=save_batch)
    print(f"Saved {len(seeds)} images to {out_base}")


if __name__ == "__main__":
    main()
