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

An SFD student samples from ``--model_path`` set to one of its snapshots
(``snapshot-*.npz``), its run directory (the last snapshot) or its
experiment number under ``./exps``: an EDM student is rebuilt with its
step-condition modules where it has them, a latent one from the original
checkpoint that its ``training_options.json`` names, its U-Net then
swapped for the snapshot's; the solver becomes euler, and num_steps
(unless the student is SFD-v's), the schedule and AFS come from
``training_options.json``, as in the JAX CLI.  As there, an SFD-v
student samples without its step condition.  ``--skip_tuning=True``
scales an EDM net's decoder skips (SFD's inference-time tuning):

  python -m diff_sampler_tpu_torch.cli.sample --dataset_name=cifar10 \
      --model_path=exps/00000-cifar10-4step-dpmpp3 --skip_tuning=True --seeds=0-63

PNG writes of a pixel tier's batch i run on the host while the device
samples batch i+1 (``sampling.generate``'s batch callback); a latent tier, a
grid and a trajectory are written after sampling.

Several processes (``parallel.mesh``: ``DST_COORDINATOR``,
``DST_NUM_PROCESSES``, ``DST_PROCESS_ID``, ``DST_LOCAL_DEVICE_IDS``, or
torchrun's variables) split each batch of seeds over their data ranks;
every process gets every image and writes the PNGs of the seeds whose
index is its rank modulo the process count (the grid and the trajectory
on process 0), so each file is written once.  ``--sp=n`` groups n
processes to split each image's attention tokens round a ring
(``ops/ring_attention.py``; the shapes its gates refuse stay local, and the
run ends with the ledger of what rang):

  torchrun --nproc_per_node=2 -m diff_sampler_tpu_torch.cli.sample \
      --dataset_name=cifar10 ... --batch=128
  torchrun --nproc_per_node=4 -m diff_sampler_tpu_torch.cli.sample \
      --dataset_name=ms_coco --sp=2 ...

``--tp=n`` shards the U-Net's weights Megatron-style over model groups of n
processes (``parallel/tp.py``): every pixel and latent tier, the
ImageNet-256 classifier and an SFD student included; the ranks of one model
group sample the same seeds, and the data ranks split them:

  torchrun --nproc_per_node=2 -m diff_sampler_tpu_torch.cli.sample \
      --dataset_name=imagenet256 --guidance_type=cg --tp=2 ...
"""

from __future__ import annotations

import argparse
import ast
import os
import time

import numpy as np
import torch

from ..gits.search import GITSConfig, gits_schedule
from ..models.convert import ldm_params_from_jax, load_jax_params
from ..models.factory import (ADM_TIERS, EDM_ARCHS, LDM_CONFIGS, build_edm_model,
                              build_ldm_model, create_model, init_params)
from ..models.precond import CFGPrecond, CGPrecond, bind
from ..ops import get_schedule, ring_attention
from ..parallel.mesh import (check_degrees, make_layout, maybe_initialize_distributed, print0,
                             process_count, process_index, rank_device)
from ..sampling import SolverConfig, generate, generate_batches, to_uint8
from ..solvers import SOLVER_REGISTRY
from ..solvers.amed import AMED_SOLVER_REGISTRY, bind_with_bottleneck
from ..training.amed import AMEDConfig, predictor_from_config
from ..utils import checkpoint as ckpt
from ..utils.image import parse_int_list, save_grid, save_images
from .clip_score import load_captions


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
                        "(.pkl / .pt / .ckpt), None for the zoo's file in the offline roots, "
                        "or an SFD snapshot .npz, its run dir or experiment number")
    p.add_argument("--predictor", default=None,
                   help="AMED predictor: run dir, predictor.npz, or experiment number")
    p.add_argument("--batch", dest="max_batch_size", type=int, default=64)
    p.add_argument("--seeds", default="0-63")
    p.add_argument("--grid", type=_bool, default=False, help="one grid.png of every image")
    p.add_argument("--outdir", default=None)
    p.add_argument("--subdirs", type=_bool, default=True,
                   help="PNGs in a subdirectory per 1000 seeds")
    p.add_argument("--bf16", type=_bool, default=False, help="bfloat16 inner model")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel degree: shard the U-Net weights (and the imagenet256 "
                        "classifier's) over a (data, model) mesh (parallel/tp.py)")
    p.add_argument("--sp", type=int, default=1,
                   help="Sequence-parallel degree: ring attention over a (data, seq) mesh shards "
                        "each image's attention tokens across devices "
                        "(ops/ring_attention.py); the T=4096 SD latent level is the motivating "
                        "case")
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
    p.add_argument("--skip_tuning", type=_bool, default=False,
                   help="SFD's inference-time skip scaling (an EDM net)")
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
    check_parallel_flags(args.tp, args.sp)
    if args.model_path == "None":
        args.model_path = None
    if args.dataset_name != "ms_coco" and (args.guidance_type == "cfg"
                                           or args.prompt is not None):
        raise NotImplementedError("--prompt and --guidance_type=cfg apply to ms_coco only")
    if args.dataset_name != "imagenet256" and args.guidance_type == "cg":
        raise NotImplementedError("--guidance_type=cg applies to imagenet256 only (its noisy "
                                  "classifier)")
    if args.skip_tuning and (args.dataset_name not in EDM_ARCHS or args.predictor is not None):
        raise NotImplementedError("--skip_tuning applies to plain sampling of an EDM net "
                                  "(SongUNet / DhariwalUNet)")
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
    maybe_initialize_distributed(device)
    device = rank_device(device)
    layout = make_layout(args.sp, args.tp)
    if args.sp > 1:
        ring_attention.reset_sp_dispatch()
        ring_attention.set_sp_context(layout)
        print0(f"Sequence parallel: ring attention over (data, seq) = ({layout.dp}, "
               f"{layout.sp})")
    try:
        return _main(args, device, layout)
    finally:
        if args.sp > 1:
            ring_attention.log_sp_dispatch(print0)  # which attention shapes rang
            ring_attention.set_sp_context(None)


def check_parallel_flags(tp: int, sp: int, fsdp: bool = False) -> None:
    """The CLIs' refusals of the parallel flags, before any process group
    exists: the JAX CLIs' mutual exclusions and the degrees' range."""
    check_degrees(sp, tp)
    if fsdp and tp > 1:
        raise ValueError("--fsdp and --tp are mutually exclusive (one weight sharding at a time)")


def shard_tensor_parallel_model(module, source: str, layout, what: str = "U-Net weights"):
    """Cut ``module`` (create_model's, of ``source``) to this rank's
    tensor-parallel shard over ``layout``'s model groups and print the JAX
    CLIs' line with the port's counts; nothing at tp 1."""
    if layout.tp == 1:
        return
    from ..models.factory import shard_ldm_tensor_parallel, shard_pixel_tensor_parallel
    from ..parallel.tp import count_sharded, tp_bytes_per_rank

    nets = ((module.latent_diffusion.unet,) if source in ("ldm", "sd") else
            (module.net, module.classifier) if source == "adm" else
            (module.net,) if source == "cm" else (module.model,))
    full = sum(tp_bytes_per_rank(n) for n in nets)
    if source in ("ldm", "sd"):
        shard_ldm_tensor_parallel(module, layout)
    else:
        shard_pixel_tensor_parallel(module, layout, source)
    print0(f"Tensor parallel: {what} sharded over mesh {{'data': {layout.dp}, 'model': "
           f"{layout.tp}}}: {sum(count_sharded(n) for n in nets)} weights, "
           f"{sum(tp_bytes_per_rank(n) for n in nets) / 2**30:.3f} GiB per rank of "
           f"{full / 2**30:.3f} GiB")


def _main(args, device, layout) -> dict:
    latent = args.dataset_name in LDM_CONFIGS
    seeds = parse_int_list(args.seeds)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if _is_snapshot(args.model_path):
        module, source = _sfd_student(args, dtype, device)
    else:
        module, source = create_model(args.dataset_name, args.model_path,
                                      guidance_rate=args.guidance_rate, dtype=dtype,
                                      device=device)
    shard_tensor_parallel_model(module, source, layout)
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    summary = dict(dp_list=None, gits_seconds=None, outdir=None)
    cond, per_seed_cond, captions = {}, None, None
    if source == "sd":
        ld = module.latent_diffusion
        if ld.cond_stage_model is None:
            raise ValueError("ms_coco sampling needs the checkpoint's CLIP text encoder: pass "
                             "--model_path (the 'random' weights have none)")
        if args.prompt is None:
            # one MS-COCO caption per seed (sample.py:171-180, 276-291), read
            # as UTF-8 with newline="" as the JAX CLI reads them
            captions = load_captions()
            per_seed_cond = ld.encode_in_chunks([captions[s % len(captions)] for s in seeds])
        else:
            cond["condition"] = ld.get_learned_conditioning([args.prompt])
        if args.guidance_rate != 1.0:
            cond["unconditional_condition"] = ld.get_learned_conditioning([""])
    if args.predictor is not None:
        summary["outdir"] = _amed_sample(module, args.predictor, seeds, shape,
                                         args.max_batch_size, args.outdir, args.grid,
                                         args.subdirs, args.dataset_name, device, cond,
                                         per_seed_cond, layout)
        return summary
    den = bind(module, **cond, **({"skip_tuning": True} if args.skip_tuning else {}))
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
        print0(f"GITS search: {summary['gits_seconds']:.1f}s ({gcfg.num_warmup} warmup x "
               f"{gcfg.num_steps_tea - 1}-step {gcfg.solver_tea} teacher)")
        print0(f"GITS dp_list: {dp_list}")
        print0(f"GITS schedule: {np.round(dp_sigmas, 4).tolist()}")
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
    print0(f"Solver: {args.solver} | NFE: {cfg.nfe()} | schedule: "
           f"{cfg.schedule_type}(rho={cfg.schedule_rho}) | source: {source} | "
           f"device: {device} | processes: {layout.world} ({layout.backend or 'one'})")
    out_base = args.outdir or f"samples/{args.dataset_name}-{args.solver}-{args.num_steps}"
    summary["outdir"] = out_base
    if latent:
        latents = generate(den, seeds, shape, cfg, max_batch_size=args.max_batch_size,
                           device=device, per_seed_cond=per_seed_cond, layout=layout)
        _decode_and_save(module, latents, seeds, out_base, args.grid, args.subdirs)
        return summary

    stream = not args.return_inters and not args.grid

    def save_batch(start, chunk):
        _save_mine(chunk, seeds, start, out_base, args.subdirs)

    images = generate(den, seeds, shape, cfg, max_batch_size=args.max_batch_size,
                      device=device, label_dim=module.label_dim,
                      label_kind="int" if source == "adm" else "onehot",
                      return_inters=args.return_inters,
                      batch_callback=save_batch if stream else None, layout=layout)
    if args.return_inters:
        # [num_points, N, ...]: the grid renders every point, else the raw array
        if args.grid:
            _save(images.reshape((-1,) + images.shape[2:]),
                  range(images.shape[0] * images.shape[1]), out_base, True, False)
        else:
            if process_index() == 0:
                os.makedirs(out_base, exist_ok=True)
                np.savez(os.path.join(out_base, "trajectory.npz"), xs=images)
            print0(f"Saved trajectory {images.shape} to {out_base}/trajectory.npz")
    elif stream:
        print0(f"Saved {len(seeds)} images to {out_base} (streamed)")
    else:
        _save(images, seeds, out_base, args.grid, args.subdirs)
    return summary


def _save_mine(images, seeds, start, out_base, subdirs) -> None:
    """The PNGs of ``images`` (seeds ``seeds[start:]``, [-1, 1]) whose index in
    the seed list is this process's rank modulo the process count: every
    process holds every image, and each file is written once."""
    pi, pc = process_index(), process_count()
    mine = [i for i in range(len(images)) if (start + i) % pc == pi]
    if mine:
        save_images(to_uint8(images[mine]), [seeds[start + i] for i in mine], out_base,
                    subdirs=subdirs)


def _save(images, seeds, out_base, grid, subdirs):
    """[-1, 1] images to ``{out_base}/grid.png`` (process 0) or to per-seed
    PNGs (``_save_mine``)."""
    if grid:
        if process_index() == 0:
            save_grid(to_uint8(images), os.path.join(out_base, "grid.png"))
        print0(f"Saved grid to {out_base}/grid.png")
    else:
        _save_mine(images, list(seeds), 0, out_base, subdirs)
        print0(f"Saved {len(images)} images to {out_base}")


def _decode_and_save(module, latents, seeds, out_base, grid=False, subdirs=True):
    """A latent tier's samples through its first stage to PNGs."""
    images = module.latent_diffusion.decode_in_chunks(latents)
    if grid:
        _save(images, seeds, out_base, True, subdirs)
        return
    _save_mine(images, list(seeds), 0, out_base, subdirs)
    print0(f"Saved {len(seeds)} images ({images.shape[1]}x{images.shape[2]}, decoded) to "
           f"{out_base}")


def _run_path(path_or_exp, outdir_base: str) -> str:
    """A path as it is, or experiment number n -> its run dir in
    ``outdir_base``."""
    path = str(path_or_exp)
    if path.isdigit():
        run_dir = ckpt.find_run_dir(outdir_base, int(path))
        if run_dir is None:
            raise FileNotFoundError(f"no experiment #{path} in {outdir_base}")
        path = run_dir
    return path


def _is_snapshot(model_path) -> bool:
    """Whether ``--model_path`` names an SFD snapshot, run dir or experiment
    number."""
    return model_path is not None and (model_path.endswith(".npz") or model_path.isdigit()
                                       or os.path.isdir(model_path))


def _resolve_sfd_snapshot(path_or_exp, outdir_base="./exps"):
    """SFD run dir (its last snapshot) / snapshot .npz / experiment number
    under ``outdir_base`` -> (npz path, the run's training_options.json, or
    {} where there is none beside the snapshot)."""
    path = _run_path(path_or_exp, outdir_base)
    if os.path.isdir(path):
        snaps = sorted(f for f in os.listdir(path)
                       if f.startswith("snapshot-") and f.endswith(".npz"))
        if not snaps:
            raise FileNotFoundError(f"no snapshot-*.npz in {path}")
        path = os.path.join(path, snaps[-1])
    cfg_path = os.path.join(os.path.dirname(path), "training_options.json")
    return path, ckpt.load_config(cfg_path) if os.path.isfile(cfg_path) else {}


def _sfd_student(args, dtype, device):
    """(module, source) of an SFD snapshot, ``args``' solver settings
    restored from its training options (sfd sample.py:110-135): a latent
    student is the LDM / SD stack of the original checkpoint with the
    snapshot's U-Net; an EDM one is built with its step-condition modules
    (at the sampling sigma_min, 0.002)."""
    npz, restored = _resolve_sfd_snapshot(args.model_path)
    params = ckpt.load_params(npz)["params"]
    if args.dataset_name in LDM_CONFIGS:
        rate = restored.get("guidance_rate", args.guidance_rate)
        module = build_ldm_model(args.dataset_name, restored.get("model_path"),
                                 guidance_rate=rate or 1.0, dtype=dtype, device=device)
        unet = module.latent_diffusion.unet
        unet.load_state_dict(ldm_params_from_jax(params, unet.state_dict()))
        args.guidance_rate = rate
        source = "sd" if args.dataset_name == "ms_coco" else "ldm"
    elif args.dataset_name in EDM_ARCHS:
        module = init_params(build_edm_model(
            args.dataset_name, use_step_condition=restored.get("use_step_condition", False),
            dtype=dtype, device=device))
        load_jax_params(module, params)
        source = "edm"
    else:
        raise NotImplementedError(f"{args.dataset_name} has no SFD student")
    if restored:
        # --num_steps is honoured only for SFD-v
        if not restored.get("use_step_condition", False):
            args.num_steps = restored.get("num_steps", args.num_steps)
        args.solver = "euler"
        args.schedule_type = restored.get("schedule_type", args.schedule_type)
        args.schedule_rho = restored.get("schedule_rho", args.schedule_rho)
        args.afs = restored.get("afs", args.afs)
        print0(f"Restored SFD sampling settings: num_steps={args.num_steps} "
               f"schedule={args.schedule_type}({args.schedule_rho}) afs={args.afs}")
    return module, source


def _resolve_snapshot(path_or_exp, outdir_base="./exps"):
    """AMED run dir / its predictor.npz / experiment number under
    ``outdir_base`` -> (npz path, the run's predictor_config.json)."""
    path = _run_path(path_or_exp, outdir_base)
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
                 dataset_name, device, cond, per_seed_cond, layout=None) -> str:
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
    print0(f"AMED: student={cfg.sampler_stu} steps={cfg.num_steps} NFE={nfe} "
           f"(restored from predictor config) | device: {device}")
    out_base = outdir or f"samples/{dataset_name}-amed-{cfg.sampler_stu}"
    if isinstance(module, CFGPrecond):
        latents = generate_batches(sample_fn, seeds, shape, max_batch_size=max_batch_size,
                                   device=device, per_seed_cond=per_seed_cond, layout=layout)
        _decode_and_save(module, latents, seeds, out_base, grid, subdirs)
        return out_base

    def save_batch(start, chunk):
        _save_mine(chunk, seeds, start, out_base, subdirs)

    # an EDM net is bound without labels (see the module docstring), a
    # CGPrecond with each seed's integer label
    images = generate_batches(sample_fn, seeds, shape, max_batch_size=max_batch_size,
                              device=device, label_dim=module.label_dim if isinstance(
                                  module, CGPrecond) else 0, label_kind="int",
                              batch_callback=None if grid else save_batch, layout=layout)
    if grid:
        _save(images, seeds, out_base, True, subdirs)
    else:
        print0(f"Saved {len(seeds)} images to {out_base}")
    return out_base


if __name__ == "__main__":
    main()
