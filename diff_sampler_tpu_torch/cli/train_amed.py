"""AMED predictor training CLI of the port.

Counterpart of ``diff_sampler_tpu/cli/train_amed.py`` for the pixel EDM tier
(cifar10, ffhq, afhqv2, and the class-conditional imagenet64, whose net is
bound without labels as in the JAX CLI), the 256 px pixel tiers
(lsun_bedroom and lsun_cat, the consistency-models net, the bottleneck its
middle block; imagenet256 under classifier guidance at ``--guidance_rate``,
with one random class label per trajectory, seeded as the latents are), the
unconditional latent tier
(lsun_bedroom_ldm, ffhq_ldm: trajectories of 64x64x3 latents, the bottleneck
the U-Net's middle block) and Stable Diffusion (ms_coco, with
``--guidance_type=cfg``: each iteration draws one text context per
trajectory, and at ``--guidance_rate`` other than 1 every net call runs the
doubled (unconditional, conditional) batch, the bottleneck pooled from its
conditional half), with the same options and defaults:

  python -m diff_sampler_tpu_torch.cli.train_amed --dataset_name=cifar10 \\
      --model_path=random --batch=512 --total_kimg=10 --device=cuda
  python -m diff_sampler_tpu_torch.cli.train_amed --dataset_name=lsun_bedroom_ldm \\
      --model_path=random --batch=512 --batch_gpu=128 --afs=True --device=cuda
  python -m diff_sampler_tpu_torch.cli.train_amed --dataset_name=ms_coco \\
      --guidance_type=cfg --guidance_rate=7.5 --model_path=random --batch=8 --device=cuda
  python -m diff_sampler_tpu_torch.cli.train_amed --dataset_name=lsun_bedroom \
      --model_path=random --batch=32 --batch_gpu=8 --device=cuda

On an SD checkpoint (``--model_path``) with ``--prompt_path`` naming the
MS-COCO captions CSV, each iteration's contexts encode random captions with
the checkpoint's CLIP text encoder and the unconditional context is the
empty prompt's; without captions or a text encoder (``--model_path=random``)
they are the JAX package's seeded random stand-ins
(``training/conditioning.py``).  ``--model_path`` is ``random``, a
reference checkpoint file, or omitted for the zoo's file in ``./src``,
``./models`` or ``./checkpoints`` (``models.zoo``; nothing is downloaded).

AMED on imagenet256 differentiates the student's loss through the
classifier's gradient, a second-order derivative through its attention: on
the CPU the plain attention gives it, on the card the attention kernels
refuse it (``ops.attention``), as the JAX package's Pallas attention has no
second-order path either.

The run directory ``<outdir>/<id>-<desc>/`` gets ``predictor_config.json``
(written after the model's sigma range is set: sampling restores every
solver setting from it), ``stats.jsonl`` (one line per tick), ``log.txt``
(everything the run prints, appended, as the JAX CLI's) and, at the end,
``predictor.npz`` in the JAX package's params layout.  The U-Net is
frozen: autograd computes gradients through it, into the predictor only.

Several processes (``parallel.mesh``: the ``DST_*`` variables or torchrun's)
train data parallel: every process draws the same batch from the same
seeds, each microbatch (``--batch_gpu``, else the batch) splits
contiguously over the data ranks, and the predictor's gradients are
averaged over them before each Adam step; process 0 writes the run's files.
``--sp=n`` rings each attention over groups of n processes
(``ops/ring_attention.py``), forward and backward.  ``--tp=n`` shards the
frozen net Megatron-style over model groups of n processes
(``parallel/tp.py``; any tier, the ImageNet-256 classifier included): the
predictor's gradient reaches it through the shards' backward.  ``--fsdp``
shards the frozen latent net's weights over the data ranks
(``parallel/fsdp.py``; the latent tiers only, as in the JAX CLI):

  torchrun --nproc_per_node=2 -m diff_sampler_tpu_torch.cli.train_amed \
      --dataset_name=lsun_bedroom_ldm --fsdp ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..models.convert import params_to_jax
from ..models.factory import ADM_TIERS, EDM_ARCHS, LDM_CONFIGS, create_model, init_params
from ..ops import ring_attention
from ..parallel.mesh import (make_layout, maybe_initialize_distributed, print0, process_index,
                             rank_device)
from ..solvers.amed import bind_with_bottleneck
from ..training.amed import AMEDConfig, make_amed_train_step, predictor_from_config
from ..training.conditioning import make_caption_context_fn, make_uncond_context
from ..utils import checkpoint as ckpt
from ..utils import stats as training_stats
from ..utils.logger import Logger
from ..utils.profiling import Timer
from ..utils.rng import stacked_randint, stacked_randn
from ..parallel.fsdp import count_sharded_fsdp, fsdp_bytes_per_device, shard_fsdp
from .sample import _bool, check_parallel_flags, shard_tensor_parallel_model


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.train_amed",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_name", required=True,
                   choices=sorted(EDM_ARCHS) + sorted(ADM_TIERS) + sorted(LDM_CONFIGS))
    p.add_argument("--guidance_type", choices=["cg", "cfg", "uncond"], default=None)
    p.add_argument("--guidance_rate", type=float, default=1.0)
    p.add_argument("--prompt_path", default=None)
    p.add_argument("--outdir", default="./exps")
    p.add_argument("--total_kimg", type=int, default=10)
    p.add_argument("--model_path", default=None,
                   help="'random' (seeded random weights), a reference checkpoint file, or "
                        "omitted for the zoo's file in the offline roots")
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--sampler_stu", choices=["amed", "euler", "ipndm", "dpm", "dpmpp"],
                   default="amed")
    p.add_argument("--sampler_tea", choices=["heun", "dpm", "dpmpp", "euler", "ipndm"],
                   default="heun")
    p.add_argument("--m", "--M", dest="M", type=int, default=1)
    p.add_argument("--schedule_type", default="polynomial")
    p.add_argument("--schedule_rho", type=float, default=7.0)
    p.add_argument("--afs", type=_bool, default=False)
    p.add_argument("--scale_dir", type=float, default=0.01)
    p.add_argument("--scale_time", type=float, default=0.0)
    p.add_argument("--max_order", type=int, default=4)
    p.add_argument("--predict_x0", type=_bool, default=True)
    p.add_argument("--lower_order_final", type=_bool, default=True)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--batch_gpu", type=int, default=None,
                   help="microbatch of gradient accumulation (the reference's --batch-gpu)")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--remat_traj", type=_bool, default=False,
                   help="recompute the frozen net's activations in the student backward")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--desc", default=None)
    p.add_argument("--tick", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-n", "--dry-run", dest="dry_run", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def build_trainer(cfg: AMEDConfig, model_path, device, seed: int = 0, prompt_path=None,
                  layout=None, fsdp: bool = False):
    """(frozen net, ``cfg`` with the net's sigma range, predictor from
    ``seed``, its train step with Adam as ``optax.adam``, and the
    per-iteration conditioning ``it -> [batch, ...]`` that the step takes as
    its second argument: Stable Diffusion's contexts [batch, 77, 768] (numpy),
    imagenet256's integer labels [batch] (one per trajectory, drawn by
    ``stacked_randint`` from the trajectory's seed ``seed + index``), else
    None).  ``layout``: the layout the step trains over (None: one
    process); with model groups (``--tp``) the frozen net is cut to this
    rank's tensor-parallel shard.  ``fsdp``: shard a latent tier's frozen
    U-Net over the data ranks (``--fsdp``)."""
    module, source = create_model(cfg.dataset_name, model_path,
                                  guidance_rate=cfg.guidance_rate, device=device)
    if layout is not None:
        shard_tensor_parallel_model(module, source, layout, "frozen net")
    if fsdp:  # a latent tier's (main refuses the others)
        unet = module.latent_diffusion.unet
        specs = shard_fsdp(unet, layout)
        print0(f"FSDP: frozen net ({count_sharded_fsdp(specs)} weights) sharded "
               f"1/{layout.dp}: {fsdp_bytes_per_device(unet, specs, layout.dp) / 2**30:.3f} "
               f"GiB/device resident")
    cfg = dataclasses.replace(cfg, sigma_min=float(module.sigma_min),
                              sigma_max=float(module.sigma_max))
    pred = init_params(predictor_from_config(cfg, device=device), seed=seed)
    optimizer = torch.optim.Adam(pred.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    if source == "adm":
        def label_fn(it):
            seeds = np.arange(it * cfg.batch, (it + 1) * cfg.batch) + seed
            return stacked_randint(seeds.tolist(), (), 0, module.label_dim, device=device)

        return module, cfg, pred, make_amed_train_step(
            pred, None, cfg, optimizer,
            denoise_factory=lambda labels: bind_with_bottleneck(module, class_labels=labels),
            layout=layout), label_fn
    if source != "sd":
        return module, cfg, pred, make_amed_train_step(pred, bind_with_bottleneck(module), cfg,
                                                       optimizer, layout=layout), None
    context_fn, uncond = _make_text_conditioning(module.latent_diffusion, prompt_path,
                                                 cfg.batch, cfg.batch_gpu or cfg.batch,
                                                 cfg.guidance_rate, seed)
    if uncond is not None:
        uncond = torch.from_numpy(uncond).to(device)

    def denoise_factory(ctx):
        return bind_with_bottleneck(module, cfg_doubled=uncond is not None, condition=ctx,
                                    unconditional_condition=uncond)

    return module, cfg, pred, make_amed_train_step(pred, None, cfg, optimizer,
                                                   denoise_factory=denoise_factory,
                                                   layout=layout), context_fn


def _make_text_conditioning(ld, prompt_path, batch, mb, guidance_rate, seed):
    """(context_fn, uncond) for SD AMED training: per-iteration contexts plus
    the constant unconditional context sized to the microbatch (None
    without guidance), as the JAX CLI's helper of the same name."""
    context_fn = make_caption_context_fn(ld, prompt_path, batch, seed)
    uncond = make_uncond_context(ld, mb, guidance_rate, seed=seed)
    return context_fn, uncond


def main(argv=None) -> str:
    """Runs the training; returns the run directory (None on a dry run)."""
    args = _parser().parse_args(argv)
    check_parallel_flags(args.tp, args.sp, args.fsdp)
    if args.fsdp and args.dataset_name not in LDM_CONFIGS:
        raise ValueError("--fsdp shards the frozen latent net; it applies to ldm/sd tiers only")
    if args.dataset_name == "ms_coco":
        if args.guidance_type != "cfg":
            raise ValueError("ms_coco trains with --guidance_type=cfg")
    elif args.prompt_path is not None or args.guidance_type not in (
            (None, "cg") if args.dataset_name == "imagenet256" else (None,)):
        raise NotImplementedError("--guidance_type and --prompt_path apply to ms_coco (cfg) "
                                  "and imagenet256 (cg, its classifier guidance) only")
    for name in ("total_kimg", "num_steps", "batch", "batch_gpu", "tick"):
        value = getattr(args, name)
        if value is not None and value < (2 if name == "num_steps" else 1):
            raise ValueError(f"--{name}={value} is out of range")
    if args.M < 0:
        raise ValueError(f"--M={args.M} is out of range")

    cfg = AMEDConfig(dataset_name=args.dataset_name, num_steps=args.num_steps,
                     sampler_stu=args.sampler_stu, sampler_tea=args.sampler_tea, M=args.M,
                     schedule_type=args.schedule_type, schedule_rho=args.schedule_rho,
                     afs=args.afs, scale_dir=args.scale_dir, scale_time=args.scale_time,
                     max_order=args.max_order, predict_x0=args.predict_x0,
                     lower_order_final=args.lower_order_final, lr=args.lr,
                     total_kimg=args.total_kimg, batch=args.batch, batch_gpu=args.batch_gpu,
                     guidance_type=args.guidance_type, guidance_rate=args.guidance_rate,
                     remat_traj=args.remat_traj)
    if args.dry_run:
        print0("Training options:")
        print0(json.dumps(dataclasses.asdict(cfg), indent=2))
        print0("Dry run; exiting.")
        return None
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but CUDA is not available (pass --device=cpu)")
    maybe_initialize_distributed(device)
    device = rank_device(device)
    layout = make_layout(args.sp, args.tp)
    mb = cfg.batch_gpu or cfg.batch
    if mb % layout.dp:
        raise ValueError(f"the microbatch of {mb} rows does not split over {layout.dp} data ranks")

    run_desc = (f"{cfg.dataset_name}-{cfg.num_steps}-{cfg.num_steps}-{cfg.sampler_stu}-"
                f"{cfg.sampler_tea}" + (f"-{args.desc}" if args.desc else ""))
    run_dir = ckpt.create_run_dir(args.outdir, run_desc)
    rank0 = process_index() == 0
    with Logger(os.path.join(run_dir, "log.txt") if rank0 else None, "a"):
        print0(f"Run dir: {run_dir}")

        module, cfg, pred, train_step, context_fn = build_trainer(cfg, args.model_path, device,
                                                                  args.seed, args.prompt_path,
                                                                  layout, args.fsdp)
        # The sidecar describes the schedule the predictor trains on: the
        # model's sigma range, set before it is written.
        if rank0:
            ckpt.save_config(os.path.join(run_dir, "predictor_config.json"), cfg)
        if args.sp > 1:
            ring_attention.reset_sp_dispatch()
            ring_attention.set_sp_context(layout)
            print0(f"Sequence parallel: ring attention over (data, seq) = ({layout.dp}, "
                   f"{layout.sp})")

        res, chn = module.img_resolution, module.img_channels
        collector = training_stats.default_collector
        jsonl = training_stats.JsonlWriter(os.path.join(run_dir, "stats.jsonl"))
        timer = Timer()
        cur_nimg, it = 0, 0
        print0(f"Training for {cfg.total_kimg} kimg (batch {cfg.batch}, "
               f"batch_gpu {cfg.batch_gpu or cfg.batch}) on {device}, {layout.world} "
               f"process(es)...")
        try:
            while cur_nimg < cfg.total_kimg * 1000:
                batch_seeds = np.arange(it * cfg.batch, (it + 1) * cfg.batch) + args.seed
                latents = stacked_randn(batch_seeds.tolist(), (res, res, chn), device=device)
                cond = () if context_fn is None else (torch.as_tensor(context_fn(it), device=device),)
                metrics = train_step(latents, *cond)
                training_stats.report("Loss/loss", metrics["loss_per_step"].cpu().numpy())
                cur_nimg += cfg.batch
                it += 1
                if it % args.tick == 0 or cur_nimg >= cfg.total_kimg * 1000:
                    collector.update()
                    t = timer.tick(cur_nimg)
                    print0(f"kimg {cur_nimg / 1e3:<8.2f} loss {collector.mean('Loss/loss'):<12.6f} "
                           f"sec/kimg {t['sec_per_kimg']:<8.1f}")
                    jsonl.write(collector, kimg=cur_nimg / 1e3, **t)
                    collector.reset()
        finally:
            jsonl.close()
            if args.sp > 1:
                ring_attention.log_sp_dispatch(print0)
                ring_attention.set_sp_context(None)
        path = os.path.join(run_dir, "predictor.npz")
        if rank0:
            ckpt.save_params(path, params_to_jax(pred.state_dict()))
        print0(f"Saved {path}")
        print0("Done.")
        return run_dir


if __name__ == "__main__":
    main()
