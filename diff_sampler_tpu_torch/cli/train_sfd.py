"""SFD distillation training CLI of the port.

Counterpart of ``diff_sampler_tpu/cli/train_sfd.py`` (itself
``sfd-main/train.py:15-156``), with its options and defaults:

  # the pixel EDM tiers (cifar10, ffhq, afhqv2, imagenet64)
  python -m diff_sampler_tpu_torch.cli.train_sfd --dataset_name=cifar10 \\
      --model_path=random --total_kimg=1 --batch=128 --device=cuda
  # SFD-v: the step condition, num_steps drawn in [4, 7] per iteration
  ... --dataset_name=cifar10 --use_step_condition=True
  # the second stage, from a first stage's snapshot (euler teacher)
  ... --is_second_stage=True --model_path=exps/00000-.../snapshot-000200.npz
  # the latent tiers: the student is the latent U-Net, distilled in latent
  # space (sfd training_loop.py:85-110,168-186,227-260)
  python -m diff_sampler_tpu_torch.cli.train_sfd --dataset_name=lsun_bedroom_ldm \\
      --model_path=random --guidance_type=uncond --batch=128 --batch_gpu=32
  python -m diff_sampler_tpu_torch.cli.train_sfd --dataset_name=ms_coco \\
      --guidance_type=cfg --guidance_rate=7.5 --model_path=v1-5-pruned-emaonly.ckpt \\
      --prompts_path=MS-COCO_val2014_30k_captions.csv --batch=32

The student is built with ``sigma_min=0.006`` (sampling uses 0.002) and
starts from ``--model_path``: ``random`` (seed 0), a reference checkpoint
file, a first stage's ``.npz`` snapshot for ``--is_second_stage``, or
omitted for the zoo's file in ``./src``, ``./models`` or ``./checkpoints``
(nothing is downloaded).  Loaded weights are merged into the fresh init:
modules the file lacks (SFD-v's ``affine_step`` and ``map_step*``) keep
their init.  The teacher is a frozen copy of that starting student.
``--remat`` (default: on for the pixel tiers, off for the latent ones)
recomputes each block's activations in the backward.  ``ms_coco`` forces
an effective batch of 128 through accumulation rounds of ``--batch_gpu``
(or ``--batch``) fresh trajectories each, on one caption context per
trajectory (``training/conditioning.py``: the checkpoint's CLIP tower on
``--prompts_path``'s captions, else seeded random contexts); imagenet64
draws one class label per trajectory (``utils/rng.py::stacked_randint``).
The learning rate drops tenfold after ``_lr_drop_updates`` updates (half
the iterations, counted as optax counts its updates).

The run directory ``<outdir>/<id>-<dataset>-<n>step-<teacher><M>/`` gets
``training_options.json`` (the JAX CLI's keys: sampling restores the
solver settings from it), ``stats.jsonl`` (one line per tick), ``log.txt``
(everything the run prints, appended, as the JAX CLI's) and every
``--tick`` x ``--snap`` iterations and at the end ``snapshot-<kimg>.npz``
in the JAX package's layout (``utils/checkpoint.py``): params, Adam's
moments and count, ``meta/cur_nimg``.  ``--resume=<snapshot>`` restores
params, optimizer state and the image count and continues as an unbroken
run would, at any number of processes.

Several processes (``parallel.mesh``: the ``DST_*`` variables or torchrun's)
train data parallel: every process draws the same batch from the same
seeds, each microbatch splits contiguously over the data ranks, and the
student's gradients are averaged over them before each Adam update;
process 0 writes the run's files.  ``--sp=n`` rings each attention over
groups of n processes (``ops/ring_attention.py``), forward and backward.
``--tp=n`` shards the student, the teacher and Adam's moments Megatron-style
over model groups of n processes (``parallel/tp.py``); ``--fsdp`` shards
them over the data ranks (``parallel/fsdp.py``), on any tier and with
``--sp``.  A snapshot holds the whole weights and moments either way
(gathered, written by process 0), so it loads in one process, and
``--resume`` cuts them again:

  torchrun --nproc_per_node=2 -m diff_sampler_tpu_torch.cli.train_sfd \
      --dataset_name=ms_coco --fsdp ...
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import (absent_from_jax, ldm_params_from_jax, ldm_params_to_jax,
                              params_from_jax, params_to_jax)
from ..models.factory import build_edm_model, build_ldm_model, init_params
from ..models.zoo import find_file, load_checkpoint_params
from ..ops import ring_attention
from ..parallel.fsdp import count_sharded_fsdp, fsdp_bytes_per_device, shard_fsdp
from ..parallel.mesh import (cut, make_layout, maybe_initialize_distributed, print0,
                             process_index, rank_device, shard_spec, whole)
from ..parallel.tp import count_sharded, shard_tensor_parallel, tp_bytes_per_rank
from ..training.conditioning import make_caption_context_fn
from ..training.sfd import SFDConfig, adam_count, make_ldm_train_step, make_train_step
from ..utils import checkpoint as ckpt
from ..utils import stats as training_stats
from ..utils.logger import Logger
from ..utils.profiling import Timer
from ..utils.rng import stacked_randint, stacked_randn
from .sample import _bool, check_parallel_flags

PIXEL_DATASETS = ("cifar10", "ffhq", "afhqv2", "imagenet64")
LATENT_DATASETS = ("ms_coco", "lsun_bedroom_ldm", "ffhq_ldm")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.train_sfd",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_name", required=True, choices=PIXEL_DATASETS + LATENT_DATASETS)
    p.add_argument("--outdir", default="./exps")
    p.add_argument("--total_kimg", type=int, default=200)
    p.add_argument("--use_step_condition", type=_bool, default=False, help="SFD-v")
    p.add_argument("--is_second_stage", type=_bool, default=False)
    p.add_argument("--model_path", default=None,
                   help="'random', a reference checkpoint file, a stage-1 snapshot .npz, or "
                        "omitted for the zoo's file in the offline roots")
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--sampler_tea", choices=["dpm", "dpmpp", "euler", "ipndm", "heun"],
                   default="dpmpp")
    p.add_argument("--m", "--M", dest="M", type=int, default=3)
    p.add_argument("--guidance_type", choices=["cg", "cfg", "uncond"], default=None)
    p.add_argument("--guidance_rate", type=float, default=0.0)
    p.add_argument("--schedule_type", default="polynomial")
    p.add_argument("--schedule_rho", type=float, default=7.0)
    p.add_argument("--afs", type=_bool, default=True)
    p.add_argument("--max_order", type=int, default=3)
    p.add_argument("--predict_x0", type=_bool, default=True)
    p.add_argument("--lower_order_final", type=_bool, default=True)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--batch_gpu", type=int, default=None,
                   help="microbatch of gradient accumulation (the reference's --batch-gpu; "
                        "ms_coco forces an effective 128)")
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--prompts_path", default=None,
                   help="MS-COCO captions CSV with a 'text' column")
    p.add_argument("--remat", type=_bool, default=None,
                   help="recompute each block in the backward [default: on for the pixel "
                        "tiers, off for the latent ones]")
    p.add_argument("--resume", default=None,
                   help="snapshot .npz to resume params, optimizer state and image count from")
    p.add_argument("--desc", default=None)
    p.add_argument("--tick", type=int, default=10)
    p.add_argument("--snap", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-n", "--dry-run", dest="dry_run", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def _accumulation(dataset_name, batch, batch_gpu):
    """(accumulation rounds, microbatch), the JAX CLI's.  ms_coco forces an
    effective batch of 128 (training_loop.py:227: rounds = 128 // batch),
    the microbatch ``batch_gpu`` where given (the JAX CLI's deliberate
    divergence from the reference, which recomputes the rounds from the
    batch alone); the other tiers split ``batch`` into ``batch_gpu``
    microbatches."""
    if dataset_name == "ms_coco":
        mb = batch_gpu if (batch_gpu is not None and batch_gpu < batch) else batch
        return max(1, 128 // mb), mb
    if batch_gpu is not None and batch_gpu < batch:
        if batch % batch_gpu:
            raise ValueError(f"batch {batch} not divisible by batch_gpu {batch_gpu}")
        return batch // batch_gpu, batch_gpu
    return 1, batch


def _lr_drop_updates(total_kimg, eff_batch, num_steps, sfdv, seed):
    """The update index of the half-training tenfold lr drop, counted as
    the JAX CLI counts it: num_steps - 1 updates per iteration (the AFS
    segment's skipped update included, so with AFS the drop comes later
    than half of training); under SFD-v each iteration's num_steps replayed
    from the seeded RandomState that the training loop draws from."""
    half_iters = (total_kimg * 1000) // (2 * eff_batch)
    if not sfdv:
        return half_iters * (num_steps - 1)
    sim = np.random.RandomState(seed)
    return int(sum(int(sim.randint(4, 8)) - 1 for _ in range(half_iters)))


class Student(NamedTuple):
    """The trained module, its frozen teacher, its trainable tensors by
    state_dict name, and its params' JAX layout both ways ({name: tensor}
    -> tree, tree -> {name: tensor})."""

    module: torch.nn.Module
    teacher: torch.nn.Module
    named: list
    to_jax: Callable
    from_jax: Callable


def _merge(module: torch.nn.Module, state_dict) -> int:
    """Load the tensors of ``state_dict`` that ``module`` has (its own
    resample filters excepted) in place; modules the file lacks keep their
    init, keys the module lacks are dropped, as the JAX CLI's merge does.
    Returns the dropped keys' count."""
    own = module.state_dict()
    keep = {k: v for k, v in state_dict.items()
            if k in own and k.split(".")[-1] != "resample_filter"}
    module.load_state_dict(keep, strict=False)
    return sum(k not in own for k in state_dict)


def _create_student(dataset_name, model_path, use_step_condition, remat, device) -> Student:
    """The EDM student (sfd training_loop.py:46-110): the architecture, with
    SFD-v's modules where asked, from seed 0, the loaded weights merged in."""
    module = init_params(build_edm_model(dataset_name, use_step_condition=use_step_condition,
                                         sigma_min=0.006, remat=remat, device=device))
    if model_path is not None and model_path.endswith(".npz"):
        # the second stage starts from a first stage's snapshot
        loaded = params_from_jax(ckpt.load_params(model_path)["params"])
    elif model_path != "random":
        loaded = load_checkpoint_params(model_path or find_file(dataset_name))
    else:
        loaded = None
    if loaded is not None:
        dropped = _merge(module, loaded)
        if dropped:
            print0(f"Merged {model_path}: {dropped} of its tensors have no place in the student")
    for name, p in module.named_parameters():
        # map_augment: never applied, absent from the JAX param tree
        p.requires_grad_(not absent_from_jax(name))
    return Student(module, copy.deepcopy(module).requires_grad_(False),
                   [(n, p) for n, p in module.named_parameters() if p.requires_grad],
                   params_to_jax, params_from_jax)


def _create_latent_student(dataset_name, model_path, guidance_type, guidance_rate, remat,
                           device):
    """(CFGPrecond, Student): the latent U-Net of the LDM / SD stack
    (sfd training_loop.py:85-110; its guidance checks :92,97,103)."""
    if dataset_name == "ms_coco":
        if guidance_type != "cfg":
            raise ValueError("ms_coco trains with --guidance_type=cfg")
    elif guidance_type not in (None, "uncond"):
        raise ValueError(f"{dataset_name} trains with --guidance_type=uncond")
    precond = build_ldm_model(dataset_name, model_path, guidance_rate=guidance_rate or 1.0,
                              remat=remat, device=device)
    ld = precond.latent_diffusion
    ld.requires_grad_(False)
    unet = ld.unet.requires_grad_(True)
    like = unet.state_dict()
    return precond, Student(unet, copy.deepcopy(unet).requires_grad_(False),
                            list(unet.named_parameters()), ldm_params_to_jax,
                            lambda tree: ldm_params_from_jax(tree, like))


def shard_student(student: Student, layout, fsdp: bool) -> None:
    """Cut the student and the teacher in place: to this rank's
    tensor-parallel shard over ``layout``'s model groups (``--tp``), or over
    its data ranks (``--fsdp``); print the JAX CLI's line.  The optimizer
    made afterwards keeps its moments on the shards."""
    if layout.tp > 1:
        full = tp_bytes_per_rank(student.module)
        for m in (student.module, student.teacher):
            shard_tensor_parallel(m, layout)
        print0(f"Tensor parallel: {count_sharded(student.module)} weights sharded over mesh "
               f"{{'data': {layout.dp}, 'model': {layout.tp}}} "
               f"({tp_bytes_per_rank(student.module) / 2**30:.3f} GiB per rank of "
               f"{full / 2**30:.3f} GiB)")
    elif fsdp:
        specs = shard_fsdp(student.module, layout)
        shard_fsdp(student.teacher, layout)
        gib = fsdp_bytes_per_device(student.module, specs, layout.dp) / 2**30
        print0(f"FSDP: {count_sharded_fsdp(specs)} weights sharded 1/{layout.dp} per device "
               f"({gib:.3f} GiB/device resident vs replicated)")


def save_snapshot(path: str, student: Student, optimizer: torch.optim.Optimizer,
                  cur_nimg: int, write: bool = True) -> None:
    """The JAX CLI's snapshot: params, optax.adam's state leaves, cur_nimg.
    Sharded weights and moments are gathered whole first (a collective:
    every process calls it); the file is written where ``write``."""
    named = dict(student.named)

    def moment(key):
        return {n: whole(optimizer.state[p][key], p) if p in optimizer.state
                else torch.zeros_like(whole(p, p)) for n, p in named.items()}

    params = {n: whole(p, p) for n, p in named.items()}
    mu, nu = moment("exp_avg"), moment("exp_avg_sq")
    if write:
        ckpt.save_params(path, student.to_jax(params),
                         opt_state=ckpt.adam_state_leaves(adam_count(optimizer),
                                                          student.to_jax(mu),
                                                          student.to_jax(nu)),
                         meta={"cur_nimg": np.asarray([cur_nimg])})


def _mine(full: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole tensor ``full`` shaped as ``p``."""
    spec = shard_spec(p)
    full = full.to(p.device)
    return full if spec is None else cut(full, spec)


def restore_snapshot(path: str, student: Student, optimizer: torch.optim.Optimizer) -> int:
    """Params, Adam's moments and count from a snapshot into the student and
    ``optimizer`` in place (each cut to this rank's shard where the student
    is sharded); returns its cur_nimg (0 without one)."""
    loaded = ckpt.load_params(path)
    named = dict(student.named)
    weights = student.from_jax(loaded["params"])
    missing = sorted(set(named) - set(weights))
    if missing:
        raise KeyError(f"{path} lacks the student's {missing}")
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(_mine(weights[n], p))
    if "opt_state" in loaded:
        count, mu, nu = ckpt.adam_state_from_leaves(
            loaded["opt_state"], student.to_jax({n: weights[n] for n in named}))
        mu, nu = student.from_jax(mu), student.from_jax(nu)
        for n, p in named.items():
            optimizer.state[p] = {"step": torch.tensor(float(count)),
                                  "exp_avg": _mine(mu[n], p),
                                  "exp_avg_sq": _mine(nu[n], p)}
    meta = loaded.get("meta", {})
    return int(meta["cur_nimg"][0]) if "cur_nimg" in meta else 0


def main(argv=None) -> Optional[str]:
    """Runs the distillation; returns the run directory (None on a dry run)."""
    args = _parser().parse_args(argv)
    check_parallel_flags(args.tp, args.sp, args.fsdp)
    for name, low in (("total_kimg", 1), ("num_steps", 2), ("M", 0), ("batch", 1),
                      ("batch_gpu", 1), ("tick", 1), ("snap", 1)):
        value = getattr(args, name)
        if value is not None and value < low:
            raise ValueError(f"--{name}={value} is out of range")
    latent = args.dataset_name in LATENT_DATASETS
    remat = not latent if args.remat is None else args.remat
    cfg = SFDConfig(num_steps=args.num_steps, M=args.M, sampler_tea=args.sampler_tea,
                    schedule_type=args.schedule_type, schedule_rho=args.schedule_rho,
                    afs=args.afs, max_order=args.max_order, predict_x0=args.predict_x0,
                    lower_order_final=args.lower_order_final,
                    use_step_condition=args.use_step_condition,
                    is_second_stage=args.is_second_stage, sigma_min=0.006, sigma_max=80.0)
    run_desc = f"{args.dataset_name}-{args.num_steps}step-{args.sampler_tea}{args.M}" + (
        f"-{args.desc}" if args.desc else "")
    options = dict(dataset_name=args.dataset_name, batch=args.batch, lr=args.lr,
                   total_kimg=args.total_kimg, seed=args.seed, model_path=args.model_path,
                   guidance_type=args.guidance_type, guidance_rate=args.guidance_rate,
                   **dataclasses.asdict(cfg))
    if args.dry_run:
        print0("Training options:")
        print0(json.dumps(options, indent=2))
        print0("Dry run; exiting.")
        return None
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but CUDA is not available (pass --device=cpu)")
    n_acc, mb = _accumulation(args.dataset_name, args.batch, args.batch_gpu)
    maybe_initialize_distributed(device)
    device = rank_device(device)
    layout = make_layout(args.sp, args.tp)
    if mb % layout.dp:
        raise ValueError(f"the microbatch of {mb} rows does not split over {layout.dp} data ranks")

    run_dir = ckpt.create_run_dir(args.outdir, run_desc)
    rank0 = process_index() == 0
    with Logger(os.path.join(run_dir, "log.txt") if rank0 else None, "a"):
        if rank0:
            ckpt.save_config(os.path.join(run_dir, "training_options.json"), options)
        print0(f"Run dir: {run_dir}")
        eff_batch = n_acc * mb
        if n_acc > 1:
            print0(f"Gradient accumulation: {n_acc} rounds of {mb}")
        sfdv = args.use_step_condition and not args.is_second_stage and not latent
        half = _lr_drop_updates(args.total_kimg, eff_batch, args.num_steps, sfdv, args.seed)

        def lr_schedule(count):
            return args.lr if count < half else args.lr / 10.0

        label_dim, context_fn = 0, None
        if latent:
            precond, student = _create_latent_student(args.dataset_name, args.model_path,
                                                      args.guidance_type, args.guidance_rate,
                                                      remat, device)
            res, chn = precond.img_resolution, precond.img_channels
            if args.dataset_name == "ms_coco":
                context_fn = make_caption_context_fn(precond.latent_diffusion, args.prompts_path,
                                                     eff_batch, args.seed)
        else:
            student = _create_student(args.dataset_name, args.model_path,
                                      args.use_step_condition, remat, device)
            res, chn = student.module.img_resolution, student.module.img_channels
            label_dim = student.module.label_dim
        shard_student(student, layout, args.fsdp)
        optimizer = torch.optim.Adam([p for _, p in student.named], lr=args.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        start_nimg = 0
        if args.resume:
            start_nimg = restore_snapshot(args.resume, student, optimizer)
            print0(f"Resumed from {args.resume} at {start_nimg / 1e3:.1f} kimg "
                   f"({adam_count(optimizer)} updates)")

        def build(c):
            if latent:
                return make_ldm_train_step(student.module, student.teacher, precond, c, optimizer,
                                           n_acc=n_acc, lr_schedule=lr_schedule, layout=layout)
            return make_train_step(student.module, student.teacher, c, optimizer, n_acc=n_acc,
                                   lr_schedule=lr_schedule, layout=layout)

        cur_nimg, it = start_nimg, start_nimg // eff_batch
        if sfdv:
            # SFD-v: num_steps drawn in [4, 7] per trajectory (training_loop.py:239-244)
            variants = {n: build(dataclasses.replace(cfg, num_steps=n, M=2 if n == 3 else 3))
                        for n in range(4, 8)}
            rng_steps = np.random.RandomState(args.seed)
            for _ in range(it):  # a resumed run draws on where the unbroken run would
                rng_steps.randint(4, 8)

            def train_step(*a):
                return variants[int(rng_steps.randint(4, 8))](*a)
        else:
            train_step = build(cfg)

        collector = training_stats.default_collector
        jsonl = training_stats.JsonlWriter(os.path.join(run_dir, "stats.jsonl"))
        timer = Timer()
        total = args.total_kimg * 1000
        print0(f"Training for {args.total_kimg} kimg (batch {eff_batch}) on {device}, "
               f"{layout.world} process(es)...")
        if args.sp > 1:
            ring_attention.reset_sp_dispatch()
            ring_attention.set_sp_context(layout)
            print0(f"Sequence parallel: ring attention over (data, seq) = ({layout.dp}, "
                   f"{layout.sp})")
        try:
            while cur_nimg < total:
                batch_seeds = (np.arange(it * eff_batch, (it + 1) * eff_batch) + args.seed).tolist()
                latents = stacked_randn(batch_seeds, (res, res, chn), device=device)
                if context_fn is not None:
                    cond = (torch.as_tensor(context_fn(it), device=device),)
                elif label_dim:
                    # one random class per trajectory (training_loop.py:181-182)
                    idx = stacked_randint(batch_seeds, (), 0, label_dim, device=device)
                    cond = (F.one_hot(idx, label_dim).float(),)
                else:
                    cond = ()
                metrics = train_step(latents, *cond)
                training_stats.report("Loss/loss", metrics["loss_per_step"].cpu().numpy())
                cur_nimg += eff_batch
                it += 1
                if it % args.tick == 0 or cur_nimg >= total:
                    collector.update()
                    t = timer.tick(cur_nimg)
                    peak = (f" peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f}GiB"
                            if device.type == "cuda" else "")
                    print0(f"kimg {cur_nimg / 1e3:<8.2f} loss {collector.mean('Loss/loss'):<10.4f} "
                           f"sec/kimg {t['sec_per_kimg']:<8.1f}{peak}")
                    jsonl.write(collector, kimg=cur_nimg / 1e3, **t)
                    collector.reset()
                if it % (args.tick * args.snap) == 0 or cur_nimg >= total:
                    path = os.path.join(run_dir, f"snapshot-{cur_nimg // 1000:06d}.npz")
                    save_snapshot(path, student, optimizer, cur_nimg, write=rank0)
                    print0(f"Saved {path}")
        finally:
            jsonl.close()
            if args.sp > 1:
                ring_attention.log_sp_dispatch(print0)
                ring_attention.set_sp_context(None)
        print0("Done.")
        return run_dir


if __name__ == "__main__":
    main()
