"""Smoke run of the PyTorch / CUDA port (``diff_sampler_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each printing as it goes and then its seconds:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, nvcc, whether triton imports.
2. Build kernels K1 (flash-attention forward on the tensor cores: bf16,
   and f32 in 3xTF32), K2 (its backward on the tensor cores: bf16, and f32
   in 3xTF32), K1c / K2c (the same on the flat layout), K3 (fused
   GroupNorm) and K4 (direct 3x3 conv) from ``csrc/`` with nvcc, one
   process per source; print each kernel's registers and spills, and the
   HMMA (tensor-core) instructions of each bf16 and f32 K1 / K1c and K2 /
   K2c instantiation in the library's SASS (``cuobjdump -sass``): each must
   have some (bf16 K2: HMMA.16816.F32.BF16; f32: HMMA.1688.F32.TF32) and
   spill nothing; each K4 instantiation (plain and fused) must run on
   wgmma (bf16: HGMMA.*BF16; f32: HGMMA.*TF32) and spill nothing, its
   registers printed, with any ptxas line about wgmma.  At head
   dims below 128 K1 / K2 stand in for the JAX
   package's packed and streamed twins (K1b, K2p, K2b).
3. K1 against its plain PyTorch version at the CIFAR-10 path's shapes, on
   the strided q/k/v views that ``attention()`` hands it: max abs error of
   the output and of the log-sum-exp against stated tolerances (bf16 out:
   relative to max|plain out|), two runs bit-identical, the route
   (``fwd_route``: kernel, padded d, load mode, tiles), and the
   times of K1, the plain version and ``F.scaled_dot_product_attention``
   (CUDA events, after warm-up, in turns), K1 on contiguous copies beside
   the gathered views; the fields of the bf16 and of the f32 main shape on
   lines of their own, and the library's f32 kernel by name (one profiled
   call).
4. The full-width CIFAR-10 EDMPrecond, random weights redrawn at unit scale:
   D(x, sigma) in f32 with K1 + K3 against the plain attention and the plain
   GroupNorm, TF32 off, 1e-4 * max; exactly 6 K1 and 73 K3 launches per
   forward; one profiled f32 forward.
5. The CIFAR-10 sampling path: ``generate`` on 256 seeds, batch 256, bf16
   inner model, ipndm on the poly-7 schedule at NFE 5/10/35; finite output,
   per-seed rows, K1 launches = 6 x NFE and K3 launches = 73 x NFE, images/sec;
   then the sampling CLI on the same seeds, whose PNGs must encode the NFE-5
   images exactly; a ``torch.profiler`` breakdown of one batch-256 forward,
   and its time with K3 against the plain GroupNorm.
6. Kernel K2 (the dQ and the dK/dV kernels) against its plain PyTorch
   version at the AMED path's shapes (batch 512, T=256 and T=64, H=1,
   d=256) in f32 and bf16, a d=64 multi-head shape and a ragged T, on the
   strided q/k/v views and a non-contiguous dO: max abs error of dq, dk and
   dv against stated tolerances, the times of K2, the plain version and the
   backward of ``F.scaled_dot_product_attention``, and bit-identical results
   from two runs; each shape's route (``bwd_route``: bf16 on the tensor
   cores from the qkv rows, f32 in 3xTF32) and the bounds of its dQ and
   dK/dV kernels, in f32 3xTF32's beside the CUDA cores'.
7. The gradient of sum(D(x, sigma) * g) with respect to x and sigma through
   the full-width f32 CIFAR-10 EDMPrecond (unit-scale weights, TF32 off),
   with K1 + K2 + K3 against the plain attention and the plain GroupNorm;
   exactly 6 K2 pairs per backward.
8. The CIFAR-10 AMED path: ``cli.train_amed`` at the CLI defaults (batch 512
   at once, f32 net, 4 steps, student amed, teacher heun) for two
   iterations, with peak memory and sec/kimg; the loss is finite, the
   predictor moves, its files are written, and K1 / K2 / K3 launch exactly as
   predicted.  Then ``cli.sample --predictor`` on 256 seeds from the saved
   predictor: finite images, exact launches, images/sec.
9. K1 against its plain version at the ImageNet-64 shapes (d=64, where the
   JAX package takes the packed K1b: T=1024 H=6, T=256 H=9, T=64 H=12) at
   sampling batch 256 in bf16 and at the AMED microbatch in f32, and one
   d=32 shape: errors against the tolerances of phase 3, two runs
   bit-identical, and the times of K1, the plain version and
   ``F.scaled_dot_product_attention``.
10. K2 against its plain version at the ImageNet-64 AMED shapes (the packed
   K2p's) in f32 and bf16 with a non-contiguous dO: errors against K2's
   tolerances, two runs bit-identical, and the times of K2, the plain
   version and the library backward.
11. The full-width ImageNet-64 EDMPrecond (DhariwalUNet, 296M parameters),
   f32, unit-scale weights, TF32 off, batch 8 with one-hot labels: D with
   K1 + K3, and d sum(D g) / d(x, sigma) with K1 + K2 + K3, against the
   plain attention and the plain GroupNorm; exactly 22 K1 and 95 K3
   launches per forward and 22 K2 pairs per backward.
12. The ImageNet-64 sampling path: ``generate`` on 256 seeds, batch 256,
   bf16, ipndm, poly-7, NFE 5/10/35, per-seed labels: finite images, K1
   launches = 22 x NFE, K3 95 x NFE, per-seed rows, the sampling CLI's PNGs,
   images/sec.
13. The ImageNet-64 AMED path: ``cli.train_amed --dataset_name=imagenet64
   --afs=True`` at batch 512 with ``--batch_gpu`` accumulation for two
   iterations (finite losses, the predictor moves, launches as predicted,
   sec/kimg, peak memory), then ``cli.sample --predictor`` at NFE 5 on 256
   seeds (launches, images/sec); then a ``torch.profiler`` breakdown of one
   f32 D gradient of the full net at batch 8: exactly 22 K1, 22 K2 dQ and
   22 K2 dK/dV kernels, and no f32 attention backward on the CUDA cores.
14. A ``torch.profiler`` breakdown of one batch-256 bf16 ImageNet-64
   forward by ``utils/profiling.py::CATEGORIES`` (K1 and K3 their own lines),
   and its time with K3 against the plain GroupNorm.
15. K3 against its plain version (``reference_groupnorm_silu``) at the LSUN
   LDM's shapes: the U-Net's four levels in bf16 at batch 64 (group sizes 7,
   14, 21, 49), with and without SiLU, the VQ decoder's three levels in f32
   at batch 16, CIFAR-10's 32x32 level at its sampling batch (bf16) and
   AMED batch (f32), and ImageNet-64's levels at its AMED microbatch (f32,
   group sizes 6 to 24) and its 64x64 level at its sampling batch (bf16):
   each shape's route (``ops/groupnorm.py::gn_route``: the one-kernel
   cluster slab with its cluster size, the clusters the card holds at once,
   blocks and shared memory, or the two-kernel streamed pass), and on that
   route and, where both apply, on the other one, errors against stated
   tolerances and two runs bit-identical; the times of K3 on both routes,
   the plain version and ``F.group_norm`` (+ ``F.silu``) on the
   channels-last NCHW view, GB/s, and the bound by bytes.
16. K1 at the LSUN LDM's attention shapes (d=32, 14 / 21 / 28 heads) and K2
   at K2b's shape (the AMED microbatch, T=1024, 14 heads, f32 and bf16) and
   K2p's (T=256, 21 heads), on the legacy qkv views ([B, T, H, 3d], head
   stride 3d) with a non-contiguous dO, as phases 9-10 do; then K2 in bf16
   at the ADM-G classifier's levels on the same views at batch 64 ([64,
   1024, 4, 64], [64, 256, 8, 64]).
17. The full-width LSUN-Bedroom LDM U-Net (274M parameters) under its
   CFGPrecond, f32, unit-scale weights, TF32 off, batch 8: D and d sum(D g)
   / d(x, sigma) with K1 + K2 + K3 against the all-plain model (plain
   attention and plain GroupNorm), 1e-4 * max; exactly 16 K1 and 61 K3
   launches per forward and 16 K2 pairs per backward.
18. The LSUN LDM sampling path: ``generate`` on 64 seeds, batch 64, bf16,
   ipndm on the discrete schedule (rho 1) at NFE 5 and 10, then the VQ
   decode to 256 x 256 in chunks of 16, f32: finite images, per-seed rows,
   exact launches (16 K1 and 61 K3 per net call, 24 K3 per decoded chunk),
   images/sec with and without the decode, the sampling CLI's PNGs.
19. The LSUN LDM AMED path: ``cli.train_amed --dataset_name=lsun_bedroom_ldm
   --afs=True`` at batch 512 with ``--batch_gpu`` accumulation for two
   iterations (sec/kimg, peak memory, exact launches, and the dQ and dK/dV
   kernels' launches at each (T, H) as their wrappers count them), then
   ``cli.sample --predictor`` at NFE 5 on 64 seeds.
20. ``torch.profiler`` over one batch-64 bf16 LDM U-Net forward and one
   batch-16 VQ decode, device time by category, and each one's time with
   K3 against the plain GroupNorm.
21. K1 and K2 at Stable Diffusion's head dims (40 / 80 / 160, padded inside
   the kernels): K1 at the guided sampling call's four levels in bf16 and
   at the f32 AMED microbatch's three K1 levels, K2 at the f32 AMED shapes
   and one bf16, against the plain versions and the library, as phases 9-10.
22. K1c and K2c (the flat [B*H, T, d] kernels) at SD's f32 64x64 level of
   the AMED microbatch ([128, 4096, 40]) and a ragged T, and both in bf16,
   against their plain versions at K1's and K2's tolerances, K2c two runs
   bit-identical, timed in turns against the plain versions, the library
   and K1 on the same data in the [B, T, H, d] layout.
23. The full-width SD v1.5 U-Net (860M parameters) under its guided
   CFGPrecond (guidance 7.5, a doubled batch of 4), f32, unit-scale weights,
   TF32 off, seeded random contexts: D and d sum(D g) / d(x, sigma) against
   the all-plain model, 1e-4 * max; exactly 11 K1, 5 K1c and 61 K3 launches
   per forward, 11 K2 and 5 K2c pairs per backward; one profiled guided f32
   U-Net call.
24. SD sampling: ``generate`` on 8 seeds with bound contexts, bf16, ipndm on
   the discrete schedule at NFE 5 and 10 (16 K1 and 61 K3 per guided U-Net
   call, no K1c), then the f32 KL decode of the 8 latents to 512 x 512:
   finite images, exact launches, latents/s and images/s.
25. SD AMED: ``train_amed.build_trainer`` for ms_coco at guidance 7.5, batch
   8 in one microbatch, f32, AFS, two iterations (sec/kimg, peak memory,
   exact K1 / K1c / K2 / K2c / K3 launches), then AMED sampling at NFE 5
   through ``bind_with_bottleneck(..., cfg_doubled=True)``.
26. ``torch.profiler`` over one guided bf16 SD U-Net call at batch 16.
27. K4 through its entry points (no JAX path calls its Pallas twin):
   ``conv3x3`` and ``gn_silu_conv3x3`` once each at the two main shapes in
   bf16, then in f32, with the counts set to 0 before each dtype (its
   launches, and the f32 split kernel's), then each at CIFAR-10's
   [256, 32, 32, 256] -> 256 and FFHQ's [256, 64, 64, 128] -> 128 and a
   ragged [3, 7, 5, 128] -> 384, in bf16 and f32, against
   ``reference_conv3x3`` (f32 1e-5, bf16 2^-7 of max|plain out|; b ~ 0.5,
   so a wrong halo shows; matmuls and cuDNN with TF32 off), two runs
   bit-identical, timed against the plain version and ``F.conv2d`` (after a
   SiLU pass for the fused entry point) with the rate in TFLOP/s and the
   bound (f32: 3xTF32, the CUDA cores' beside); at the main shapes also the
   wrapper's w copy (bf16) or the split kernel (f32, bit-equal to
   ``split_tf32``) and its host time.
28. FFHQ-64 (BASELINE config 2's net) at full width: D in f32 against the
   all-plain model (1e-4 * max, exactly 6 K1 and 95 K3 per forward); bf16
   sampling at batch 256 through every registry solver (DEIS tab and rhoab,
   UniPC bh1 and bh2) at NFE 5 and 10, images/s and exact launches; the CLI
   with ``--solver=unipc --grid=True`` (grid.png byte-equal to the grid of
   ``generate``'s images) and ``--return_inters=True`` (trajectory.npz's
   shape); one profiled forward.
29. GITS on CIFAR-10 through the CLI at the reference's settings (6 steps
   from a 61-point ipndm teacher, 256 warmup seeds at batch 256, dev metric,
   coefficient 1.15), ``--afs=False`` then ``--afs=True``: the dp_list's
   form, the search seconds, and images/s on the found schedule.
30. The same on the LSUN-Bedroom LDM (BASELINE config 4) in bf16 at batch 64,
   ``--afs=False``, then sampling and the VQ decode of 64 seeds.
31. Checkpoint loading at full width: the 56M-parameter CIFAR-10
   EDMPrecond from seed 0, redrawn at unit scale, written as EDM's ``.pkl``
   (a plain pickle of {'ema': module}, legacy storages, every module below
   torch's containers pickled through ``torch_utils.persistence`` as EDM's
   layer classes are) and as a torch zip
   of its state_dict into a temporary directory; ``create_model('cifar10',
   path)`` on each, with the file's size, the host seconds and MB/s: every
   tensor bit-equal, D at batch 64 in f32 bit-equal to the source net's
   (6 K1 and 73 K3); then ``cli.sample --model_path=<.pkl>`` at NFE 5,
   batch 256, bf16, its PNGs byte for byte ``generate``'s images, with
   exactly 30 K1 and 365 K3 launches.
32. Stable Diffusion from a checkpoint with text: a full-width SD v1.5
   checkpoint in ``v1-5-pruned-emaonly.ckpt``'s layout from seeded random
   weights in f16 storages (``model.diffusion_model.*``, the KL
   ``first_stage_model`` encoder, decoder, ``quant_conv`` and
   ``post_quant_conv``, ``cond_stage_model.transformer.text_model.*`` with
   ``position_ids``, the EMA counters and the DDPM buffers), a synthetic
   BPE merges file through $CLIP_BPE_VOCAB and a 64-row captions CSV in
   ``./models``, all in a temporary directory; ``create_model('ms_coco',
   path)``: its load seconds and MB/s, every loaded tensor bit-equal to the
   file's, the text tower bound; the tower in f32 (TF32 off) on 64 prompts,
   timed, against its own CPU run at 1e-4 * max|out|; ``cli.sample`` with
   ``--prompt`` and with a caption per seed, batch 8, ipndm NFE 5, bf16,
   guidance 7.5, each byte for byte ``generate`` on
   ``get_learned_conditioning``'s contexts with its latents/s with and
   without the text encode, and exactly 80 K1 (SD's 16 sites at d = 40 /
   80 / 160) and the U-Net's and decoder's K3; two AMED iterations through
   ``train_amed.build_trainer`` on the checkpoint and the captions (f32, K1,
   K1c, K2 and K2c launched as in phase 25).
33. FID and PRDC of CIFAR-10 samples (run after phase 31, in its directory):
   a synthetic CIFAR-10 python tarball (5 batches of 2,000 uint8 images from
   the seed) through ``cli.dataset_tool`` to a zip of 10,000 PNGs and
   dataset.json; a random Inception detector (He-scaled convs, BN of order
   one, from a numpy seed) written as a torch zip of a torchvision-named
   state_dict and as a plain pickle of a module tree in TF graph order, both
   imports equal; the detector on the card (f32, TF32 off inside it while
   the caller's flags are on) against its CPU run on 16 images at 32 px
   through both preprocessing paths, within 1e-4 * max|f|; ``fid ref`` of
   the dataset and ``fid calc`` of the dataset against it, |FID| <= 1e-3 *
   trace(sigma), and bit-equal to ``compute_fid`` on stats built in this
   process; 10,000 samples of phase 31's ``.pkl`` through ``cli.sample``
   (ipndm NFE 5, batch 256, bf16; exact K1 / K3 launches), ``fid calc`` of
   them with its host seconds split into PNG decode, features and sqrtm,
   ``prdc calc --num 5000`` with the graph-order pickle, whose decisions
   must equal float64 ones (numpy, spot-checked against
   ``scipy.spatial.distance.cdist``) but for pairs within 1e-5 of their
   radius (counted); the detector's images/s at batch 250 against its f32
   bound (FLOPs from its conv shapes over 67 TFLOP/s); the seconds of
   dataset_tool, fid and prdc.
34. LSUN-Bedroom 256 (the consistency-models ADMUNet under CMPrecond):
   (a) K1 and K2 against their plain versions at the 256 px tiers'
   attention shapes (the U-Net's and the classifier's legacy views at d=64,
   bf16 at batch 8 and f32 at the AMED microbatch; the attention pool's
   new-order views at the ragged T=65) and K3 at their GroupNorm shapes
   ([8, 256, 256, 256], on the stream route, down to [8, 8, 8, 1024]), as
   phases 3, 6 and 15; (b) the full-width f32 D and its input gradient with
   K1 + K2 + K3 against the all-plain model (unit-scale weights, TF32 off,
   batch 4), 1e-4 * max, exact launches; (c) bf16 sampling through
   ``generate`` at NFE 5 and 10, batch 8 (images/sec, exact launches,
   per-seed rows) and the sampling CLI's PNGs; (d) AMED through
   ``train_amed.build_trainer`` at batch 16 in microbatches of 8, f32, two
   iterations (s/kimg, peak memory, exact K1 / K2 f32 launches), then
   ``cli.sample --predictor`` from the saved predictor.  Each prints its
   peak memory.
35. ImageNet-256 with classifier guidance (the ADMUNet and its noisy
   classifier under CGPrecond): (a) the full-width f32 D, and the
   classifier's gradient alone, against the all-plain model (batch 4, TF32
   off), exact launches; (b) bf16 sampling with integer per-seed labels at
   NFE 5 and 10, batch 8, through ``generate`` and the CLI with
   ``--guidance_type=cg``: every call launches the bf16 K2 (dQ and dK/dV)
   through the classifier's gradient, counted; one call split by CUDA
   events into the U-Net, the classifier's forward and its backward, and
   one profiled; (c) the AMED step on imagenet256 raises the attention
   kernels' second-order refusal instead of training.
36. The three tiers from reference-layout files written from seeded
   full-width nets in f16 storages, the attention's 1x1 convs as Conv1d
   [O, I, 1]: ``edm_bedroom256_ema.pt`` and ``256x256_diffusion.pt`` +
   ``256x256_classifier.pt``, found by the zoo's resolver in
   ./checkpoints, and a ``lsun_cat`` file by its path; each loaded
   strictly through ``create_model`` (host seconds, MB/s), every tensor
   bit-equal to the file's, D bit-equal to that of ``torch.load``'s
   weights.

The last three lines are the card's name and power limit, a JSON object on
the kernels and ``{"ok": true, "device": {...}}``.  The JSON lists K1 and
K2 at the CIFAR-10 paths (d=256, launches of phases 5 and 8), K2 in bf16
on the ImageNet-256 classifier-guidance path (launches of phase 35, times
at the classifier's T=1024 level), K1 and K2 at
the ImageNet-64 paths (d=64, in place of K1b and K2p, launches of phases 12
and 13), the f32 K1 (3xTF32) at the CIFAR-10, ImageNet-64 and SD AMED
paths (launches of phases 8, 13 and 25), K2 at the LSUN LDM's T=1024 level (in place of K2b, launches of
phase 19 at that shape), K3 at the CIFAR-10, LSUN LDM, ImageNet-64 and VQ
decode shapes with its route there (launches of phases 5, 18, 12 and 18's
decode), K1 and K2 at SD's head
dims (launches of phases 24 and 25), K1c and K2c (launches of phase 25) and
K4 in bf16 and in f32 and the f32 K4's split of w (launches of its entry
points in phase 27), K1 and K3 on the CIFAR-10 samples that phase 33
scores (its launches; the evaluation path itself adds no kernel: the
detector's convs, its pools, FID's moments and PRDC's distances are
PyTorch calls, as they are XLA ops in the JAX package), K1 and K3 on both
256 px tiers and K1 / K2 in f32 on the CM AMED path (launches of phases 34
and 35), each with its error and times at that path's main
shape and its bound on this card (the f32 attention kernels' and the f32
K4's: 3xTF32 on the tensor cores).  Every profile (phases 4,
5, 13, 14, 20, 23, 26, 28, 35) checks that no attention forward and no
attention backward ran on the CUDA cores, that its trace holds every
kernel of the repo that the wrappers launched in the profiled call (K3's
one or two a launch, as its wrapper counts them by route), and prints K3's
share of the device time.
Any failed check raises, so the script
exits non-zero with no result; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import io
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tarfile
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from diff_sampler_tpu_torch import _build
from diff_sampler_tpu_torch.cli import dataset_tool as cli_dataset_tool
from diff_sampler_tpu_torch.cli import fid as cli_fid
from diff_sampler_tpu_torch.cli import prdc as cli_prdc
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed as cli_train_amed
from diff_sampler_tpu_torch.eval import prdc as P
from diff_sampler_tpu_torch.eval.dataset import ImageFolderDataset
from diff_sampler_tpu_torch.eval.fid import (calculate_stats, compute_fid, load_stats,
                                             make_inception_feature_fn)
from diff_sampler_tpu_torch.eval.inception import (CONV_UNITS_GRAPH_ORDER, InceptionV3FID,
                                                   import_inception_state_dict,
                                                   import_nvidia_inception_pickle)
from diff_sampler_tpu_torch.models import adm, layers
from diff_sampler_tpu_torch.models.convert import params_to_jax
from diff_sampler_tpu_torch.models.factory import create_model, init_params
from diff_sampler_tpu_torch.models.ldm import reference_state_dict
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.models.torch_import import load_torch_file, torch_state_dict
from diff_sampler_tpu_torch.models.text import FrozenCLIPEmbedder
from diff_sampler_tpu_torch.ops import attention as A
from diff_sampler_tpu_torch.ops import conv as C
from diff_sampler_tpu_torch.ops import groupnorm as G
from diff_sampler_tpu_torch.sampling import SolverConfig, generate, to_uint8
from diff_sampler_tpu_torch.solvers import SOLVER_REGISTRY
from diff_sampler_tpu_torch.training.amed import AMEDConfig, predictor_from_config
from diff_sampler_tpu_torch.training.conditioning import (make_caption_context_fn,
                                                          make_uncond_context)
from diff_sampler_tpu_torch.utils import checkpoint as ckpt
from diff_sampler_tpu_torch.utils.image import encode_png, save_grid
from diff_sampler_tpu_torch.utils.profiling import device_breakdown
from diff_sampler_tpu_torch.utils.rng import stacked_randn

# Tolerances of K1 against the plain version on identical inputs.  f32: both
# accumulate in f32 in other orders.  bf16: the output is rounded to bf16 on
# both sides, from f32 values that differ in where the softmax weights are
# rounded to bf16, so an element may land a bf16 step (2^-8 to 2^-7 of
# max|out|) or two away: 2^-5 of max|plain out|, and at most 2^-5.  The lse
# is f32 on both.
LSE_TOL = 1e-5


def _out_tol(dtype, ref_out) -> float:
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** -5 * min(1.0, ref_out.float().abs().max().item())


# (B, T, H, d, dtype): the CIFAR-10 path's two attention shapes at batch 256
# in both dtypes, the AMED path's at batch 512 in f32, a later slice's d=64
# multi-head shape, and a ragged T.
K1_SHAPES = [
    (256, 256, 1, 256, torch.bfloat16),
    (512, 256, 1, 256, torch.float32),  # the AMED path's (batch 512, f32)
    (256, 256, 1, 256, torch.float32),
    (256, 64, 1, 256, torch.bfloat16),
    (256, 64, 1, 256, torch.float32),
    (8, 1024, 4, 64, torch.bfloat16),
    (16, 200, 2, 64, torch.bfloat16),
    (16, 200, 2, 64, torch.float32),
]
ATTENTION_SITES = 6  # per CIFAR-10 SongUNet forward (models/unets.py layout)
CIFAR_GN_SITES = 73  # K3 per CIFAR-10 SongUNet forward
BATCH = 256
NFE_STEPS = [(5, 6), (10, 11), (35, 36)]  # (NFE, num_steps) for ipndm
# (B, T, H, d, dtype) of K2: the AMED path's two attention shapes at the CLI's
# batch 512 in both dtypes, a later slice's d=64 multi-head shape, a ragged T.
K2_SHAPES = [
    (512, 256, 1, 256, torch.float32),
    (512, 256, 1, 256, torch.bfloat16),
    (512, 64, 1, 256, torch.float32),
    (512, 64, 1, 256, torch.bfloat16),
    (8, 1024, 4, 64, torch.bfloat16),
    (8, 1024, 4, 64, torch.float32),
    (16, 200, 2, 64, torch.float32),
    (16, 200, 2, 64, torch.bfloat16),
]
# Tolerance of K2 against the plain version, relative to max|plain grad|.
# f32: both sum in f32 in other orders.  bf16: both round P, dS and the
# grads to bf16 from f32 values that may differ in the last f32 bit, so a
# grad may land one bf16 step (2^-7 of its scale) away, plus the rare P or
# dS term rounded the other way: 2^-6.
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# The AMED path (cli/train_amed.py defaults): 4 steps, student amed (one
# net call with a gradient per segment), teacher heun with M=1 inserted
# step per segment.
AMED_BATCH = 512  # fits at once: no --batch_gpu accumulation (57 GiB, PERF.md)
AMED_STEPS = 4
AMED_KIMG = 1
AMED_ITERS = math.ceil(AMED_KIMG * 1000 / AMED_BATCH)  # 2

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
# the tensor cores in bf16 and in TF32, the CUDA cores in f32, and HBM3.  A
# kernel's bound is the larger of its operations over the rate of its input
# type and its bytes (each input read once, each output written once) over
# HBM's.  The f32 attention kernels (K1, K1c, K2, K2c) run in 3xTF32 on the
# tensor cores: three TF32 products for each f32 one.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

# The ImageNet-64 path (EDM_ARCHS["imagenet64"], DhariwalUNet, d=64): 22
# attention sites per forward, 7 at 32x32 (T=1024, 6 heads), 7 at 16x16
# (T=256, 9 heads) and 8 at 8x8 (T=64, 12 heads); 95 GroupNorms.
IN64_SITES = 22
IN64_GN_SITES = 95
IN64_LEVELS = [(1024, 6), (256, 9), (64, 12)]  # (T, H)
# AMED on ImageNet-64 at the CLI's batch 512 accumulates microbatches of 128
IN64_BATCH_GPU = 128
IN64_AMED_AFS = True  # NFE 5 at 4 steps, as BASELINE config 3 samples
# K1 where the JAX package takes the packed K1b: at the sampling batch in
# bf16 and the AMED microbatch in f32, plus a d=32 shape
IN64_K1_SHAPES = ([(BATCH, t, h, 64, torch.bfloat16) for t, h in IN64_LEVELS]
                  + [(IN64_BATCH_GPU, t, h, 64, torch.float32) for t, h in IN64_LEVELS]
                  + [(BATCH, 256, 6, 32, torch.bfloat16)])
# K2 where the JAX package takes the packed K2p: at the AMED microbatch in
# f32 (the path's dtype) and bf16
IN64_K2_SHAPES = ([(IN64_BATCH_GPU, t, h, 64, torch.float32) for t, h in IN64_LEVELS]
                  + [(IN64_BATCH_GPU, 1024, 6, 64, torch.bfloat16)])

# The LSUN-Bedroom LDM path (LDM_CONFIGS["lsun_bedroom_ldm"], BASELINE config
# 4's net): 64x64x3 latents, legacy attention at d=32 on 16 sites per U-Net
# forward, 5 at 32x32 (T=1024, 14 heads), 5 at 16x16 (T=256, 21 heads), 6 at
# 8x8 (T=64, 28 heads); 61 GroupNorms per U-Net forward, 24 per VQ decode.
LDM = "lsun_bedroom_ldm"
LDM_SITES = 16
LDM_GN_SITES = 61
DECODE_GN_SITES = 24
LDM_LEVELS = [(1024, 14), (256, 21), (64, 28)]
LDM_LATENT = (64, 64, 3)
LDM_IMAGE = (256, 256, 3)
LDM_BATCH = 64  # cli.sample's default batch
LDM_NFE_STEPS = [(5, 6), (10, 11)]
DECODE_CHUNK = 16  # the CLI decodes 16 latents at a time, in f32
# AMED on the LDM at the CLI's batch 512 accumulates microbatches of 128, the
# largest power of two that fits (38.5 GiB peak; 256 runs out of the 80 GB)
LDM_BATCH_GPU = 128
LDM_AMED_AFS = True  # NFE 5 at 4 steps
LDM_K1_SHAPES = ([(LDM_BATCH, t, h, 32, torch.bfloat16) for t, h in LDM_LEVELS]
                 + [(LDM_BATCH_GPU, t, h, 32, torch.float32) for t, h in LDM_LEVELS])
# K2 where the JAX package streams K2b (the first: T=1024 in f32 at the AMED
# microbatch, the main shape), in bf16, and where it takes K2p (T=256, T=64)
LDM_K2_SHAPES = [(LDM_BATCH_GPU, 1024, 14, 32, torch.float32),
                 (LDM_BATCH_GPU, 1024, 14, 32, torch.bfloat16),
                 (LDM_BATCH_GPU, 256, 21, 32, torch.float32),
                 (LDM_BATCH_GPU, 64, 28, 32, torch.float32)]
# K2 in bf16 at the ADM-G classifier's attention levels (ADMClassifier at
# 256 px, 4 heads of 64 at 32x32, 8 at 16x16; JAX models/adm.py) on the
# legacy views at the sampling CLI's batch 64: the shapes of the classifier
# gradient of bf16 guided sampling, a yardstick for when that tier is ported
ADMG_K2_SHAPES = [(64, 1024, 4, 64, torch.bfloat16), (64, 256, 8, 64, torch.bfloat16)]
# (N, H, W, C, dtype, eps, silu) of K3: the LDM U-Net's four levels in bf16 at
# the sampling batch (the first, with SiLU, is the main shape), the VQ
# decoder's three levels in f32 at its chunk of 16; CIFAR-10's 32x32 level
# (eps 1e-6, SiLU off as its GroupNorm layers call it) in bf16 at the sampling
# batch and in f32 at the AMED batch; ImageNet-64's four levels (group sizes
# 6 to 24, eps 1e-5) in f32 at the AMED microbatch, and its 64x64 level in
# bf16 at the sampling batch
GN_SHAPES = ([(LDM_BATCH, 64, 64, 224, torch.bfloat16, 1e-5, True),
              (LDM_BATCH, 32, 32, 448, torch.bfloat16, 1e-5, True),
              (LDM_BATCH, 16, 16, 672, torch.bfloat16, 1e-5, True),
              (LDM_BATCH, 8, 8, 1568, torch.bfloat16, 1e-5, True)]
             + [(LDM_BATCH, s, s, c, torch.bfloat16, 1e-5, False)
                for s, c in ((64, 224), (32, 448), (16, 672), (8, 1568))]
             + [(DECODE_CHUNK, 64, 64, 512, torch.float32, 1e-6, True),
                (DECODE_CHUNK, 128, 128, 256, torch.float32, 1e-6, True),
                (DECODE_CHUNK, 256, 256, 128, torch.float32, 1e-6, True),
                (BATCH, 32, 32, 256, torch.bfloat16, 1e-6, False),
                (AMED_BATCH, 32, 32, 256, torch.float32, 1e-6, False),
                (BATCH, 64, 64, 192, torch.bfloat16, 1e-5, False)]
             + [(IN64_BATCH_GPU, s, s, c, torch.float32, 1e-5, False)
                for s, c in ((64, 192), (32, 384), (16, 576), (8, 768))])
# Tolerance of K3 against the plain version, relative to max(1, max|plain
# out|): f32 1e-5 (K3's exact two-pass statistics merge blocks, chunks and
# cluster ranks in f64; the plain
# version takes E[x^2] - E[x]^2 in f32); bf16 2^-7, one bf16 step of the
# largest output for an element whose f32 values straddle a rounding boundary.
GN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

# The Stable Diffusion v1.5 path (LDM_CONFIGS["ms_coco"], BASELINE config 5's
# net): 64x64x4 latents, the 860M-parameter cross-attention U-Net, 16
# self-attention sites per U-Net call with 8 heads, 5 at 64x64 (T=4096, d=40),
# 5 at 32x32 (T=1024, d=80), 5 at 16x16 (T=256, d=160) and the middle block's
# at 8x8 (T=64, d=160); the KL decoder to 512x512.  In f32 the 64x64 sites take
# K1c / K2c (flat), as the JAX package's dispatcher routes them; in bf16 all
# 16 take K1.  Classifier-free guidance at 7.5 doubles every U-Net call.
SD = "ms_coco"
SD_LEVELS = [(4096, 40, 5), (1024, 80, 5), (256, 160, 5), (64, 160, 1)]  # (T, d, sites)
SD_HEADS = 8
SD_SITES = 16
SD_FLAT_SITES = 5  # f32, T=4096
SD_LATENT = (64, 64, 4)
SD_IMAGE = (512, 512, 3)
SD_GUIDANCE = 7.5
SD_BATCH = 8  # images per sampling batch: 16 per U-Net call
SD_NFE_STEPS = [(5, 6), (10, 11)]
SD_AMED_BATCH = 8  # trajectories per AMED iteration (the --batch of train_amed)
SD_BATCH_GPU = 8  # AMED microbatch: 16 per guided U-Net call, f32
SD_AMED_ITERS = 2
SD_AMED_AFS = True  # NFE 5 at 4 steps
# K1 at SD's head dims: the sampling call's shapes in bf16 (the first is the
# main one), the AMED microbatch's in f32 where the route keeps K1
SD_K1_SHAPES = ([(2 * SD_BATCH, t, SD_HEADS, d, torch.bfloat16) for t, d, _ in SD_LEVELS]
                + [(2 * SD_BATCH_GPU, t, SD_HEADS, d, torch.float32)
                   for t, d, _ in SD_LEVELS[1:]])
# K2 where the f32 AMED backward keeps it (the first is the main shape), and
# its 32x32 level in bf16
SD_K2_SHAPES = ([(2 * SD_BATCH_GPU, t, SD_HEADS, d, torch.float32) for t, d, _ in SD_LEVELS[1:]]
                + [(2 * SD_BATCH_GPU, 1024, SD_HEADS, 80, torch.bfloat16)])
# (B * H, T, d, dtype) of K1c / K2c: the f32 AMED microbatch's 64x64 level
# (the main shape) and a ragged T; in bf16 (no path takes the flat kernels
# in bf16) one guided latent's 64x64 level (2 x 8 heads) and the ragged T
SD_FLAT_SHAPES = [(2 * SD_BATCH_GPU * SD_HEADS, 4096, 40, torch.float32),
                  (24, 1000, 40, torch.float32),
                  (2 * SD_HEADS, 4096, 40, torch.bfloat16),
                  (24, 1000, 40, torch.bfloat16)]

# K4, the direct 3x3 conv (no JAX path calls it: its entry points are the
# path).  (N, H, W, Cin, Cout, dtype): CIFAR-10's 32x32 level at the sampling
# batch (the shape the JAX kernel's docstring measured; the first of each
# dtype is its main one) and FFHQ's 64x64 level, in bf16 and f32, and a
# ragged shape (Cout ends inside an output-channel tile).  Each runs through
# conv3x3 and gn_silu_conv3x3 with b ~ 0.5, so a halo of silu(b) in place of
# 0 would show.
CONV_SHAPES = [(BATCH, 32, 32, 256, 256, torch.bfloat16),
               (BATCH, 64, 64, 128, 128, torch.bfloat16),
               (BATCH, 32, 32, 256, 256, torch.float32),
               (BATCH, 64, 64, 128, 128, torch.float32),
               (3, 7, 5, 128, 384, torch.bfloat16),
               (3, 7, 5, 128, 384, torch.float32)]
# Tolerance of K4 relative to max|plain out|: f32 1e-5 (both sum in f32 in
# other orders); bf16 2^-7, one bf16 step of the largest output for an
# element whose f32 sums straddle a rounding boundary.
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

# The FFHQ-64 path (EDM_ARCHS["ffhq"], BASELINE config 2's net): a SongUNet
# with levels 64 / 32 / 16 / 8 (128 / 256 / 256 / 256 channels), 6 attention
# sites (T=256 at 16x16, T=64 in the middle block; one head of 256) and 95
# GroupNorms per forward.
FFHQ_SITES = 6
FFHQ_GN_SITES = 95
FFHQ_SHAPE = (64, 64, 3)
# (solver, extra settings) at NFE 5 and 10: every solver of the registry,
# DEIS in both modes and UniPC in both variants
FFHQ_SOLVERS = [(name, {}) for name in sorted(SOLVER_REGISTRY) if name not in ("deis", "unipc")]
FFHQ_SOLVERS += [("deis", dict(deis_mode="tab")), ("deis", dict(deis_mode="rhoab")),
                 ("unipc", dict(variant="bh1")), ("unipc", dict(variant="bh2"))]
FFHQ_NFES = [5, 10]
FFHQ_TRAJ_SEEDS = 64  # the --return_inters CLI run

# GITS through the CLI at the reference's settings (gits-main's README):
# 6 student steps picked from a 61-point ipndm teacher over 256 warmup seeds,
# the "dev" metric at coefficient 1.15.  CIFAR-10 at batch 256, the LSUN LDM
# (BASELINE config 4) at batch 64 in bf16 with --afs=False (its --afs=True is
# a known fault of the reference, ROADMAP Queue 3).
GITS_ARGS = ["--dp=True", "--num_steps=6", "--num_steps_tea=61", "--num_warmup=256",
             "--metric=dev", "--coeff=1.15", "--solver_tea=ipndm", "--solver=ipndm"]


# The 256 px pixel tiers: lsun_bedroom (the consistency-models ADMUNet under
# CMPrecond) and imagenet256 (the ADMUNet with its noisy classifier under
# CGPrecond).  Attention at 32x32, 16x16 and 8x8 in heads of 64: the U-Net's
# legacy views [B, T, H, 64] at T=1024 H=8, T=256 H=16, T=64 H=16 (5, 5 and
# 6 sites); the classifier's at T=1024 H=4, T=256 H=8, T=64 H=8 (2, 2 and 3)
# and its attention pool's new-order views at T=65 H=8.  K3 from [B, 256,
# 256, 256] (one sample 33.5 MB in bf16: the stream route) down to [B, 8, 8,
# 1024].
CM, CG = "lsun_bedroom", "imagenet256"
ADM_SHAPE = (256, 256, 3)
ADM_BATCH = 8  # sampling batch (a CG call runs the net and the classifier on it)
ADM_NFE_STEPS = [(5, 6), (10, 11)]
ADM_CHECK_BATCH = 4  # the f32 parity of the full-width nets against the all-plain ones
ADM_AMED_BATCH = 16  # trajectories per CM AMED iteration, f32
ADM_BATCH_GPU = 8  # its microbatch
ADM_AMED_ITERS = 2
ADM_UNET_LEVELS = [(1024, 8), (256, 16), (64, 16)]  # (T, H) at d=64
ADM_CLS_LEVELS = [(1024, 4), (256, 8), (64, 8)]
ADM_K1_SHAPES = ([(ADM_BATCH, t, h, 64, torch.bfloat16) for t, h in ADM_UNET_LEVELS]
                 + [(ADM_BATCH, t, h, 64, torch.bfloat16) for t, h in ADM_CLS_LEVELS]
                 + [(ADM_BATCH_GPU, t, h, 64, torch.float32) for t, h in ADM_UNET_LEVELS])
ADM_K2_SHAPES = ([(ADM_BATCH, t, h, 64, torch.bfloat16) for t, h in ADM_CLS_LEVELS]
                 + [(ADM_BATCH_GPU, t, h, 64, torch.float32) for t, h in ADM_UNET_LEVELS])
ADM_POOL_SHAPES = [(ADM_BATCH, 65, 8, 64, torch.bfloat16),
                   (ADM_CHECK_BATCH, 65, 8, 64, torch.float32)]
ADM_GN_SHAPES = [(ADM_BATCH, 256, 256, 256, torch.bfloat16, 1e-5, True),
                 (ADM_BATCH, 256, 256, 256, torch.bfloat16, 1e-5, False),  # scale-shift
                 (ADM_BATCH, 256, 256, 128, torch.bfloat16, 1e-5, True),  # the classifier
                 (ADM_BATCH, 8, 8, 1024, torch.bfloat16, 1e-5, True),
                 (ADM_BATCH_GPU, 256, 256, 256, torch.float32, 1e-5, True)]
ADM_GN_ENTRIES = {"256 px": (ADM_BATCH, 256, 256, 256, torch.bfloat16)}

def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _run(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _turns(fns: dict, reps: int = 20, warmup: int = 3) -> dict:
    """Mean ms per call of each function, timed in turns forwards then
    backwards (a, b, c, c, b, a) so that drift between them cancels."""
    order = list(fns) + list(reversed(list(fns)))
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(_time_ms(fns[name], reps=reps, warmup=warmup))
    return {name: sum(v) / len(v) for name, v in times.items()}


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _attention_bound(kind: str, b: int, t: int, h: int, d: int, dtype,
                     cuda_cores: bool = False) -> tuple:
    """(bound_ms, bound_by) of one attention kernel on this card's published
    peaks.  kind: "fwd" (S = QK^T, O = PV: out and lse from q, k, v), "dq"
    (S, dP = dO V^T, dQ = dS K, from q, k, v, dO, lse, delta) or "dkv" (S,
    dP, dV = P^T dO, dK = dS^T Q); 2 flops per multiply-add.  In f32 (the
    3xTF32 kernels, forward and backward) three TF32 products per product
    at the TF32 rate, or with ``cuda_cores`` one f32 product at the CUDA
    cores' rate (the bound of the kernels they replaced)."""
    elt = torch.empty((), dtype=dtype).element_size()
    tensor, stats = b * t * h * d * elt, b * h * t * 4
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = products * 2 * b * h * t * t * d
    nbytes = {"fwd": 4 * tensor + stats, "dq": 5 * tensor + 2 * stats,
              "dkv": 6 * tensor + 2 * stats}[kind]
    if dtype == torch.float32 and not cuda_cores:
        t_ops = 3 * flops / PEAK_TF32_FLOPS
    else:
        t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _bound_text(kind: str, b: int, t: int, h: int, d: int, dtype) -> str:
    """The bound of ``_attention_bound`` with what it counts; in f32
    beside the CUDA cores' bound of the kernels that 3xTF32 replaced."""
    bound_ms, bound_by = _attention_bound(kind, b, t, h, d, dtype)
    if dtype != torch.float32:
        return f"{bound_ms:.4f} ms ({bound_by})"
    cc_ms, cc_by = _attention_bound(kind, b, t, h, d, dtype, cuda_cores=True)
    return (f"{bound_ms:.4f} ms ({bound_by}, 3xTF32 at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; "
            f"on the CUDA cores {cc_ms:.4f} ms, {cc_by})")


# Idle seconds on each side of a profiled call, inside the profiler's window.
# The profiler keeps only the device records that fall inside its window on
# the host's clock, and places them there through a device-to-host clock
# conversion that is off by up to a few ms in either direction from one trace
# to the next (kernels then seem to start before their launch): with no idle
# margin the kernels at either edge of the window are dropped from the trace.
PROFILE_MARGIN_S = 0.05
# ``_profile``'s traces of one call, in turn, until one holds a kernel
# record for each launch call of the call: (idle margin in s, calls of
# ``fn`` before it in the same trace, whether the caching allocator returns
# its free blocks to the card before the trace).  A trace on an H100 loses
# the kernel records of its first launches, none early in a run of this
# script and 1-44 late in it, whatever the margin (0.05, 0.25 and 1 s
# alike); in the classifier-guided call two of them were the repo's
# kernels.  A first call of ``fn`` in the same trace takes that loss, and
# its records are left out.  A count that a wrapper gets wrong is wrong in
# every trace.
PROFILE_TRACES = ((0.25, 1, False), (0.25, 2, False), (0.25, 2, True))
# Host-side launch calls, each of which the trace pairs with its kernel's
# record by their correlation id
LAUNCH_CALLS = re.compile(r"^(cudaLaunchKernel|cudaLaunchCooperativeKernel|cuLaunchKernel)")
# The repo's own kernels by name: each wrapper launch runs one of them, K3
# one (its cluster slab) or two (its streamed pass), as its route says
OUR_KERNELS = re.compile(r"flash_(fwd|bwd)_\w*kernel|gn_(slab|stream_stats|stream_apply)_kernel"
                         r"|conv3x3_(f32|bf16)_wgmma_kernel|conv3x3_split_w_kernel")


def _trace(fn, margin_s: float = PROFILE_MARGIN_S, primers: int = 0,
           free_cache: bool = False):
    """One call of ``fn`` under ``torch.profiler``, with ``margin_s`` of idle
    device time on each side, after ``primers`` calls of ``fn`` in the same
    trace whose device records are left out (``free_cache``: after
    ``torch.cuda.empty_cache()``, before the trace).  Returns its Chrome-trace
    events, CUDA-event ms, host s, the launch-to-start gap in us (the
    smallest device start less its host launch over the kernels; negative:
    the clocks disagree), lost (the ms after the call's first launch call of
    each of its launch calls that has no kernel record in the trace),
    primer_lost (the primers' launch calls with no kernel record), and the
    call's launches by wrapper (``_counts``) and K3 kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = _events()
    torch.cuda.synchronize()
    if free_cache:
        torch.cuda.empty_cache()
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(primers):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
        before, gn_before = _counts(), G.groupnorm_silu.kernels
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launched = {name: n - before[name] for name, n in _counts().items()}
        gn_kernels = G.groupnorm_silu.kernels - gn_before
        time.sleep(margin_s)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]

    def corr(e):
        return e.get("args", {}).get("correlation")

    runtime = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")),
                     key=lambda e: float(e["ts"]))
    recorded = {corr(e) for e in events if e.get("cat") == "kernel"}
    primer_lost = 0
    last = max((i for i, e in enumerate(runtime) if LAUNCH_CALLS.match(e["name"])), default=0)
    if primers and last > 0:
        # the primers' host calls end at the widest idle stretch between two
        # host calls before the call's last launch: the margin before the call
        ends = np.maximum.accumulate([float(e["ts"]) + float(e.get("dur", 0))
                                      for e in runtime[:last]])
        starts = np.array([float(e["ts"]) for e in runtime[1:last + 1]])
        cut = 1 + int(np.argmax(starts - ends))
        primed, runtime = runtime[:cut], runtime[cut:]
        primer_lost = sum(1 for e in primed
                          if LAUNCH_CALLS.match(e["name"]) and corr(e) not in recorded)
        left_out = {corr(e) for e in primed}
        events = [e for e in events if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset")
                  or corr(e) is None or corr(e) not in left_out]
    launch_ts = {corr(e): float(e["ts"]) for e in runtime if corr(e) is not None}
    gaps = [float(e["ts"]) - launch_ts[corr(e)] for e in events
            if e.get("cat") == "kernel" and corr(e) in launch_ts]
    calls = [e for e in runtime if LAUNCH_CALLS.match(e["name"])]
    first = float(calls[0]["ts"]) if calls else 0.0
    lost = [(float(e["ts"]) - first) / 1e3 for e in calls if corr(e) not in recorded]
    return types.SimpleNamespace(
        events=events, cuda_ms=start.elapsed_time(end), host_s=host_s,
        gap_us=min(gaps, default=float("nan")), lost=lost, primer_lost=primer_lost,
        launched=launched, gn_kernels=gn_kernels)


def _kernel_names(fn) -> list:
    """The device kernels of one call of ``fn``, by name (torch.profiler)."""
    fn()
    events = _trace(fn).events
    return sorted({e["name"] for e in events if e.get("cat") == "kernel"})


def _groupnorm_bound(n: int, h: int, w: int, c: int, dtype, silu: bool) -> tuple:
    """(bound_ms, bound_by) of one K3 call: x read once and out written once
    (scale and bias, 8c bytes), against its f32 operations on the CUDA cores
    (per element: 3 for the statistics, 2 for x * a + b, 4 for SiLU)."""
    elems = n * h * w * c
    nbytes = 2 * elems * torch.empty((), dtype=dtype).element_size() + 8 * c
    flops = elems * (5 + (4 if silu else 0))
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _library_fwd(q, k, v, scale):
    """``F.scaled_dot_product_attention`` on contiguous [B, H, T, d] copies
    of q, k, v, made here, outside the timing."""
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)


def _library_bwd(q, k, v, do, scale):
    """The backward of ``F.scaled_dot_product_attention`` (dq, dk and dv in
    one call) on contiguous copies, its forward run here, outside the
    timing."""
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    g = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)


def phase_environment() -> str:
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0] if smi else "nvidia-smi printed nothing"
    print(smi)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"python {sys.version.split()[0]}")
    print(f"[env] nvcc: {_run([_build.find_nvcc(), '--version']).splitlines()[-1]}")
    try:
        import triton
        print(f"[env] triton {triton.__version__} imports")
    except ImportError as e:
        print(f"[env] triton does not import: {e}")
    return smi


_LOAD_NAMES = {"1": "cp.async", "2": "gather", "3": "gather from the qkv rows"}


def _sass_hmma_counts(path: str) -> dict:
    """{mangled kernel name: (tensor-core instructions, their opcodes)} of a
    built library's SASS (``cuobjdump -sass``, from the toolkit beside nvcc):
    mma.sync shows as HMMA (TF32: HMMA.1688.F32.TF32), wgmma as HGMMA
    (HGMMA.64x128x16.F32.BF16)."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          timeout=300)
    _check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr[-2000:]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = (0, set())
        elif fn is not None and re.search(r"\bH(G)?MMA\b", line):
            n, kinds = counts[fn]
            counts[fn] = (n + 1, kinds | {re.search(r"HG?MMA\S*", line).group(0)})
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    if _build.build_seconds is None:
        print(f"[build] kernel library already built, loaded in "
              f"{time.perf_counter() - t0:.3f} s")
    else:
        print(f"[build] K1, K1c, K2, K2c, K3 and K4 built with nvcc in "
              f"{_build.build_seconds:.2f} s, one process per source "
              f"({' '.join(_build.NVCC_FLAGS)})")
    # ptxas names each kernel by its mangled name: print it as
    # flash_<...>_kernel<dtype, d, ...>, gn_<...>_kernel or conv3x3_<...>, then
    # its registers and spills; hold every K1 / K1c instantiation on the
    # tensor cores (flash_fwd_tc_kernel<padded d, load mode> in bf16,
    # flash_fwd_tf32[_flat]_kernel<padded d, load mode> in f32) and every K2 /
    # K2c one (flash_bwd_{dq,dkv}_bf16_kernel<padded d, load mode> in bf16,
    # flash_bwd_{dq,dkv}_tf32[_flat]_kernel<padded d, load mode> in f32) to 0
    # spill bytes and some HMMA in its SASS (K2 in bf16: HMMA.16816.F32.BF16;
    # f32: HMMA.1688.F32.TF32), and each K4 one to HGMMA (wgmma)
    log = _build.build_log or _build.library_path().with_suffix(".log").read_text()
    fwd_re = re.compile(r"(flash_fwd_tc_kernel|flash_fwd_tf32_kernel|flash_fwd_tf32_flat_kernel)"
                        r"ILi(\d+)ELi(\d)EE")
    bwd_re = re.compile(r"(flash_bwd_(?:dq|dkv)_(?:tf32|bf16)(?:_flat)?_kernel)ILi(\d+)ELi(\d)EE")
    tc, bwd, convs, current = {}, {}, {}, None
    for line in log.splitlines():
        compiling = "Compiling entry function" in line
        fwd = fwd_re.search(line)
        bk = bwd_re.search(line)
        gn = re.search(r"(gn_[a-z_]+_kernel)(I(13__nv_bfloat16|f)((?:Li\d+E)*)E)?", line)
        conv = re.search(r"(conv3x3_(?:bf16|f32)_wgmma_kernel)ILb([01])E", line)
        if compiling:
            current = None
        if fwd and compiling:
            current = (fwd.group(1), int(fwd.group(2)), _LOAD_NAMES[fwd.group(3)])
            tc[current] = {}
            print(f"[build] {_fwd_name(current)}:")
        elif bk and compiling:
            current = (bk.group(1), int(bk.group(2)), _LOAD_NAMES[bk.group(3)])
            bwd[current] = {}
            print(f"[build] {_bwd_name(current)}:")
        elif gn and compiling:
            dtype = "bf16" if gn.group(3) == "13__nv_bfloat16" else "f32"
            vec = re.findall(r"Li(\d+)E", gn.group(4) or "")
            print(f"[build] {gn.group(1)}<{dtype}{', vec=' + vec[0] if vec else ''}>:")
        elif conv and compiling:
            current = (conv.group(1), "fused" if conv.group(2) == "1" else "plain")
            convs[current] = {}
            print(f"[build] {current[0]}<{current[1]}>:")
        elif current in convs and re.search(r"C75\d\d|serializ|inject", line):
            print(f"[build]   {line.strip()}")
        elif "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            table = bwd if current in bwd else convs if current in convs else tc
            if spill and current is not None:
                table[current]["spill"] = int(spill.group(1)) + int(spill.group(2))
            if regs and current is not None:
                table[current]["registers"] = int(regs.group(1))
    # bf16: 8 padded dims in cp.async and the element gather, 4 in the qkv-row
    # gather; f32: 8 in cp.async and the gather, 2 in the qkv-row gather, and
    # the flat entry's 8 in cp.async and the gather
    count = {name: sum(1 for key in tc if key[0] == name) for name in
             ("flash_fwd_tc_kernel", "flash_fwd_tf32_kernel", "flash_fwd_tf32_flat_kernel")}
    _check(count == {"flash_fwd_tc_kernel": 20, "flash_fwd_tf32_kernel": 18,
                     "flash_fwd_tf32_flat_kernel": 16},
           f"expected 20 bf16, 18 f32 and 16 flat f32 tensor-core K1 instantiations, ptxas "
           f"compiled {count}")
    hmma, kinds, bwd_kinds = {}, set(), {}
    sass = _sass_hmma_counts(str(_build.library_path()))
    for name, (n, kind) in sass.items():
        m = fwd_re.search(name)
        bk = bwd_re.search(name)
        if m:
            hmma[(m.group(1), int(m.group(2)), _LOAD_NAMES[m.group(3)])] = n
            if "tf32" in m.group(1):
                kinds |= kind
        elif bk:
            key = (bk.group(1), int(bk.group(2)), _LOAD_NAMES[bk.group(3)])
            hmma[key], bwd_kinds[key] = n, kind
    for key in sorted(tc):
        print(f"[build] {_fwd_name(key)}: {hmma.get(key, 0)} HMMA instructions in its SASS, "
              f"{tc[key].get('spill', 'unknown')} spill bytes")
        _check(hmma.get(key, 0) > 0, f"K1 {key} has no tensor-core instruction")
        _check(tc[key].get("spill") == 0, f"K1 {key} spills registers")
    print(f"[build] the f32 kernels' tensor-core instructions: {', '.join(sorted(kinds))}")
    # f32 K2 / K2c: 8 padded dims x the dQ and dK/dV kernels x both layouts
    # in the element gather, 7 (all but 256) in cp.async; bf16 K2 / K2c (the
    # flat layout as one head): 8 padded dims x both kernels x cp.async and
    # the element gather, 4 x both in the qkv-row gather
    count = {dtype: sum(1 for key in bwd if dtype in key[0]) for dtype in ("tf32", "bf16")}
    _check(count == {"tf32": 60, "bf16": 40}, f"expected 60 f32 and 40 bf16 tensor-core K2 / "
           f"K2c instantiations, ptxas compiled {count}")
    for key in sorted(bwd, key=lambda k: (k[0].split("_")[3], k[1], k[0], k[2])):
        got = bwd[key]
        want = "HMMA.16816.F32.BF16" if "bf16" in key[0] else "HMMA.1688.F32.TF32"
        print(f"[build] {_bwd_name(key)}: {got.get('registers')} registers, "
              f"{got.get('spill', 'unknown')} spill bytes, {hmma.get(key, 0)} HMMA instructions "
              f"in its SASS ({', '.join(sorted(bwd_kinds.get(key, ())))})")
        _check(want in bwd_kinds.get(key, ()), f"K2 {key} has no {want} instruction")
        _check(got.get("spill") == 0, f"K2 {key} spills registers")
    # K4: conv3x3_{bf16,f32}_wgmma_kernel<plain> and <fused> on wgmma
    # (HGMMA.64x128x16.F32.BF16, HGMMA.64x64x8.F32.TF32), no spills; ptxas
    # reports the launch's 168 registers a thread, which setmaxnreg splits
    # into 56 (warpgroup 0) and 224 (the two consumer warpgroups)
    conv_kinds = {}
    for name, (n, kind) in sass.items():
        m = re.search(r"(conv3x3_(?:bf16|f32)_wgmma_kernel)ILb([01])E", name)
        if m:
            conv_kinds[(m.group(1), "fused" if m.group(2) == "1" else "plain")] = (n, kind)
    for dtype, want in (("bf16", "BF16"), ("f32", "TF32")):
        keys = sorted(key for key in convs if dtype in key[0])
        _check(len(keys) == 2, f"expected 2 {dtype} K4 instantiations, ptxas compiled {keys}")
        for key in keys:
            n, kind = conv_kinds.get(key, (0, set()))
            print(f"[build] {key[0]}<{key[1]}>: {convs[key].get('registers')} registers, "
                  f"{convs[key].get('spill', 'unknown')} spill bytes, {n} HGMMA instructions in "
                  f"its SASS ({', '.join(sorted(kind))})")
            _check(any(re.fullmatch(rf"HGMMA\.\S*{want}", k) for k in kind),
                   f"K4 {key} has no HGMMA.*{want} instruction")
            _check(convs[key].get("spill") == 0, f"K4 {key} spills registers")


def _bwd_name(key) -> str:
    """flash_bwd_dq_tf32_kernel<f32, padded d=64, cp.async> and the like."""
    name, dp, load = key
    return f"{name}<{'bf16' if 'bf16' in name else 'f32'}, padded d={dp}, {load}>"


def _fwd_name(key) -> str:
    """flash_fwd_tc_kernel<bf16, padded d=64, cp.async> and the like."""
    name, dp, load = key
    return f"{name}<{'bf16' if name == 'flash_fwd_tc_kernel' else 'f32'}, padded d={dp}, {load}>"


def _qkv_views(b, t, h, d, dtype, g):
    """q, k, v as attention() takes them: strided views of one [B, T, 3*H*d]
    projection whose channels factor as (head, c, qkv)."""
    qkv = torch.randn(b, t, h * d * 3, generator=g, device="cuda").to(dtype)
    return qkv.reshape(b, t, h, d, 3).unbind(-1)


def _legacy_views(b, t, h, d, dtype, g):
    """q, k, v as ``models.adm.legacy_attention`` hands them to sdpa:
    strided views of one [B, T, H, 3d] projection (head stride 3d, token
    stride 3Hd)."""
    parts = torch.randn(b, t, h, 3 * d, generator=g, device="cuda").to(dtype)
    return parts[..., :d], parts[..., d:2 * d], parts[..., 2 * d:]


def _k1_checks(tag: str, shapes, views, seed: int, reps: int, warmup: int) -> dict:
    """K1 against its plain version at ``shapes`` on ``views``, two runs
    bit-identical; prints the errors, times and route (``A.fwd_route``) of
    each shape and the kernels-line fields of the first bf16 and the first
    f32 shape (the path's main ones); returns those fields by dtype name,
    and the first shape's as "main"."""
    g = torch.Generator("cuda").manual_seed(seed)
    mains = {}
    for b, t, h, d, dtype in shapes:
        q, k, v = views(b, t, h, d, dtype, g)
        scale = d ** -0.5
        route = A.fwd_route(q, k, v)
        out, lse = A.flash_attention_mh(q, k, v, scale)
        again = A.flash_attention_mh(q, k, v, scale)
        ref_out, ref_lse = A.reference_sdpa(q, k, v, scale)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        tol = _out_tol(dtype, ref_out)
        del out, lse, again, ref_out, ref_lse
        fns = {"kernel": lambda: A.flash_attention_mh(q, k, v, scale),
               "plain": lambda: A.reference_sdpa(q, k, v, scale),
               "library": _library_fwd(q, k, v, scale)}
        if route.load == "gather":  # the same data in views that take cp.async
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            fns["contiguous"] = lambda: A.flash_attention_mh(qc, kc, vc, scale)
        times = _turns(fns, reps=reps, warmup=warmup)
        bound_ms, bound_by = _attention_bound("fwd", b, t, h, d, dtype)
        if "contiguous" in times:
            print(f"[{tag}]   K1 on contiguous copies of the same data (cp.async): "
                  f"{times['contiguous']:.4f} ms, the views' gather {times['kernel']:.4f} ms")
        name = str(dtype).replace("torch.", "")
        print(f"[{tag}] B={b} T={t} H={h} d={d} {name}: out err {err_out:.3g} (tol "
              f"{tol:.3g}), lse err {err_lse:.3g} (tol {LSE_TOL:.3g}), two runs bit-identical: "
              f"{same}; K1 {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
              f"F.scaled_dot_product_attention {times['library']:.4f} ms, bound "
              f"{_bound_text('fwd', b, t, h, d, dtype)}; "
              f"{2 * 2 * b * h * t * t * d / times['kernel'] / 1e9:.2f} TFLOP/s; route "
              f"{route.kernel}, padded d {route.padded_d}, {route.load}"
              f"{' from the qkv rows' if route.span else ''}, {route.block_q} x "
              f"{route.block_k} tiles, {route.warps} warps")
        _check(err_out <= tol and err_lse <= LSE_TOL,
               f"K1 disagrees with the plain version at {(b, t, h, d, name)}")
        _check(same, f"K1 is not deterministic at {(b, t, h, d, name)}")
        fields = dict(max_abs_err=err_out, ms=times["kernel"], plain_ms=times["plain"],
                      library_ms=times["library"], bound_ms=bound_ms, bound_by=bound_by)
        if not mains:  # the first shape is the path's main one
            mains["main"] = fields
        if name not in mains:  # and the first of each dtype that dtype's
            mains[name] = fields
            print(f"[{tag}] {name} main shape [{b}, {t}, {h}, {d}]: {json.dumps(fields)}")
            if dtype == torch.float32:
                print(f"[{tag}]   F.scaled_dot_product_attention in f32 runs "
                      f"{_kernel_names(fns['library'])}")
    torch.cuda.empty_cache()
    return mains


def _strided_do(b, t, h, d, dtype, g):
    """A non-contiguous dO: the [B, T, H, d] transpose of a [B, H, T, d]."""
    return torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype).transpose(1, 2)


def _k2_checks(tag: str, shapes, views, seed: int) -> dict:
    """K2 against its plain version at ``shapes`` on ``views`` with a
    non-contiguous dO, two runs bit-identical; returns the kernels-line
    fields of the dQ and dK/dV kernels at the first shape ("main") and at the
    first shape of each dtype (by its name), each kernel's with the launches
    that the checks of its dtype made here."""
    g = torch.Generator("cuda").manual_seed(seed)
    mains, launches = {}, {}
    for b, t, h, d, dtype in shapes:
        before = (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches)
        q, k, v = views(b, t, h, d, dtype, g)
        do = _strided_do(b, t, h, d, dtype, g)
        scale = d ** -0.5
        out, lse = A.flash_attention_mh(q, k, v, scale)
        grads = A.flash_attention_mh_bwd(q, k, v, out, lse, do, scale)
        again = A.flash_attention_mh_bwd(q, k, v, out, lse, do, scale)
        ref = A.reference_sdpa_bwd(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        errs = [(x.float() - y.float()).abs().max().item() for x, y in zip(grads, ref)]
        tols = [K2_TOL[dtype] * y.float().abs().max().item() for y in ref]
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        del grads, again, ref
        delta = torch.einsum("bthd,bthd->bht", do.float(), out.float()).contiguous()
        times = _backward_times(q, k, v, out, lse, do, do.to(dtype), delta, scale)
        name = str(dtype).replace("torch.", "")
        route = A.bwd_route(q, k, v, do)
        print(f"[{tag}] B={b} T={t} H={h} d={d} {name}: max abs err dq {errs[0]:.3g} (tol "
              f"{tols[0]:.3g}), dk {errs[1]:.3g} (tol {tols[1]:.3g}), dv {errs[2]:.3g} (tol "
              f"{tols[2]:.3g}); two runs bit-identical: {same}; {_fmt_times(times)}")
        print(f"[{tag}]   {_bwd_route_text(route, times, b, t, h, d, dtype)}")
        if route.load != "cp_async":  # the same data in views that take cp.async
            qc, kc, vc, dc = (x.contiguous() for x in (q, k, v, do))
            got = _turns({"dq": lambda: A.flash_attention_bwd_dq(qc, kc, vc, dc, lse, delta,
                                                                 scale),
                          "dkv": lambda: A.flash_attention_bwd_dkv(qc, kc, vc, dc, lse, delta,
                                                                   scale)}, reps=5)
            print(f"[{tag}]   K2 on contiguous copies of the same data (cp.async): dQ "
                  f"{got['dq']:.4f} ms, dK/dV {got['dkv']:.4f} ms; the views' {route.load}: dQ "
                  f"{times['dq'][0]:.4f}, dK/dV {times['dkv'][0]:.4f}")
            del qc, kc, vc, dc
        _check(all(e <= tol for e, tol in zip(errs, tols)),
               f"K2 disagrees with the plain version at {(b, t, h, d, name)}")
        _check(same, f"K2 is not deterministic at {(b, t, h, d, name)}")
        here = (A.flash_attention_bwd_dq.launches - before[0],
                A.flash_attention_bwd_dkv.launches - before[1])
        print(f"[{tag}]   launches of this shape's checks and timings: dQ {here[0]}, dK/dV "
              f"{here[1]}")
        n = launches.setdefault(name, [0, 0])
        n[0] += here[0]
        n[1] += here[1]
        fields = _backward_main(errs, times, b, t, h, d, dtype)
        if not mains:  # the first shape is the path's main one
            mains["main"] = fields
        if name not in mains:  # and the first of each dtype that dtype's
            mains[name] = fields
    for name, (dq, dkv) in launches.items():
        mains[name]["dq"]["launches"], mains[name]["dkv"]["launches"] = dq, dkv
    torch.cuda.empty_cache()
    return mains


def phase_kernel() -> dict:
    return _k1_checks("K1", K1_SHAPES, _qkv_views, seed=0, reps=20, warmup=3)


@torch.no_grad()
def _redraw_unit_scale(module, seed: int, device: str = "cpu") -> None:
    """Replace every parameter by a seeded draw of unit scale (weights over
    sqrt(fan_in)), drawn on ``device``: a random-init EDM net outputs ~1e-5
    through its zero-init convs, which would hide the attention from D(x,
    sigma)."""
    g = torch.Generator(device).manual_seed(seed)
    for p in module.parameters():
        fan_in = p[0].numel() if p.dim() > 1 else 1
        p.copy_(torch.randn(p.shape, generator=g, device=device) / math.sqrt(fan_in))


def _cifar_f32():
    """The full-width f32 CIFAR-10 EDMPrecond with unit-scale weights, frozen,
    TF32 off; x at sigma 80, 10, 1, 0.1 in turn, those sigmas, a cotangent."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    module, _ = create_model("cifar10", "random", device="cuda")
    _redraw_unit_scale(module, seed=1)
    module.requires_grad_(False)
    sigma = torch.tensor([80.0, 10.0, 1.0, 0.1] * 2, device="cuda")
    x = stacked_randn(range(8), (32, 32, 3), device="cuda") * sigma[:, None, None, None]
    cot = stacked_randn(range(100, 108), (32, 32, 3), device="cuda")
    print(f"[CIFAR-10 f32] full-width EDMPrecond, batch 8, sigma {sigma.tolist()}, "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return module, x, sigma, cot


def phase_denoiser_f32() -> None:
    module, x, sigma, _ = _cifar_f32()
    den = bind(module)
    _plain_vs_kernels("D f32", _plain_net_patches(layers), forward=lambda: den(x, sigma),
                      per_forward=dict(k1=ATTENTION_SITES, gn=CIFAR_GN_SITES))
    _profile("D f32 profile, one forward at batch 8", lambda: den(x, sigma),
             {"K1": ATTENTION_SITES, "K3": CIFAR_GN_SITES})


_COUNTED = {"k1": A.flash_attention_mh, "dq": A.flash_attention_bwd_dq,
            "dkv": A.flash_attention_bwd_dkv, "gn": G.groupnorm_silu,
            "k1c": A.flash_attention, "dqc": A.flash_attention_flat_bwd_dq,
            "dkvc": A.flash_attention_flat_bwd_dkv, "k4": C.conv3x3, "k4s": C.split_w}


def _reset_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
    A.flash_attention_bwd_dq.launches_by_shape = {}
    A.flash_attention_bwd_dkv.launches_by_shape = {}


def _counts() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _only(**launches) -> dict:
    """The counts of a run that launched these kernels and no other."""
    return {**dict.fromkeys(_COUNTED, 0), **launches}


def _per_calls(per_call: dict, calls: int) -> dict:
    """The counts of ``calls`` net forwards, each launching ``per_call``."""
    return {name: n * calls for name, n in per_call.items()}


def _drive_sampling(tag: str, den, shape, per_call: dict, label_dim: int = 0,
                    batch: int = BATCH, nfe_steps=NFE_STEPS, schedule=("polynomial", 7.0),
                    **gen_kw):
    """A sampling path as ``generate`` runs it: after a warm-up call (cuDNN
    plans and the allocator stay out of the timing), ``batch`` seeds at
    batch ``batch`` with ipndm on ``schedule`` at each NFE, with the counts
    set to 0 just before.  Checks finite samples, exactly ``per_call``
    launches per net call and no other kernel, and seeds 0-7 at batch 8
    against the full batch's rows.  Returns (the first NFE's samples, the
    counts, its device seconds)."""
    seeds = list(range(batch))
    kw = dict(max_batch_size=batch, device="cuda", label_dim=label_dim, **gen_kw)
    sched = dict(schedule_type=schedule[0], schedule_rho=schedule[1])
    first_steps = nfe_steps[0][1]
    generate(den, seeds, shape, SolverConfig(solver="ipndm", num_steps=first_steps, **sched),
             **kw)
    torch.cuda.synchronize()

    _reset_counts()
    calls = 0
    samples, seconds = {}, {}
    for nfe, steps in nfe_steps:
        cfg = SolverConfig(solver="ipndm", num_steps=steps, **sched)
        _check(cfg.nfe() == nfe, f"ipndm at {steps} steps is NFE {cfg.nfe()}")
        start, end = _events()
        t0 = time.perf_counter()
        start.record()
        samples[nfe] = generate(den, seeds, shape, cfg, **kw)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        seconds[nfe] = start.elapsed_time(end) / 1000
        calls += nfe * math.ceil(len(seeds) / batch)
        print(f"[{tag}] ipndm NFE {nfe}, batch {batch}, bf16, {schedule[0]} schedule"
              f"{', per-seed labels' if label_dim else ''}: {batch / seconds[nfe]:.2f} "
              f"samples/s (CUDA events, {seconds[nfe]:.4f} s; host clock {host_s:.4f} s); "
              f"launches so far {_counts()}, expected {_per_calls(per_call, calls)}")
    counts = _counts()
    _check(counts == _only(**_per_calls(per_call, calls)),
           f"{tag}: launches {counts}, expected {_per_calls(per_call, calls)} and no other")
    for nfe, x in samples.items():
        _check(x.shape == (batch, *shape) and np.isfinite(x).all(),
               f"{tag}: NFE {nfe} output is not finite or has shape {x.shape}")

    nfe0 = nfe_steps[0][0]
    few = generate(den, seeds[:8], shape,
                   SolverConfig(solver="ipndm", num_steps=first_steps, **sched),
                   **dict(kw, max_batch_size=8))
    err = np.abs(few - samples[nfe0][:8]).max()
    bound = 1e-2 * np.abs(samples[nfe0][:8]).max()
    print(f"[{tag}] seeds 0-7 at batch 8 vs batch {batch}, NFE {nfe0}: max abs diff {err:.3g} "
          f"(tol 1e-2 * max|x| = {bound:.3g}; cuDNN may pick other bf16 conv algorithms)")
    _check(err <= bound, f"{tag}: per-seed rows depend on the batch")
    return samples[nfe0], counts, seconds[nfe0]


def _check_cli_pngs(tag: str, argv: list, images: np.ndarray, batch: int = BATCH) -> None:
    """The sampling CLI as a user runs it, on the seeds, weights and config of
    ``images`` (seeds 0 to batch - 1): its PNGs must be byte for byte their
    encoding."""
    with tempfile.TemporaryDirectory() as outdir:
        cli_sample.main([*argv, f"--seeds=0-{batch - 1}", f"--batch={batch}", "--device=cuda",
                         f"--outdir={outdir}"])
        want = to_uint8(images)
        same = 0
        for seed in range(batch):
            with open(os.path.join(outdir, f"{seed - seed % 1000:06d}", f"{seed:06d}.png"),
                      "rb") as f:
                same += f.read() == encode_png(want[seed])
    print(f"[{tag}] CLI wrote {same} of {batch} PNGs identical to the first NFE's images")
    _check(same == batch, f"{tag}: CLI PNGs differ from generate's images")


def phase_main_path() -> int:
    module, _ = create_model("cifar10", "random", dtype=torch.bfloat16, device="cuda")
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    images, counts, _ = _drive_sampling("main", bind(module), shape,
                                        dict(k1=ATTENTION_SITES, gn=CIFAR_GN_SITES))
    _check_cli_pngs("main", ["--dataset_name=cifar10", "--model_path=random", "--solver=ipndm",
                             "--num_steps=6", "--bf16=True"], images)
    sigma = torch.full((BATCH,), 2.5, device="cuda")
    x = stacked_randn(range(BATCH), shape, device="cuda") * 2.5
    tag = f"CIFAR-10 profile, one batch-{BATCH} bf16 forward"
    _profile(tag, lambda: module(x, sigma), {"K1": ATTENTION_SITES, "K3": CIFAR_GN_SITES})
    _with_plain_groupnorm(tag, lambda: module(x, sigma), [layers])
    return counts["k1"], counts["gn"]


def phase_backward_kernel() -> dict:
    return _k2_checks("K2", K2_SHAPES, _qkv_views, seed=2)


def _backward_times(q, k, v, out, lse, do, do_c, delta, scale) -> dict:
    """ms of the dQ and dK/dV kernels and of the whole backward (delta
    included), each beside its plain version, and of the library backward."""
    times = {}
    for name, kernel, plain in (
            ("dq", lambda: A.flash_attention_bwd_dq(q, k, v, do_c, lse, delta, scale),
             lambda: A.reference_sdpa_bwd_dq(q, k, v, do_c, lse, delta, scale)),
            ("dkv", lambda: A.flash_attention_bwd_dkv(q, k, v, do_c, lse, delta, scale),
             lambda: A.reference_sdpa_bwd_dkv(q, k, v, do_c, lse, delta, scale)),
            ("bwd", lambda: A.flash_attention_mh_bwd(q, k, v, out, lse, do, scale),
             lambda: A.reference_sdpa_bwd(q, k, v, out, lse, do, scale))):
        got = _turns({"kernel": kernel, "plain": plain}, reps=5)
        times[name] = (got["kernel"], got["plain"])
    times["library"] = _turns({"library": _library_bwd(q, k, v, do, scale)}, reps=5)["library"]
    return times


def _bwd_route_text(route, times, b, t, h, d, dtype) -> str:
    """The route of a backward (``A.bwd_route``), then each kernel's bound
    (``_bound_text``) and its useful TFLOP/s at ``times``."""
    flops = 2 * b * h * t * t * d
    return (f"route {route.kernel}, padded d {route.padded_d}, {route.load}, "
            f"{route.block_rows} rows a block x {route.tile_rows} a tile, {route.warps} warps, "
            f"{route.split_d} a m-tile; bound dQ {_bound_text('dq', b, t, h, d, dtype)}, "
            f"{3 * flops / times['dq'][0] / 1e9:.2f} TFLOP/s; dK/dV "
            f"{_bound_text('dkv', b, t, h, d, dtype)}, "
            f"{4 * flops / times['dkv'][0] / 1e9:.2f} TFLOP/s")


def _fmt_times(times: dict) -> str:
    return (f"kernel vs plain ms: dQ {times['dq'][0]:.4f} vs {times['dq'][1]:.4f}, dK/dV "
            f"{times['dkv'][0]:.4f} vs {times['dkv'][1]:.4f}, whole backward "
            f"{times['bwd'][0]:.4f} vs {times['bwd'][1]:.4f}; backward of "
            f"F.scaled_dot_product_attention {times['library']:.4f} ms")


def _backward_main(errs, times, b, t, h, d, dtype) -> dict:
    """The kernels-line fields of the dQ and dK/dV kernels at one shape; the
    library time is the library's whole backward (dq, dk and dv)."""
    out = {}
    for key, err in (("dq", errs[0]), ("dkv", max(errs[1:]))):
        bound_ms, bound_by = _attention_bound(key, b, t, h, d, dtype)
        out[key] = dict(max_abs_err=err, ms=times[key][0], plain_ms=times[key][1],
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=times["library"])
    return out


def _grads_fn(module, x0, sigma0, cot, *args):
    """d sum(module(x, sigma, *args) * cot) / d(x, sigma)."""
    def grads():
        x, sigma = x0.clone().requires_grad_(), sigma0.clone().requires_grad_()
        (module(x, sigma, *args) * cot).sum().backward()
        return x.grad, sigma.grad

    return grads


def phase_gradient_f32() -> None:
    module, x, sigma, cot = _cifar_f32()
    _plain_vs_kernels("grad f32", _plain_net_patches(layers),
                      grads=_grads_fn(module, x, sigma, cot),
                      per_backward=dict(k1=ATTENTION_SITES, dq=ATTENTION_SITES,
                                        dkv=ATTENTION_SITES, gn=CIFAR_GN_SITES))


def _train_amed(tag: str, argv: list, batch_gpu) -> tuple:
    """``cli.train_amed`` as a user runs it, with torch's default precision
    flags, the counts set to 0 and the peak memory cleared just before.
    Prints its times and peak memory; checks finite losses, the run dir's
    files and that the predictor moved.  Returns (run dir, its config,
    launches)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start, end = _events()
    t0 = time.perf_counter()
    start.record()
    run_dir = cli_train_amed.main(argv)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1000
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    kimg = AMED_ITERS * AMED_BATCH / 1000
    print(f"[{tag}] train_amed: batch {AMED_BATCH}, batch_gpu {batch_gpu}, f32 net, "
          f"{AMED_ITERS} iterations (torch.backends.cudnn.allow_tf32=True): whole CLI call "
          f"{host_s:.3f} s host clock, {device_s:.3f} s CUDA events ({device_s / kimg:.3f} "
          f"s/kimg); per-tick sec/kimg (host clock) "
          f"{[round(tk['sec_per_kimg'], 3) for tk in ticks]}; torch.cuda.max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    losses = [tk["Loss/loss"]["mean"] for tk in ticks]
    _check(len(ticks) == AMED_ITERS and all(math.isfinite(x) for x in losses),
           f"{tag}: losses {losses} are not finite")
    for name in ("predictor_config.json", "stats.jsonl", "predictor.npz"):
        _check(os.path.isfile(os.path.join(run_dir, name)), f"train_amed wrote no {name}")
    # the predictor moved: its saved weights differ from a fresh init's
    cfg = AMEDConfig(**ckpt.load_config(os.path.join(run_dir, "predictor_config.json")))
    fresh = init_params(predictor_from_config(cfg), seed=0)
    saved = ckpt.load_params(os.path.join(run_dir, "predictor.npz"))["params"]
    moved = max(float(np.abs(saved[layer][leaf] - ref).max())
                for layer, leaves in params_to_jax(fresh.state_dict()).items()
                for leaf, ref in leaves.items())
    print(f"[{tag}] losses per tick {losses}; predictor moved by max abs {moved:.4g}")
    _check(moved > 0, f"{tag}: the predictor did not move")
    return run_dir, cfg, counts


def _sample_with_predictor(tag: str, dataset: str, run_dir: str, outdir: str, shape,
                           nfe: int, per_call: dict, batch: int = BATCH, image_shape=None,
                           decode: dict = None) -> None:
    """``cli.sample --predictor`` on ``batch`` seeds (finite batches, a PNG
    per seed, exactly ``per_call`` launches per net call, plus ``decode``
    for a latent tier's decode, and no other kernel), then the AMED sampler
    alone after a warm-up call, for samples/sec."""
    seen = []
    real_to_uint8 = cli_sample.to_uint8
    image_shape = tuple(image_shape or shape)

    def checked_to_uint8(x):
        seen.append(bool(np.isfinite(x).all()) and x.shape[1:] == image_shape)
        return real_to_uint8(x)

    _reset_counts()
    cli_sample.to_uint8 = checked_to_uint8
    t0 = time.perf_counter()
    try:
        cli_sample.main([f"--dataset_name={dataset}", f"--predictor={run_dir}",
                         f"--seeds=0-{batch - 1}", f"--batch={batch}", "--device=cuda",
                         f"--outdir={outdir}"])
    finally:
        cli_sample.to_uint8 = real_to_uint8
    cli_s = time.perf_counter() - t0
    counts = _counts()
    want = _per_calls(per_call, nfe)
    for name, n in (decode or {}).items():
        want[name] = want.get(name, 0) + n
    pngs = glob.glob(os.path.join(outdir, "*", "*.png"))
    print(f"[{tag}] sample --predictor: NFE {nfe}, {len(pngs)} PNGs, finite batches {seen}, "
          f"launches {counts} (expected {want}), whole CLI call {cli_s:.3f} s host clock")
    _check(len(pngs) == batch and seen and all(seen), f"{tag}: samples missing or not finite")
    _check(counts == _only(**want), f"{tag}: launch counts of the sampling")

    module, _ = create_model(dataset, "random", device="cuda")
    fn, _ = cli_sample.build_amed_sample_fn(module, run_dir, "cuda")
    lat = stacked_randn(range(batch), shape, device="cuda")
    fn(lat)
    start, end = _events()
    start.record()
    t0 = time.perf_counter()
    x = fn(lat)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1000
    print(f"[{tag}] AMED sampling, NFE {nfe}, batch {batch}, f32 net: {batch / device_s:.2f} "
          f"samples/s (CUDA events, {device_s:.4f} s; host clock {host_s:.4f} s)")
    _check(torch.isfinite(x).all().item(), f"{tag}: AMED samples are not finite")
    del module, fn
    torch.cuda.empty_cache()


def phase_amed(workdir: str) -> dict:
    argv = ["--dataset_name=cifar10", "--model_path=random", f"--batch={AMED_BATCH}",
            f"--num_steps={AMED_STEPS}", f"--total_kimg={AMED_KIMG}", "--device=cuda",
            f"--outdir={os.path.join(workdir, 'exps')}"]
    run_dir, _, counts = _train_amed("AMED", argv, batch_gpu=None)
    # per iteration and microbatch (one: batch / batch_gpu = 1): the heun
    # teacher makes 2 calls per fine step, M + 1 = 2 fine steps per segment;
    # the amed student 2 calls per segment, the second one differentiated
    segments = AMED_STEPS - 1
    calls = (2 * 2 * segments + 2 * segments) * AMED_ITERS
    want = _only(k1=ATTENTION_SITES * calls, gn=CIFAR_GN_SITES * calls,
                 dq=ATTENTION_SITES * segments * AMED_ITERS,
                 dkv=ATTENTION_SITES * segments * AMED_ITERS)
    print(f"[AMED] launches {counts}, expected {want}")
    _check(counts == want, "launch counts of the AMED training")
    _sample_with_predictor("AMED", "cifar10", run_dir, os.path.join(workdir, "amed_samples"),
                           (32, 32, 3), nfe=2 * segments,
                           per_call=dict(k1=ATTENTION_SITES, gn=CIFAR_GN_SITES))
    return counts


def phase_in64_kernel() -> dict:
    return _k1_checks("IN64 K1", IN64_K1_SHAPES, _qkv_views, seed=3, reps=5, warmup=2)


def phase_in64_backward_kernel() -> dict:
    return _k2_checks("IN64 K2", IN64_K2_SHAPES, _qkv_views, seed=4)


def _in64_inputs(n: int, device="cuda"):
    """x at sigma 80, 10, 1, 0.1 in turn, those sigmas, one-hot labels."""
    sigma = torch.tensor([80.0, 10.0, 1.0, 0.1] * (n // 4), device=device)
    x = stacked_randn(range(n), (64, 64, 3), device=device) * sigma[:, None, None, None]
    labels = F.one_hot(torch.arange(n, device=device) * 97 % 1000, 1000).float()
    return x, sigma, labels


def _plain_vs_kernels(tag: str, plain_patches, forward=None, per_forward: dict = None,
                      grads=None, per_backward: dict = None) -> None:
    """D (``forward``) and d sum(D g) / d(x, sigma) (``grads``), each where
    given, through the kernels against the same with ``plain_patches``
    ((module, name, plain function) set in turn) at 1e-4 * max, and exactly
    ``per_forward`` / ``per_backward`` launches."""
    fns = {"D": forward, "grads": grads}
    fns = {key: fn for key, fn in fns.items() if fn is not None}
    got, counts = {}, {}
    for key, fn in fns.items():
        _reset_counts()
        got[key] = fn()
        counts[key] = _counts()
    real = [(mod, name, getattr(mod, name)) for mod, name, _ in plain_patches]
    try:
        for mod, name, plain in plain_patches:
            setattr(mod, name, plain)
        want = {key: fn() for key, fn in fns.items()}
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    what = " + ".join(name for _, name, _ in plain_patches)
    pairs = []
    if forward is not None:
        pairs.append(("D", got["D"], want["D"]))
    if grads is not None:
        pairs += [("d sum(D * g) / dx", got["grads"][0], want["grads"][0]),
                  ("d sum(D * g) / dsigma", got["grads"][1], want["grads"][1])]
    for name, g, w in pairs:
        err = (g - w).abs().max().item()
        bound = 1e-4 * w.abs().max().item()
        print(f"[{tag}] {name}: max {w.abs().max().item():.4g}, kernels vs plain {what} max abs "
              f"err {err:.3g} (tol 1e-4 * max = {bound:.3g})")
        _check(torch.isfinite(g).all().item(), f"{tag}: {name} is not finite")
        _check(err <= bound, f"{tag}: {name} with the kernels disagrees with the plain versions")
    for key, want_counts in (("D", per_forward), ("grads", per_backward)):
        if key in counts:
            print(f"[{tag}] launches in one {'forward' if key == 'D' else 'forward + backward'}: "
                  f"{counts[key]}")
            _check(counts[key] == _only(**want_counts), f"{tag}: launches {counts[key]}, "
                   f"expected {want_counts} and no other")


def _plain_net_patches(module):
    """The plain attention and the plain GroupNorm in place of K1 + K2 and K3
    in the layers of ``module`` (``models.layers`` or ``models.adm``)."""
    return [(module, "sdpa", _plain_sdpa),
            (module, "groupnorm_silu", G.reference_groupnorm_silu)]


def _plain_sdpa(q, k, v, scale=None):
    return A.reference_sdpa(q, k, v, scale)[0]


def phase_in64_denoiser_and_gradient() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    module, _ = create_model("imagenet64", "random", device="cuda")
    _redraw_unit_scale(module, seed=1)
    module.requires_grad_(False)
    x0, sigma0, labels = _in64_inputs(8)
    cot = stacked_randn(range(100, 108), (64, 64, 3), device="cuda")

    def forward():
        with torch.no_grad():
            return module(x0, sigma0, labels)

    print(f"[IN64 D f32] full-width ImageNet-64 EDMPrecond (DhariwalUNet, "
          f"{sum(p.numel() for p in module.parameters()) / 1e6:.1f}M parameters), batch 8 with "
          f"labels, sigma {sigma0.tolist()}, K1 + K2 + K3 against plain attention and plain "
          f"GroupNorm")
    _plain_vs_kernels("IN64 D f32", _plain_net_patches(layers),
                      forward=forward, per_forward=dict(k1=IN64_SITES, gn=IN64_GN_SITES),
                      grads=_grads_fn(module, x0, sigma0, cot, labels),
                      per_backward=dict(k1=IN64_SITES, dq=IN64_SITES, dkv=IN64_SITES,
                                        gn=IN64_GN_SITES))
    del module
    torch.cuda.empty_cache()


def phase_in64_sampling():
    """Returns (K1 and K3 launches of the path, the bf16 module)."""
    module, _ = create_model("imagenet64", "random", dtype=torch.bfloat16, device="cuda")
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    images, counts, _ = _drive_sampling("IN64 main", bind(module), shape,
                                        dict(k1=IN64_SITES, gn=IN64_GN_SITES),
                                        label_dim=module.label_dim)
    _check_cli_pngs("IN64 main", ["--dataset_name=imagenet64", "--model_path=random",
                                  "--solver=ipndm", "--num_steps=6", "--bf16=True"], images)
    return counts["k1"], counts["gn"], module


def phase_in64_amed(workdir: str) -> dict:
    argv = ["--dataset_name=imagenet64", "--model_path=random", f"--batch={AMED_BATCH}",
            f"--batch_gpu={IN64_BATCH_GPU}", f"--num_steps={AMED_STEPS}",
            f"--total_kimg={AMED_KIMG}", f"--afs={IN64_AMED_AFS}", "--device=cuda",
            f"--outdir={os.path.join(workdir, 'exps')}"]
    run_dir, cfg, counts = _train_amed("IN64 AMED", argv, batch_gpu=IN64_BATCH_GPU)
    want = _amed_counts(dict(k1=IN64_SITES, gn=IN64_GN_SITES), IN64_SITES, IN64_BATCH_GPU,
                        IN64_AMED_AFS)
    print(f"[IN64 AMED] launches {counts}, expected {want}")
    _check(counts == want, "launch counts of the ImageNet-64 AMED training")
    _sample_with_predictor("IN64 AMED", "imagenet64", run_dir,
                           os.path.join(workdir, "in64_amed_samples"), (64, 64, 3),
                           nfe=2 * (AMED_STEPS - 1) - (1 if cfg.afs else 0),
                           per_call=dict(k1=IN64_SITES, gn=IN64_GN_SITES))
    # the f32 gradient that AMED differentiates through, profiled at batch 8:
    # every attention site's backward on the 3xTF32 kernels
    module, _ = create_model("imagenet64", "random", device="cuda")
    module.requires_grad_(False)
    x0, sigma0, labels = _in64_inputs(8)
    cot = stacked_randn(range(100, 108), (64, 64, 3), device="cuda")
    _profile("IN64 AMED profile, one f32 D gradient at batch 8",
             _grads_fn(module, x0, sigma0, cot, labels),
             {"K1": IN64_SITES, "K2 dQ": IN64_SITES, "K2 dK/dV": IN64_SITES}, grad=True)
    del module
    torch.cuda.empty_cache()
    return counts


def _amed_counts(per_call: dict, sites: int, batch_gpu: int, afs: bool) -> dict:
    """The launches of ``AMED_ITERS`` iterations at ``batch_gpu``: per
    microbatch, the heun teacher 2 calls per fine step, M + 1 = 2 fine steps
    per segment; the amed student 2 calls per segment, less the first
    segment's first (AFS), the second one differentiated (one K2 pair per
    attention site)."""
    segments = AMED_STEPS - 1
    micro = AMED_ITERS * AMED_BATCH // batch_gpu
    calls = (2 * 2 * segments + 2 * segments - (1 if afs else 0)) * micro
    return _only(**_per_calls(per_call, calls), dq=sites * segments * micro,
                 dkv=sites * segments * micro)


def _profile(tag: str, fn, want_calls: dict, grad: bool = False) -> dict:
    """``torch.profiler`` over one call of ``fn`` after a warm-up call (under
    ``torch.no_grad`` unless ``grad``): prints the device time by
    ``utils/profiling.py::CATEGORIES`` and checks the kernel calls of
    ``want_calls`` ({category: calls}; for K3 its wrapper's launches, each of
    which runs the CUDA kernels its route names, as the wrapper counts them),
    that no attention forward ran on a CUDA-core kernel (the f32 kernels
    before 3xTF32) and that no attention backward did (``bwd_route`` sends
    every one to the tensor cores: bf16, and f32 in 3xTF32)."""
    with contextlib.nullcontext() if grad else torch.no_grad():
        fn()  # warm-up
        traces = []
        for attempt, (margin, primers, free_cache) in enumerate(PROFILE_TRACES, 1):
            tr = _trace(fn, margin, primers, free_cache)
            # the trace against the wrappers' own counts: K3 runs one or two
            # kernels a launch, as its routes say
            ours = sum(1 for e in tr.events
                       if e.get("cat") == "kernel" and OUR_KERNELS.search(e["name"]))
            want_ours = sum(tr.launched.values()) - tr.launched["gn"] + tr.gn_kernels
            traces.append((ours != want_ours, len(tr.lost), attempt, tr, ours, want_ours))
            if ours == want_ours and not tr.lost:
                break
            print(f"[{tag}] trace {attempt} ({margin} s margins, {primers} primer calls, "
                  f"cache {'freed' if free_cache else 'kept'}): "
                  f"{ours} of the repo's kernels, its wrappers launched {want_ours}; "
                  f"{len(tr.lost)} launch calls of the call have no kernel record, at ms "
                  f"{[round(t, 3) for t in tr.lost[:6]]} after its first; "
                  f"{tr.primer_lost} of the primers' have none")
    # the trace kept: one that holds each of the repo's kernels, if any does,
    # with the fewest launch calls lost
    _, _, attempt, tr, ours, want_ours = min(traces, key=lambda t: t[:3])
    events, launched, gn_kernels = tr.events, tr.launched, tr.gn_kernels
    cuda_ms, host_s, gap_us, lost = tr.cuda_ms, tr.host_s, tr.gap_us, tr.lost
    out = device_breakdown(events)
    cuda_core_fwd = sum(1 for e in events if e.get("cat") == "kernel"
                        and re.search(r"flash_fwd_(flat_)?kernel", e.get("name", "")))
    cuda_core_bwd = sum(1 for e in events if e.get("cat") == "kernel" and re.search(
        r"flash_bwd_d(q|kv)(_flat)?_kernel", e.get("name", "")))
    print(f"[{tag}] under torch.profiler: CUDA events {cuda_ms:.3f} ms, host "
          f"clock {host_s * 1e3:.3f} ms; device time {out['device_ms']:.3f} ms over a span of "
          f"{out['span_ms']:.3f} ms, busy {out['busy_ms']:.3f} ms, idle share "
          f"{out['idle_share']:.4f}")
    for name, c in sorted(out["categories"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"[{tag}]   {name:<16} {c['ms']:>10.3f} ms  {c['share']:.4f}  {c['calls']} calls")
    for name, ms in out["top"][:8]:
        print(f"[{tag}]   top {ms:>10.3f} ms  {name[:140]}")
    print(f"[{tag}]   attention forwards on the CUDA cores: {cuda_core_fwd}, attention "
          f"backwards on the CUDA cores: {cuda_core_bwd}")
    print(f"[{tag}]   the repo's kernels in the trace: {ours}, launched by their wrappers: "
          f"{want_ours} (trace {attempt}); launch calls with no kernel record: {len(lost)}; "
          f"smallest launch-to-start gap {gap_us:.3f} us")
    k3 = out["categories"]["K3"]
    print(f"[{tag}]   K3: {launched['gn']} launches, {gn_kernels} kernels "
          f"({gn_kernels - launched['gn']} on the stream route), {k3['ms']:.3f} ms, share of "
          f"device time {k3['share']:.4f}")
    _check(ours == want_ours, f"{tag}: the trace holds {ours} of the repo's kernels, its "
           f"wrappers launched {want_ours}")
    _check(cuda_core_fwd == 0, f"{tag}: an attention forward ran on the CUDA cores")
    _check(cuda_core_bwd == 0, f"{tag}: an attention backward ran on the CUDA cores, "
           f"which bwd_route does not name")
    for cat, calls in want_calls.items():
        if cat == "K3":
            _check(launched["gn"] == calls, f"{tag}: {launched['gn']} K3 launches, expected "
                   f"{calls}")
            calls = gn_kernels
        _check(out["categories"][cat]["calls"] == calls,
               f"{tag}: the profile holds {out['categories'][cat]['calls']} {cat} kernels, "
               f"expected {calls}")
    return out


def _with_plain_groupnorm(tag: str, fn, modules) -> None:
    """The ms of one call of ``fn`` with K3 and with the plain GroupNorm (the
    ``groupnorm_silu`` of ``modules`` swapped for ``reference_groupnorm_silu``),
    CUDA events, in turns."""
    def plain():
        real = [(m, m.groupnorm_silu) for m in modules]
        for m in modules:
            m.groupnorm_silu = G.reference_groupnorm_silu
        try:
            return fn()
        finally:
            for m, f in real:
                m.groupnorm_silu = f

    with torch.no_grad():
        times = _turns({"K3": fn, "plain": plain}, reps=3, warmup=1)
    print(f"[{tag}] one call with K3 {times['K3']:.3f} ms, with the plain GroupNorm "
          f"{times['plain']:.3f} ms (CUDA events, in turns)")


def phase_in64_profile(module) -> None:
    """torch.profiler over one batch-256 bf16 forward of the sampling net."""
    sigma = torch.full((BATCH,), 2.5, device="cuda")
    x = stacked_randn(range(BATCH), (64, 64, 3), device="cuda") * 2.5
    labels = F.one_hot(torch.arange(BATCH, device="cuda") % 1000, 1000).float()
    tag = f"IN64 profile, one batch-{BATCH} bf16 forward"
    _profile(tag, lambda: module(x, sigma, labels), {"K1": IN64_SITES, "K3": IN64_GN_SITES})
    _with_plain_groupnorm(tag, lambda: module(x, sigma, labels), [layers])


def _gn_route_text(route, dtype, n: int, chunks: int) -> str:
    """A K3 route as phase 15 prints it: kind, cluster (and how many the card
    holds at once), blocks, shared memory a block, CUDA kernels."""
    if route.kind == "slab":
        return (f"slab, clusters of {route.cluster} ({G.active_clusters(route, dtype)} at once), "
                f"{route.cluster * n} blocks of {route.threads} threads, {route.smem} B shared "
                f"memory a block, 1 kernel")
    return (f"stream, {n * chunks} blocks of {route.rows} rows and {route.threads} threads, "
            f"{route.smem} B shared memory a statistics block, 2 kernels")


def _gn_other_route(route, n, h, w, c, dtype):
    """The route that K3 does not take at this shape, where both apply: the
    stream route beside a slab, or the smallest cluster of ``G.CLUSTER_SIZES``
    that holds the slab beside the stream route (None where none does)."""
    elt, hw = torch.empty((), dtype=dtype).element_size(), h * w
    if route.kind == "slab":
        return G._stream_route(n, hw, c, elt, route.vec)
    for size in G.CLUSTER_SIZES:
        if size <= hw:
            slab = G._slab_route(n, hw, c, 32, elt, route.vec, size)
            if slab is not None:
                return slab
    return None


# The GN_SHAPES entries whose numbers the kernels line carries: CIFAR-10's
# main path, the LDM's, ImageNet-64's and the VQ decoder's
GN_ENTRIES = {"CIFAR-10": (BATCH, 32, 32, 256, torch.bfloat16),
              "LSUN LDM": (LDM_BATCH, 64, 64, 224, torch.bfloat16),
              "ImageNet-64": (BATCH, 64, 64, 192, torch.bfloat16),
              "VQ decode": (DECODE_CHUNK, 256, 256, 128, torch.float32)}


def phase_groupnorm_kernel() -> dict:
    return _gn_checks(GN_SHAPES, GN_ENTRIES, seed=7)


def _gn_checks(shapes, wanted: dict, seed: int) -> dict:
    """K3 against its plain version at ``shapes``, on its route and, where
    both apply, on the other one (the same gates, timed on the same data);
    returns the kernels-line fields of ``wanted``'s shapes, with the
    route."""
    g = torch.Generator("cuda").manual_seed(seed)
    entries = {}
    for n, h, w, c, dtype, eps, silu in shapes:
        x = (torch.randn(n, h, w, c, generator=g, device="cuda") * 3 + 1).to(dtype)
        scale = 1 + 0.5 * torch.randn(c, generator=g, device="cuda")
        bias = torch.randn(c, generator=g, device="cuda")
        kw = dict(groups=32, eps=eps, apply_silu=silu)
        route = G.gn_route(n, h, w, c, dtype)
        other = _gn_other_route(route, n, h, w, c, dtype)
        ref = G.reference_groupnorm_silu(x, scale, bias, **kw)
        tol = GN_TOL[dtype] * max(1.0, ref.float().abs().max().item())
        name = str(dtype).replace("torch.", "")
        errs = {}
        for which, r in (("route", route), ("other", other)):
            if r is None:
                continue
            got = G._launch(x, scale, bias, 32, eps, silu, route=r)
            again = G._launch(x, scale, bias, 32, eps, silu, route=r)
            torch.cuda.synchronize()
            errs[which] = (got.float() - ref.float()).abs().max().item()
            same = torch.equal(got, again)
            _check(errs[which] <= tol, f"K3 ({r.kind}) disagrees with the plain version at "
                   f"{(n, h, w, c, name)}: {errs[which]:.3g} > {tol:.3g}")
            _check(same, f"K3 ({r.kind}) is not deterministic at {(n, h, w, c, name)}")
            del got, again
        del ref
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as cuDNN takes it
        sc, bi = scale.to(dtype), bias.to(dtype)

        def library():
            y = F.group_norm(x_nchw, 32, sc, bi, eps)
            return F.silu(y) if silu else y

        fns = {"kernel": lambda: G.groupnorm_silu(x, scale, bias, **kw),
               "plain": lambda: G.reference_groupnorm_silu(x, scale, bias, **kw),
               "library": library}
        if other is not None:
            fns["other"] = lambda: G._launch(x, scale, bias, 32, eps, silu, route=other)
        times = _turns(fns, reps=10, warmup=2)
        bound_ms, bound_by = _groupnorm_bound(n, h, w, c, dtype, silu)
        nbytes = 2 * x.numel() * x.element_size()
        chunks = -(-h * w // route.rows)
        print(f"[K3] [{n}, {h}, {w}, {c}] {name} eps {eps:g} silu {silu} (group size "
              f"{c // 32}): route {_gn_route_text(route, dtype, n, chunks)}; max abs err "
              f"{errs['route']:.3g} (tol {tol:.3g}), two runs bit-identical; K3 "
              f"{times['kernel']:.4f} ms ({nbytes / times['kernel'] / 1e6:.1f} GB/s of x read + "
              f"out written, {bound_ms / times['kernel']:.3f} of the bound), plain "
              f"{times['plain']:.4f} ms, F.group_norm{' + F.silu' if silu else ''} "
              f"{times['library']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if other is not None:
            print(f"[K3]    the other route on the same data: "
                  f"{_gn_route_text(other, dtype, n, -(-h * w // other.rows))}; max abs err "
                  f"{errs['other']:.3g}, two runs bit-identical; {times['other']:.4f} ms "
                  f"({nbytes / times['other'] / 1e6:.1f} GB/s)")
        for label, shape in wanted.items():
            if shape == (n, h, w, c, dtype) and label not in entries:
                entries[label] = dict(
                    max_abs_err=errs["route"], ms=times["kernel"], plain_ms=times["plain"],
                    library_ms=times["library"], bound_ms=bound_ms, bound_by=bound_by,
                    route=route.kind if route.kind == "stream"
                    else f"slab, clusters of {route.cluster}")
        del x, x_nchw
    torch.cuda.empty_cache()
    _check(set(entries) == set(wanted), f"the K3 shapes lack {set(wanted) - set(entries)}")
    return entries


def phase_ldm_attention_kernels() -> tuple:
    """K1 at the LDM's attention shapes and K2 at K2b's and K2p's, on the
    legacy views, and K2 in bf16 at the ADM-G classifier's attention levels
    on the same views; returns the K2 fields at K2b's shape."""
    _k1_checks("LDM K1", LDM_K1_SHAPES, _legacy_views, seed=8, reps=5, warmup=2)
    k2b = _k2_checks("LDM K2", LDM_K2_SHAPES, _legacy_views, seed=9)
    _k2_checks("ADM-G K2", ADMG_K2_SHAPES, _legacy_views, seed=13)
    return k2b


def phase_ldm_denoiser_and_gradient() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pre, _ = create_model(LDM, "random", device="cuda")
    unet = pre.latent_diffusion.unet
    _redraw_unit_scale(unet, seed=1)
    pre.latent_diffusion.requires_grad_(False)
    sigma0 = torch.tensor([pre.sigma_max, 10.0, 1.0, 0.1] * 2, device="cuda")
    x0 = stacked_randn(range(8), LDM_LATENT, device="cuda") * sigma0[:, None, None, None]
    cot = stacked_randn(range(100, 108), LDM_LATENT, device="cuda")

    def forward():
        with torch.no_grad():
            return pre(x0, sigma0)

    print(f"[LDM D f32] full-width LSUN-Bedroom LDM U-Net "
          f"({sum(p.numel() for p in unet.parameters()) / 1e6:.1f}M parameters) under its "
          f"CFGPrecond, batch 8, sigma {[round(s, 4) for s in sigma0.tolist()]}, K1 + K2 + K3 "
          f"against plain attention and plain GroupNorm")
    _plain_vs_kernels("LDM D f32", _plain_net_patches(adm),
                      forward=forward, per_forward=dict(k1=LDM_SITES, gn=LDM_GN_SITES),
                      grads=_grads_fn(pre, x0, sigma0, cot),
                      per_backward=dict(k1=LDM_SITES, dq=LDM_SITES, dkv=LDM_SITES,
                                        gn=LDM_GN_SITES))
    del pre, unet
    torch.cuda.empty_cache()


def phase_ldm_sampling():
    """Returns (K3 launches of the U-Net's sampling and of the VQ decode, the
    bf16 CFGPrecond)."""
    # torch's default precision flags, as a user runs the CLI: the f32 decode
    # takes TF32 convs
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    pre, _ = create_model(LDM, "random", dtype=torch.bfloat16, device="cuda")
    latents, counts, sample_s = _drive_sampling(
        "LDM main", bind(pre), LDM_LATENT, dict(k1=LDM_SITES, gn=LDM_GN_SITES),
        batch=LDM_BATCH, nfe_steps=LDM_NFE_STEPS, schedule=("discrete", 1.0))
    ld = pre.latent_diffusion
    ld.decode_in_chunks(latents[:DECODE_CHUNK])  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    start, end = _events()
    t0 = time.perf_counter()
    start.record()
    images = ld.decode_in_chunks(latents, chunk=DECODE_CHUNK)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    decode_s = start.elapsed_time(end) / 1000
    decode_counts = _counts()
    chunks = LDM_BATCH // DECODE_CHUNK
    print(f"[LDM main] VQ decode of {LDM_BATCH} latents to {LDM_IMAGE[0]}x{LDM_IMAGE[1]}, "
          f"{chunks} chunks of {DECODE_CHUNK}, f32: {decode_s:.4f} s CUDA events (host clock "
          f"{host_s:.4f} s), launches {decode_counts}; images/s at NFE "
          f"{LDM_NFE_STEPS[0][0]}: {LDM_BATCH / sample_s:.2f} without the decode, "
          f"{LDM_BATCH / (sample_s + decode_s):.2f} with it")
    _check(images.shape == (LDM_BATCH, *LDM_IMAGE) and np.isfinite(images).all(),
           f"LDM decode: images not finite or of shape {images.shape}")
    _check(decode_counts == _only(gn=DECODE_GN_SITES * chunks),
           f"LDM decode: launches {decode_counts}")
    _check_cli_pngs("LDM main", [f"--dataset_name={LDM}", "--model_path=random",
                                 "--solver=ipndm", f"--num_steps={LDM_NFE_STEPS[0][1]}",
                                 "--bf16=True"], images, batch=LDM_BATCH)
    return counts["gn"], decode_counts["gn"], pre


def phase_ldm_amed(workdir: str) -> tuple:
    """Returns (the counts of the training, its K2 dQ and dK/dV launches at
    T=1024 H=14, as the wrappers counted them by shape)."""
    argv = [f"--dataset_name={LDM}", "--model_path=random", f"--batch={AMED_BATCH}",
            f"--batch_gpu={LDM_BATCH_GPU}", f"--num_steps={AMED_STEPS}",
            f"--total_kimg={AMED_KIMG}", f"--afs={LDM_AMED_AFS}", "--device=cuda",
            f"--outdir={os.path.join(workdir, 'exps')}"]
    run_dir, cfg, counts = _train_amed("LDM AMED", argv, batch_gpu=LDM_BATCH_GPU)
    by_shape = {"dq": dict(A.flash_attention_bwd_dq.launches_by_shape),
                "dkv": dict(A.flash_attention_bwd_dkv.launches_by_shape)}
    want = _amed_counts(dict(k1=LDM_SITES, gn=LDM_GN_SITES), LDM_SITES, LDM_BATCH_GPU,
                        LDM_AMED_AFS)
    micro = AMED_ITERS * AMED_BATCH // LDM_BATCH_GPU
    want_shapes = {(t, h): n * (AMED_STEPS - 1) * micro
                   for (t, h), n in zip(LDM_LEVELS, (5, 5, 6))}
    print(f"[LDM AMED] launches {counts}, expected {want}; K2 launches by (T, H) {by_shape}, "
          f"expected {want_shapes} for each kernel")
    _check(counts == want, "launch counts of the LDM AMED training")
    _check(by_shape["dq"] == want_shapes and by_shape["dkv"] == want_shapes,
           "K2 launches by shape in the LDM AMED training")
    _sample_with_predictor("LDM AMED", LDM, run_dir, os.path.join(workdir, "ldm_amed_samples"),
                           LDM_LATENT, nfe=2 * (AMED_STEPS - 1) - (1 if cfg.afs else 0),
                           per_call=dict(k1=LDM_SITES, gn=LDM_GN_SITES), batch=LDM_BATCH,
                           image_shape=LDM_IMAGE,
                           decode=dict(gn=DECODE_GN_SITES * (LDM_BATCH // DECODE_CHUNK)))
    return counts, {name: by_shape[name].get((1024, 14), 0) for name in by_shape}


def phase_ldm_profile(pre) -> None:
    """torch.profiler over one batch-64 bf16 U-Net forward (through the
    CFGPrecond) and one batch-16 f32 VQ decode."""
    sigma = torch.full((LDM_BATCH,), 2.5, device="cuda")
    x = stacked_randn(range(LDM_BATCH), LDM_LATENT, device="cuda") * 2.5
    tag = f"LDM profile, one batch-{LDM_BATCH} bf16 U-Net forward"
    _profile(tag, lambda: pre(x, sigma), {"K1": LDM_SITES, "K3": LDM_GN_SITES})
    _with_plain_groupnorm(tag, lambda: pre(x, sigma), [adm])
    z = stacked_randn(range(DECODE_CHUNK), LDM_LATENT, device="cuda")
    tag = f"LDM profile, one batch-{DECODE_CHUNK} f32 VQ decode"
    decode = lambda: pre.latent_diffusion.decode_first_stage(z)  # noqa: E731
    _profile(tag, decode, {"K3": DECODE_GN_SITES})
    _with_plain_groupnorm(tag, decode, [adm])


def _sd_views(b, t, h, d, dtype, g):
    """q, k, v as SD's attention hands them to sdpa: each a contiguous
    [B, T, H, d] reshape of its own projection."""
    return [torch.randn(b, t, h * d, generator=g, device="cuda").to(dtype).reshape(b, t, h, d)
            for _ in range(3)]


def phase_sd_attention_kernels() -> tuple:
    """K1 and K2 at SD's head dims (40 / 80 / 160; the bf16 K1 and K2 pad 40
    to 48); returns the fields of K1 (by dtype, as ``_k1_checks``) and of K2
    at their main shapes."""
    k1 = _k1_checks("SD K1", SD_K1_SHAPES, _sd_views, seed=10, reps=5, warmup=2)
    return k1, _k2_checks("SD K2", SD_K2_SHAPES, _sd_views, seed=11)


def phase_sd_flat_kernels() -> tuple:
    """K1c and K2c against their plain versions at ``SD_FLAT_SHAPES``: K1's
    and K2's gates, K2c two runs bit-identical; CUDA events in turns against
    the plain versions, ``F.scaled_dot_product_attention`` (its backward for
    K2c) and K1 on the same data in the [B, T, H, d] layout.  Returns the
    kernels-line fields of K1c and of K2c at the main shape."""
    g = torch.Generator("cuda").manual_seed(12)
    main = None
    for b, t, d, dtype in SD_FLAT_SHAPES:
        q, k, v, do = (torch.randn(b, t, d, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        scale = d ** -0.5
        route = A.fwd_route(q, k, v)
        out, lse = A.flash_attention(q, k, v, scale)
        again = A.flash_attention(q, k, v, scale)
        ref_out, ref_lse = A.reference_flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        same_fwd = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        tol = _out_tol(dtype, ref_out)
        del ref_out, ref_lse, again
        grads = A.flash_attention_bwd(q, k, v, out, lse, do, scale)
        again = A.flash_attention_bwd(q, k, v, out, lse, do, scale)
        ref = A.reference_flash_attention_bwd(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        errs = [(x.float() - y.float()).abs().max().item() for x, y in zip(grads, ref)]
        tols = [K2_TOL[dtype] * y.float().abs().max().item() for y in ref]
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        del grads, again, ref
        heads = SD_HEADS if b % SD_HEADS == 0 else 1
        mh = [x.reshape(b // heads, heads, t, d).transpose(1, 2) for x in (q, k, v)]
        fwd = _turns({"kernel": lambda: A.flash_attention(q, k, v, scale),
                      "plain": lambda: A.reference_flash_attention(q, k, v, scale),
                      "library": _library_fwd(q[:, :, None], k[:, :, None], v[:, :, None],
                                              scale),
                      "K1": lambda: A.flash_attention_mh(*mh, scale)}, reps=5, warmup=2)
        delta = torch.einsum("btd,btd->bt", do.float(), out.float()).contiguous()
        bwd = _flat_backward_times(q, k, v, out, lse, do, delta, scale)
        bound_ms, bound_by = _attention_bound("fwd", b, t, 1, d, dtype)
        name = str(dtype).replace("torch.", "")
        print(f"[SD K1c/K2c] flat B={b} T={t} d={d} {name}: out err {err_out:.3g} (tol "
              f"{tol:.3g}), lse err {err_lse:.3g} (tol {LSE_TOL:.3g}); dq err {errs[0]:.3g} "
              f"(tol {tols[0]:.3g}), dk {errs[1]:.3g} (tol {tols[1]:.3g}), dv {errs[2]:.3g} "
              f"(tol {tols[2]:.3g}); two runs bit-identical: K1c {same_fwd}, K2c {same}; K1c "
              f"route {route.kernel}, padded d {route.padded_d}, {route.load}, "
              f"{route.block_q} x {route.block_k} tiles, {route.warps} warps")
        print(f"[SD K1c/K2c]   K1c {fwd['kernel']:.4f} ms, plain {fwd['plain']:.4f} ms, "
              f"F.scaled_dot_product_attention {fwd['library']:.4f} ms, K1 on the same data as "
              f"[{b // heads}, {t}, {heads}, {d}] views {fwd['K1']:.4f} ms, bound "
              f"{_bound_text('fwd', b, t, 1, d, dtype)}; "
              f"{2 * 2 * b * t * t * d / fwd['kernel'] / 1e9:.2f} TFLOP/s; K2c {_fmt_times(bwd)}")
        print(f"[SD K1c/K2c]   K2c {_bwd_route_text(A.bwd_route(q, k, v, do), bwd, b, t, 1, d, dtype)}")
        _check(err_out <= tol and err_lse <= LSE_TOL,
               f"K1c disagrees with the plain version at {(b, t, d, name)}")
        _check(same_fwd, f"K1c is not deterministic at {(b, t, d, name)}")
        _check(all(e <= tol for e, tol in zip(errs, tols)),
               f"K2c disagrees with the plain version at {(b, t, d, name)}")
        _check(same, f"K2c is not deterministic at {(b, t, d, name)}")
        if main is None:  # the first shape is the path's main one
            main = (dict(max_abs_err=err_out, ms=fwd["kernel"], plain_ms=fwd["plain"],
                         library_ms=fwd["library"], bound_ms=bound_ms, bound_by=bound_by),
                    _backward_main(errs, bwd, b, t, 1, d, dtype))
        del q, k, v, do, out, lse, mh
        torch.cuda.empty_cache()
    return main


def _flat_backward_times(q, k, v, out, lse, do, delta, scale) -> dict:
    """As ``_backward_times``, for K2c on the flat layout."""
    times = {}
    for name, kernel, plain in (
            ("dq", lambda: A.flash_attention_flat_bwd_dq(q, k, v, do, lse, delta, scale),
             lambda: A.reference_flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)),
            ("dkv", lambda: A.flash_attention_flat_bwd_dkv(q, k, v, do, lse, delta, scale),
             lambda: A.reference_flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)),
            ("bwd", lambda: A.flash_attention_bwd(q, k, v, out, lse, do, scale),
             lambda: A.reference_flash_attention_bwd(q, k, v, out, lse, do, scale))):
        got = _turns({"kernel": kernel, "plain": plain}, reps=3, warmup=1)
        times[name] = (got["kernel"], got["plain"])
    lib = _library_bwd(q[:, :, None], k[:, :, None], v[:, :, None], do[:, :, None], scale)
    times["library"] = _turns({"library": lib}, reps=3, warmup=1)["library"]
    return times


def _gn_sites(module) -> int:
    """GroupNorm layers of ``module``: each runs once per forward."""
    return sum(isinstance(m, adm._GN) for m in module.modules())


def _sd_contexts(ld, n: int) -> tuple:
    """The seeded random contexts the SD trainer draws (no text encoder is
    ported): n conditional rows and the one unconditional row, on the card."""
    ctx = make_caption_context_fn(ld, None, n, seed=0, verbose=False)(0)
    uc = make_uncond_context(ld, 1, SD_GUIDANCE)
    return torch.from_numpy(ctx).cuda(), torch.from_numpy(uc).cuda()


def _sd_model(dtype):
    pre, source = create_model(SD, "random", guidance_rate=SD_GUIDANCE,
                               dtype=dtype, device="cuda")
    _check(source == "sd", f"ms_coco's model source is {source}")
    return pre


def phase_sd_denoiser_and_gradient() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pre = _sd_model(torch.float32)
    ld = pre.latent_diffusion
    _redraw_unit_scale(ld.unet, seed=1, device="cuda")
    ld.requires_grad_(False)
    ctx, uc = _sd_contexts(ld, 2)
    sigma0 = torch.tensor([pre.sigma_max, 1.0], device="cuda")
    x0 = stacked_randn(range(2), SD_LATENT, device="cuda") * sigma0[:, None, None, None]
    cot = stacked_randn(range(100, 102), SD_LATENT, device="cuda")
    gn = _gn_sites(ld.unet)
    mh_sites = SD_SITES - SD_FLAT_SITES

    def forward():
        with torch.no_grad():
            return pre(x0, sigma0, ctx, uc)

    print(f"[SD D f32] full-width SD v1.5 U-Net "
          f"({sum(p.numel() for p in ld.unet.parameters()) / 1e6:.1f}M parameters) under its "
          f"CFGPrecond at guidance {SD_GUIDANCE} (a doubled batch of 4), batch 2, seeded random "
          f"contexts, sigma {[round(x, 4) for x in sigma0.tolist()]}, K1 + K1c + K2 + K2c + K3 "
          f"against plain attention and plain GroupNorm")
    _plain_vs_kernels("SD D f32", _plain_net_patches(adm), forward=forward,
                      per_forward=dict(k1=mh_sites, k1c=SD_FLAT_SITES, gn=gn),
                      grads=_grads_fn(pre, x0, sigma0, cot, ctx, uc),
                      per_backward=dict(k1=mh_sites, k1c=SD_FLAT_SITES, dq=mh_sites,
                                        dkv=mh_sites, dqc=SD_FLAT_SITES, dkvc=SD_FLAT_SITES,
                                        gn=gn))
    _profile("SD D f32 profile, one guided U-Net call at batch 4", forward,
             {"K1": mh_sites, "K1c": SD_FLAT_SITES, "K3": gn})
    del pre, ld
    torch.cuda.empty_cache()


def phase_sd_sampling():
    """Returns (K1 launches of the path, the bf16 CFGPrecond, its contexts)."""
    # torch's default precision flags: the f32 decode takes TF32 convs
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    pre = _sd_model(torch.bfloat16)
    ld = pre.latent_diffusion
    ctx, uc = _sd_contexts(ld, SD_BATCH)
    den = bind(pre, condition=ctx, unconditional_condition=uc)
    latents, counts, sample_s = _drive_sampling(
        "SD main", den, SD_LATENT, dict(k1=SD_SITES, gn=_gn_sites(ld.unet)), batch=SD_BATCH,
        nfe_steps=SD_NFE_STEPS, schedule=("discrete", 1.0))
    ld.decode_in_chunks(latents, chunk=DECODE_CHUNK)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    start, end = _events()
    t0 = time.perf_counter()
    start.record()
    images = ld.decode_in_chunks(latents, chunk=DECODE_CHUNK)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    decode_s = start.elapsed_time(end) / 1000
    decode_counts = _counts()
    nfe = SD_NFE_STEPS[0][0]
    print(f"[SD main] KL decode of {SD_BATCH} latents to {SD_IMAGE[0]}x{SD_IMAGE[1]}, f32 in "
          f"one chunk: {decode_s:.4f} s CUDA events (host clock {host_s:.4f} s), launches "
          f"{decode_counts}; at NFE {nfe}: {SD_BATCH / sample_s:.3f} latents/s, "
          f"{SD_BATCH / (sample_s + decode_s):.3f} images/s with the decode")
    _check(images.shape == (SD_BATCH, *SD_IMAGE) and np.isfinite(images).all(),
           f"SD decode: images not finite or of shape {images.shape}")
    _check(decode_counts == _only(gn=_gn_sites(ld.first_stage)),
           f"SD decode: launches {decode_counts}")
    return counts["k1"], pre, ctx, uc


def phase_sd_profile(pre, ctx, uc) -> None:
    """torch.profiler over one guided bf16 sampling call: the U-Net at batch
    2 x 8."""
    sigma = torch.full((SD_BATCH,), 2.5, device="cuda")
    x = stacked_randn(range(SD_BATCH), SD_LATENT, device="cuda") * 2.5
    gn = _gn_sites(pre.latent_diffusion.unet)
    _profile(f"SD profile, one guided bf16 U-Net call at batch {2 * SD_BATCH}",
             lambda: pre(x, sigma, ctx, uc), {"K1": SD_SITES, "K1c": 0, "K3": gn})


def _trainer_iterations(tag: str, cfg, pred, step, shape, iters: int, want: dict,
                        cond_fn=None) -> dict:
    """``iters`` iterations of a train step of ``build_trainer`` on latents
    of ``shape`` (with ``cond_fn(it)``'s conditioning where given), the
    counts set to 0 just before: finite losses, a predictor that moves,
    exactly ``want``'s launches; prints s/kimg and the peak memory.
    Returns the counts."""
    fresh = {k: v.clone() for k, v in pred.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses = []
    start, end = _events()
    t0 = time.perf_counter()
    start.record()
    for it in range(iters):
        latents = stacked_randn(range(it * cfg.batch, (it + 1) * cfg.batch), shape,
                                device="cuda")
        cond = () if cond_fn is None else (torch.as_tensor(cond_fn(it), device="cuda"),)
        losses.append(step(latents, *cond)["loss_per_step"].cpu().tolist())
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1000
    counts = _counts()
    moved = max((pred.state_dict()[k] - v).abs().max().item() for k, v in fresh.items())
    kimg = iters * cfg.batch / 1000
    print(f"[{tag}] build_trainer({cfg.dataset_name}): batch {cfg.batch}, batch_gpu "
          f"{cfg.batch_gpu}, f32 net, afs {cfg.afs}, {iters} iterations: {host_s:.3f} s "
          f"host clock, {device_s:.3f} s CUDA events ({device_s / kimg:.3f} s/kimg); "
          f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"losses per step {losses}; predictor moved by max abs {moved:.4g}")
    print(f"[{tag}] launches {counts}, expected {want}")
    _check(all(math.isfinite(x) for row in losses for x in row), f"{tag}: losses not finite")
    _check(moved > 0, f"{tag}: the predictor did not move")
    _check(counts == want, f"launch counts of the {tag} training")
    return counts


def _sd_amed_iterations(tag: str, cfg, pred, step, context_fn, gn: int) -> dict:
    """``SD_AMED_ITERS`` iterations of an SD AMED train step at batch
    ``SD_AMED_BATCH`` (microbatch ``SD_BATCH_GPU``) with the contexts of
    ``context_fn`` (``_trainer_iterations``), exactly the K1 / K1c / K2 /
    K2c / K3 launches of the guided f32 U-Net calls.  Returns the counts."""
    segments = AMED_STEPS - 1
    micro = SD_AMED_ITERS * SD_AMED_BATCH // SD_BATCH_GPU
    calls = (2 * 2 * segments + 2 * segments - (1 if SD_AMED_AFS else 0)) * micro
    mh_sites = SD_SITES - SD_FLAT_SITES
    want = _only(k1=mh_sites * calls, k1c=SD_FLAT_SITES * calls, gn=gn * calls,
                 dq=mh_sites * segments * micro, dkv=mh_sites * segments * micro,
                 dqc=SD_FLAT_SITES * segments * micro, dkvc=SD_FLAT_SITES * segments * micro)
    print(f"[{tag}] guidance_type=cfg, guidance_rate={SD_GUIDANCE}: a guided U-Net call of "
          f"{2 * SD_BATCH_GPU}")
    return _trainer_iterations(tag, cfg, pred, step, SD_LATENT, SD_AMED_ITERS, want, context_fn)


def phase_sd_amed(workdir: str) -> dict:
    """The SD AMED trainer as ``cli.train_amed --dataset_name=ms_coco
    --guidance_type=cfg --guidance_rate=7.5`` builds it (``build_trainer``),
    f32, for ``SD_AMED_ITERS`` iterations at batch ``SD_AMED_BATCH`` (the
    CLI's integer --total_kimg would run 125), then AMED sampling at NFE 5
    with the trained predictor through ``bind_with_bottleneck(...,
    cfg_doubled=True)``.  Returns the training's counts."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = AMEDConfig(dataset_name=SD, num_steps=AMED_STEPS, afs=SD_AMED_AFS,
                     batch=SD_AMED_BATCH, batch_gpu=SD_BATCH_GPU, guidance_type="cfg",
                     guidance_rate=SD_GUIDANCE)
    module, cfg, pred, step, context_fn = cli_train_amed.build_trainer(cfg, "random", "cuda")
    ld = module.latent_diffusion
    gn = _gn_sites(ld.unet)
    counts = _sd_amed_iterations("SD AMED", cfg, pred, step, context_fn, gn)
    segments = AMED_STEPS - 1
    mh_sites = SD_SITES - SD_FLAT_SITES

    run_dir = os.path.join(workdir, "sd_amed")
    os.makedirs(run_dir)
    ckpt.save_config(os.path.join(run_dir, "predictor_config.json"), cfg)
    ckpt.save_params(os.path.join(run_dir, "predictor.npz"), params_to_jax(pred.state_dict()))
    ctx, uc = _sd_contexts(ld, SD_AMED_BATCH)
    fn, _ = cli_sample.build_amed_sample_fn(module, run_dir, "cuda", cfg_doubled=True,
                                            condition=ctx, unconditional_condition=uc)
    lat = stacked_randn(range(SD_AMED_BATCH), SD_LATENT, device="cuda")
    fn(lat)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    start, end = _events()
    start.record()
    x = fn(lat)
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1000
    nfe = 2 * segments - (1 if cfg.afs else 0)
    sample_counts = _counts()
    want = _only(k1=mh_sites * nfe, k1c=SD_FLAT_SITES * nfe, gn=gn * nfe)
    print(f"[SD AMED] AMED sampling through bind_with_bottleneck(cfg_doubled=True), NFE {nfe}, "
          f"batch {SD_AMED_BATCH}, f32 net: {SD_AMED_BATCH / device_s:.3f} latents/s (CUDA "
          f"events, {device_s:.4f} s); launches {sample_counts}, expected {want}")
    _check(x.shape == (SD_AMED_BATCH, *SD_LATENT) and torch.isfinite(x).all().item(),
           "SD AMED samples are not finite")
    _check(sample_counts == want, "launch counts of the SD AMED sampling")
    del module, ld, fn, pred
    torch.cuda.empty_cache()
    return counts


def _conv_bound(n: int, h: int, w: int, cin: int, cout: int, dtype, fused: bool,
                cuda_cores: bool = False) -> tuple:
    """(bound_ms, bound_by) of one K4 call: 2 * 9 * Cin flops per output
    element on the tensor cores (bf16; f32 in 3xTF32, three TF32 products
    each, as ``_attention_bound``; or with ``cuda_cores`` one f32 product
    on the CUDA cores, the bound of the kernel that 3xTF32 replaced),
    against x, w, the f32 bias (and a, b) read once and out written once."""
    elt = torch.empty((), dtype=dtype).element_size()
    flops = 2 * n * h * w * cout * 9 * cin
    nbytes = (n * h * w * (cin + cout) + 9 * cin * cout) * elt + 4 * cout
    nbytes += 2 * 4 * n * cin if fused else 0
    if dtype == torch.float32 and not cuda_cores:
        t_ops = 3 * flops / PEAK_TF32_FLOPS
    else:
        t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _split_bound(cin: int, cout: int) -> tuple:
    """(bound_ms, bound_by) of one split of w: w read once, w_hi and w_lo
    written once (its few integer operations per weight are far below)."""
    return 3 * 9 * cin * cout * 4 / PEAK_BYTES_PER_S * 1e3, "bytes"


def _conv_inputs(n, h, w, cin, cout, dtype, g):
    """x, w at unit output scale, a bias, and a GroupNorm fold a ~ 1, b ~ 0.5."""
    x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(dtype)
    wt = (torch.randn(3, 3, cin, cout, generator=g, device="cuda") / (3 * cin ** 0.5)).to(dtype)
    bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
    a = 1 + 0.1 * torch.randn(n, cin, generator=g, device="cuda")
    b = 0.5 + 0.1 * torch.randn(n, cin, generator=g, device="cuda")
    return x, wt, bias, a, b


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _split_check(wt, reps: int) -> dict:
    """The split kernel (``split_w``) against its plain version
    (``split_tf32`` of w transposed) on the same w: bit-equal, and the
    kernels-line fields (no PyTorch call computes the split: library
    null)."""
    hi, lo = C.split_w(wt)
    phi, plo = C.split_tf32(wt.transpose(2, 3))
    torch.cuda.synchronize()
    err = max((hi - phi).abs().max().item(), (lo - plo).abs().max().item())
    same = all(torch.equal(u.contiguous().view(torch.int32), v.contiguous().view(torch.int32))
               for u, v in ((hi, phi), (lo, plo)))
    times = _turns({"kernel": lambda: C.split_w(wt),
                    "plain": lambda: C.split_tf32(wt.transpose(2, 3))}, reps=reps, warmup=2)
    cin, cout = wt.shape[2:]
    bound_ms, bound_by = _split_bound(cin, cout)
    print(f"[K4]   the split of w [3, 3, {cin}, {cout}]: bit-equal to split_tf32 {same} (max abs "
          f"diff {err:.3g}); kernel {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    _check(same, "the split kernel differs from split_tf32")
    return dict(max_abs_err=err, ms=times["kernel"], plain_ms=times["plain"], library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


@torch.no_grad()
def phase_conv_kernel() -> tuple:
    """K4 through its entry points: first the path, ``conv3x3`` and
    ``gn_silu_conv3x3`` once each at the two main shapes of each dtype with
    the counts set to 0 just before each dtype's run; then each entry point
    at every ``CONV_SHAPES`` shape against ``reference_conv3x3``, run twice
    (bit-identical), and timed against the plain version and ``F.conv2d``
    (cuDNN, TF32 off) on the channels-last NCHW view.  Returns (the path's
    K4 launches by dtype and the split kernel's, the kernels-line fields of
    each dtype's first shape's ``conv3x3`` and of the split)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    g = torch.Generator("cuda").manual_seed(11)
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        mains = [shape for shape in CONV_SHAPES if shape[5] == dtype and shape[0] == BATCH]
        inputs = [_conv_inputs(*shape, g) for shape in mains]
        _reset_counts()
        for x, wt, bias, a, b in inputs:
            C.conv3x3(x, wt, bias)
            C.gn_silu_conv3x3(x, a, b, wt, bias)
        torch.cuda.synchronize()
        counts = _counts()
        name = _dtype_name(dtype)
        print(f"[K4] the entry points once each at {len(mains)} {name} shapes: launches {counts}")
        split = 2 * len(mains) if dtype == torch.float32 else 0
        _check(counts == _only(k4=2 * len(mains), k4s=split), f"K4 {name} launch counts")
        launches[name] = counts["k4"]
        if split:
            launches["split"] = counts["k4s"]
        del inputs

    main = {}
    for n, h, w, cin, cout, dtype in CONV_SHAPES:
        x, wt, bias, a, b = _conv_inputs(n, h, w, cin, cout, dtype, g)
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as cuDNN takes it
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        a4, b4 = a[:, :, None, None], b[:, :, None, None]
        name = _dtype_name(dtype)
        for fused in (False, True):
            if fused:
                def kernel():
                    return C.gn_silu_conv3x3(x, a, b, wt, bias)

                def plain():
                    return C.reference_conv3x3(x, wt, bias, a, b)

                def library():
                    z = F.silu(x_nchw.float() * a4 + b4).to(dtype)
                    return F.conv2d(z, w_oihw, bias.to(dtype), padding=1)
            else:
                def kernel():
                    return C.conv3x3(x, wt, bias)

                def plain():
                    return C.reference_conv3x3(x, wt, bias)

                def library():
                    return F.conv2d(x_nchw, w_oihw, bias.to(dtype), padding=1)
            got, again, ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            tol = CONV_TOL[dtype] * ref.float().abs().max().item()
            lib_err = (library().permute(0, 2, 3, 1).float() - ref.float()).abs().max().item()
            same = torch.equal(got, again)
            del got, again, ref
            reps = 10 if n * h * w >= 1 << 16 else 50
            times = _turns({"kernel": kernel, "plain": plain, "library": library}, reps=reps,
                           warmup=2)
            bound_ms, bound_by = _conv_bound(n, h, w, cin, cout, dtype, fused)
            if dtype == torch.float32:
                cc_ms, _ = _conv_bound(n, h, w, cin, cout, dtype, fused, cuda_cores=True)
                bound = (f"bound {bound_ms:.4f} ms ({bound_by}, 3xTF32 at "
                         f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; on the CUDA cores {cc_ms:.4f} ms)")
            else:
                bound = f"bound {bound_ms:.4f} ms ({bound_by})"
            flops = 2 * n * h * w * cout * 9 * cin
            what = "gn_silu_conv3x3" if fused else "conv3x3"
            print(f"[K4] {what} [{n}, {h}, {w}, {cin}] -> {cout} {name}: max abs err {err:.3g} "
                  f"(tol {tol:.3g}; F.conv2d against the plain version {lib_err:.3g}; two runs "
                  f"bit-identical {same}); K4 "
                  f"{times['kernel']:.4f} ms ({flops / times['kernel'] / 1e9:.2f} TFLOP/s), "
                  f"plain {times['plain']:.4f} ms, F.conv2d{' after the SiLU pass' if fused else ''}"
                  f" {times['library']:.4f} ms, {bound}")
            _check(err <= tol, f"K4 disagrees with the plain version at "
                               f"{(what, n, h, w, cin, cout, name)}")
            _check(same, f"two K4 runs differ at {(what, n, h, w, cin, cout, name)}")
            if not fused and n * h * w >= 1 << 16:
                # the wrapper's own costs at this shape: the [3, 3, Cout, Cin]
                # copy of w that the bf16 kernel's B takes, or the f32
                # kernel's split of w (device time, also inside K4's), and
                # the host time of one call (the TMA maps are encoded per call)
                if dtype == torch.bfloat16:
                    wt_ms = _turns({"wt": lambda: wt.permute(0, 1, 3, 2).contiguous()},
                                   reps=reps, warmup=2)["wt"]
                    print(f"[K4]   of it: the w copy {wt_ms:.4f} ms on the device")
                else:
                    fields = _split_check(wt, reps)
                    main.setdefault("split", fields)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    kernel()
                host_us = (time.perf_counter() - t0) / reps * 1e6
                torch.cuda.synchronize()
                print(f"[K4]   host time per call {host_us:.1f} us (TMA maps encoded per call)")
            if name not in main:
                main[name] = dict(max_abs_err=err, ms=times["kernel"], plain_ms=times["plain"],
                                  library_ms=times["library"], bound_ms=bound_ms,
                                  bound_by=bound_by)
        del x, wt, x_nchw, w_oihw
        torch.cuda.empty_cache()
    return launches, main


def _ffhq_inputs(n: int):
    """x at sigma 80, 10, 1, 0.1 in turn, and those sigmas."""
    sigma = torch.tensor([80.0, 10.0, 1.0, 0.1] * (n // 4), device="cuda")
    return stacked_randn(range(n), FFHQ_SHAPE, device="cuda") * sigma[:, None, None, None], sigma


def _ffhq_steps(solver: str, nfe: int) -> tuple:
    """(num_steps, afs) giving ``nfe`` denoiser calls: one per step, or two
    for heun / dpm, whose odd NFE takes the analytic first step."""
    if solver in ("heun", "dpm"):
        return (nfe + 3) // 2, nfe % 2 == 1
    return nfe + 1, False


def phase_ffhq() -> tuple:
    """The FFHQ-64 tier at full width.  Returns (the K1 launches of the
    sampling runs, their images/s by (solver, NFE))."""
    # D in f32 against the all-plain model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    module, _ = create_model("ffhq", "random", device="cuda")
    _redraw_unit_scale(module, seed=1)
    module.requires_grad_(False)
    x, sigma = _ffhq_inputs(8)
    print(f"[FFHQ D f32] full-width FFHQ-64 EDMPrecond (SongUNet, "
          f"{sum(p.numel() for p in module.parameters()) / 1e6:.1f}M parameters), batch 8, "
          f"sigma {sigma.tolist()}")
    den = bind(module)
    _plain_vs_kernels("FFHQ D f32", _plain_net_patches(layers), forward=lambda: den(x, sigma),
                      per_forward=dict(k1=FFHQ_SITES, gn=FFHQ_GN_SITES))
    del module, den
    torch.cuda.empty_cache()

    # bf16 sampling through every solver at NFE 5 and 10
    module, _ = create_model("ffhq", "random", dtype=torch.bfloat16, device="cuda")
    den = bind(module)
    seeds = list(range(BATCH))
    kw = dict(max_batch_size=BATCH, device="cuda")
    generate(den, seeds, FFHQ_SHAPE, SolverConfig(solver="ipndm", num_steps=6), **kw)  # warm-up
    torch.cuda.synchronize()
    rates, calls, first = {}, 0, {}
    _reset_counts()
    for solver, extra in FFHQ_SOLVERS:
        tag = solver + "".join(f" {v}" for v in extra.values())
        for nfe in FFHQ_NFES:
            steps, afs = _ffhq_steps(solver, nfe)
            cfg = SolverConfig(solver=solver, num_steps=steps, afs=afs, **extra)
            _check(cfg.nfe() == nfe, f"{tag} at {steps} steps is NFE {cfg.nfe()}")
            start, end = _events()
            start.record()
            images = generate(den, seeds, FFHQ_SHAPE, cfg, **kw)
            end.record()
            torch.cuda.synchronize()
            seconds = start.elapsed_time(end) / 1000
            calls += nfe
            counts = _counts()
            rates[(tag, nfe)] = BATCH / seconds
            print(f"[FFHQ] {tag} NFE {nfe} ({steps} steps{', AFS' if afs else ''}), batch "
                  f"{BATCH}, bf16, poly-7: {BATCH / seconds:.2f} images/s (CUDA events, "
                  f"{seconds:.4f} s); launches so far {counts}")
            _check(images.shape == (BATCH, *FFHQ_SHAPE) and np.isfinite(images).all(),
                   f"FFHQ {tag} NFE {nfe}: output not finite or of shape {images.shape}")
            _check(counts == _only(**_per_calls(dict(k1=FFHQ_SITES, gn=FFHQ_GN_SITES), calls)),
                   f"FFHQ {tag} NFE {nfe}: launches {counts}")
            if nfe == FFHQ_NFES[0]:
                first[tag] = images
    launches = _counts()["k1"]

    # the CLI: UniPC to one grid (its bytes are the grid of generate's images),
    # then the trajectory
    with tempfile.TemporaryDirectory() as outdir:
        cli_sample.main(["--dataset_name=ffhq", "--model_path=random", "--solver=unipc",
                         "--num_steps=6", "--bf16=True", "--grid=True", f"--seeds=0-{BATCH - 1}",
                         f"--batch={BATCH}", "--device=cuda", f"--outdir={outdir}"])
        want = os.path.join(outdir, "want.png")
        save_grid(to_uint8(first["unipc bh2"]), want)
        with open(os.path.join(outdir, "grid.png"), "rb") as f, open(want, "rb") as f2:
            same = f.read() == f2.read()
        print(f"[FFHQ] CLI --solver=unipc --grid=True: grid.png (16 x 16 tiles of 64 x 64) "
              f"identical to the grid of generate's NFE-5 unipc images: {same}")
        _check(same, "the FFHQ CLI grid differs from generate's images")
        n = FFHQ_TRAJ_SEEDS
        cli_sample.main(["--dataset_name=ffhq", "--model_path=random", "--solver=unipc",
                         "--num_steps=6", "--bf16=True", "--return_inters=True",
                         f"--seeds=0-{n - 1}", f"--batch={n}", "--device=cuda",
                         f"--outdir={outdir}"])
        xs = np.load(os.path.join(outdir, "trajectory.npz"))["xs"]
        print(f"[FFHQ] CLI --return_inters=True: trajectory.npz xs {xs.shape}, finite "
              f"{bool(np.isfinite(xs).all())}")
        _check(xs.shape == (6, n, *FFHQ_SHAPE) and np.isfinite(xs).all(),
               f"FFHQ trajectory.npz has shape {xs.shape}")
        err = np.abs(xs[-1] - first["unipc bh2"][:n]).max()
        print(f"[FFHQ] its last point vs generate's NFE-5 unipc images at batch {BATCH}: max abs "
              f"diff {err:.3g} (tol 1e-2 * max|x|; cuDNN may pick other bf16 conv algorithms "
              f"at batch {n})")
        _check(err <= 1e-2 * np.abs(first["unipc bh2"][:n]).max(),
               "the trajectory's end is not generate's sample")

    # one profiled forward
    sigma = torch.full((BATCH,), 2.5, device="cuda")
    x = stacked_randn(range(BATCH), FFHQ_SHAPE, device="cuda") * 2.5
    tag = f"FFHQ profile, one batch-{BATCH} bf16 forward"
    _profile(tag, lambda: module(x, sigma), {"K1": FFHQ_SITES, "K3": FFHQ_GN_SITES})
    _with_plain_groupnorm(tag, lambda: module(x, sigma), [layers])
    del module, den
    torch.cuda.empty_cache()
    return launches, rates


def _gits_cli(tag: str, argv: list, num_steps: int, afs: bool) -> dict:
    """``cli.sample --dp=True`` as a user runs it: checks the dp_list (from 0
    to 60, strictly increasing, num_steps entries, one more under AFS) and
    that the whole call launched K1 and K3; returns the CLI's summary."""
    with tempfile.TemporaryDirectory() as outdir:
        _reset_counts()
        t0 = time.perf_counter()
        out = cli_sample.main([*argv, f"--afs={afs}", "--device=cuda", f"--outdir={outdir}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        pngs = glob.glob(os.path.join(outdir, "*", "*.png"))
    dp = out["dp_list"]
    print(f"[{tag}] --afs={afs}: search {out['gits_seconds']:.3f} s, dp_list {dp}; whole CLI "
          f"call {seconds:.3f} s host clock, {len(pngs)} PNGs, launches {counts}")
    # AFS inserts a free first step where one lies between the first two
    lengths = (num_steps, num_steps + 1) if afs else (num_steps,)
    _check(dp[0] == 0 and dp[-1] == 60 and all(p < q for p, q in zip(dp, dp[1:]))
           and len(dp) in lengths, f"{tag}: dp_list {dp}")
    _check(counts["k1"] > 0 and counts["gn"] > 0 and counts["k4"] == 0,
           f"{tag}: launches {counts}")
    return out


def _time_on_schedule(tag, den, shape, dp, afs, batch, schedule=("polynomial", 7.0),
                      unit="images") -> float:
    """``unit``/s of ``generate`` on the found schedule (ipndm on ``dp`` of
    the 61-point teacher schedule), CUDA events after a warm-up call."""
    cfg = SolverConfig(solver="ipndm", num_steps=61, dp_list=tuple(dp), afs=afs,
                       schedule_type=schedule[0], schedule_rho=schedule[1])
    seeds = list(range(batch))
    generate(den, seeds, shape, cfg, max_batch_size=batch, device="cuda")
    start, end = _events()
    start.record()
    x = generate(den, seeds, shape, cfg, max_batch_size=batch, device="cuda")
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1000
    print(f"[{tag}] sampling on the found schedule (NFE {cfg.nfe()}, {schedule[0]}), batch "
          f"{batch}, bf16: {batch / seconds:.2f} {unit}/s (CUDA events, {seconds:.4f} s); "
          f"finite {bool(np.isfinite(x).all())}")
    _check(np.isfinite(x).all(), f"{tag}: samples on the found schedule are not finite")
    return batch / seconds


def phase_gits_cifar() -> dict:
    """GITS on CIFAR-10 through the CLI, --afs=False then --afs=True."""
    argv = ["--dataset_name=cifar10", "--model_path=random", "--bf16=True", *GITS_ARGS,
            f"--batch={BATCH}", f"--seeds=0-{BATCH - 1}"]
    module, _ = create_model("cifar10", "random", dtype=torch.bfloat16, device="cuda")
    out = {}
    for afs in (False, True):
        res = _gits_cli("GITS CIFAR-10", argv, 6, afs)
        rate = _time_on_schedule("GITS CIFAR-10", bind(module), (32, 32, 3), res["dp_list"],
                                 afs, BATCH)
        out[afs] = dict(dp_list=res["dp_list"], seconds=res["gits_seconds"], rate=rate)
    del module
    torch.cuda.empty_cache()
    return out


def phase_gits_ldm() -> dict:
    """GITS on the LSUN-Bedroom LDM through the CLI (--afs=False), 256 warmup
    seeds at batch 64, then sampling and the VQ decode of 64 seeds."""
    argv = ["--dataset_name=lsun_bedroom_ldm", "--model_path=random", "--bf16=True",
            *GITS_ARGS, f"--batch={LDM_BATCH}", f"--seeds=0-{LDM_BATCH - 1}"]
    res = _gits_cli("GITS LSUN LDM", argv, 6, False)
    pre, _ = create_model(LDM, "random", dtype=torch.bfloat16, device="cuda")
    rate = _time_on_schedule("GITS LSUN LDM", bind(pre), LDM_LATENT, res["dp_list"], False,
                             LDM_BATCH, schedule=("discrete", 1.0), unit="latents")
    del pre
    torch.cuda.empty_cache()
    return dict(dp_list=res["dp_list"], seconds=res["gits_seconds"], rate=rate)


# Phase 31: CIFAR-10 from its checkpoint files
CKPT_D_BATCH = 64  # D of the loaded net against the source net, f32
EDM_PKL = "edm-cifar10-32x32-uncond-vp.pkl"  # phase 31 writes it, phase 33 samples from it

# Phase 32: Stable Diffusion from a checkpoint file, with its text tower
SD_CKPT_STORAGE = torch.float16  # the file's storages: half of the 4.3 GB f32 file
SD_TEXT_BATCH = 64  # prompts per text-encoder call: the CLI's chunk of captions
SD_PROMPT = "a photograph of an astronaut riding a horse on the moon"
_WORDS = dict(
    adj=["small", "red", "old", "wooden", "busy", "quiet", "white", "large"],
    noun=["cat", "dog", "train", "kitchen", "street", "horse", "table", "person"],
    prep=["on", "near", "in", "beside"],
    place=["mat", "station", "park", "window", "beach", "city", "field", "road"])


def _captions(n: int, seed: int = 0) -> list:
    """n MS-COCO-like captions drawn from a seed."""
    rng = np.random.RandomState(seed)
    return [" ".join(["a", *(str(rng.choice(_WORDS[k])) for k in ("adj", "noun", "prep")),
                      "the", str(rng.choice(_WORDS["place"]))]) for _ in range(n)]


def _merges(texts) -> list:
    """A BPE merge table under which each word of ``texts`` is one token:
    each word's characters merged left to right, the last with ``</w>``."""
    out = []
    for word in dict.fromkeys(w for t in texts for w in t.lower().split()):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            out.append((parts[0], parts[1]))
            parts = [parts[0] + parts[1]] + parts[2:]
    return list(dict.fromkeys(out))


def _kl_encoder_shapes(ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z=8) -> dict:
    """The reference KL encoder's state_dict shapes (model.py Encoder, SD
    v1.5's ``first_stage_config``): what an SD checkpoint holds and the
    port leaves out."""
    shapes = {"conv_in.weight": (ch, 3, 3, 3), "conv_in.bias": (ch,)}

    def conv(name, cout, cin, k):
        shapes.update({f"{name}.weight": (cout, cin, k, k), f"{name}.bias": (cout,)})

    def resnet(name, cin, cout):
        for norm, c in (("norm1", cin), ("norm2", cout)):
            shapes.update({f"{name}.{norm}.weight": (c,), f"{name}.{norm}.bias": (c,)})
        conv(f"{name}.conv1", cout, cin, 3)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.nin_shortcut", cout, cin, 1)

    block_in = ch
    for i, mult in enumerate(ch_mult):
        for j in range(num_res_blocks):
            resnet(f"down.{i}.block.{j}", block_in, ch * mult)
            block_in = ch * mult
        if i != len(ch_mult) - 1:
            conv(f"down.{i}.downsample.conv", block_in, block_in, 3)
    resnet("mid.block_1", block_in, block_in)
    shapes.update({"mid.attn_1.norm.weight": (block_in,), "mid.attn_1.norm.bias": (block_in,)})
    for name in ("q", "k", "v", "proj_out"):
        conv(f"mid.attn_1.{name}", block_in, block_in, 1)
    resnet("mid.block_2", block_in, block_in)
    shapes.update({"norm_out.weight": (block_in,), "norm_out.bias": (block_in,)})
    conv("conv_out", z, block_in, 3)
    return shapes


def _sd_checkpoint_extras(alphas: np.ndarray) -> dict:
    """What ``v1-5-pruned-emaonly.ckpt`` holds beside the weights the port
    loads: the KL encoder and ``quant_conv`` (seeded random, f16), the EMA
    counters, the DDPM schedule buffers and the text tower's position_ids."""
    g = torch.Generator().manual_seed(32)
    out = {f"first_stage_model.encoder.{k}": torch.randn(shape, generator=g).to(SD_CKPT_STORAGE)
           for k, shape in _kl_encoder_shapes().items()}
    out["first_stage_model.quant_conv.weight"] = torch.randn(8, 8, 1, 1, generator=g).half()
    out["first_stage_model.quant_conv.bias"] = torch.zeros(8, dtype=torch.float16)
    out["model_ema.decay"] = torch.tensor(0.9999)
    out["model_ema.num_updates"] = torch.tensor(0, dtype=torch.int32)
    a = torch.from_numpy(alphas).float()
    betas = 1 - a / torch.cat([torch.ones(1), a[:-1]])
    out.update({"betas": betas, "alphas_cumprod": a,
                "alphas_cumprod_prev": torch.cat([torch.ones(1), a[:-1]]),
                "sqrt_alphas_cumprod": a.sqrt(), "sqrt_one_minus_alphas_cumprod": (1 - a).sqrt(),
                "log_one_minus_alphas_cumprod": (1 - a).log(),
                "sqrt_recip_alphas_cumprod": a.rsqrt(), "sqrt_recipm1_alphas_cumprod": (1 / a - 1).sqrt(),
                "posterior_variance": betas, "posterior_log_variance_clipped": betas.log(),
                "posterior_mean_coef1": betas, "posterior_mean_coef2": betas})
    out["cond_stage_model.transformer.text_model.embeddings.position_ids"] = torch.arange(77)[None]
    return out


def _load_timed(tag: str, dataset: str, path: str, **kwargs):
    """(``create_model(dataset, path, ...)`` on the card, its host seconds),
    printed with the file's MB/s."""
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    out = create_model(dataset, path, device="cuda", **kwargs)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    print(f"[{tag}] create_model({dataset!r}, {os.path.basename(path)}) of {mb:.2f} MB: "
          f"{load_s:.3f} s host clock, {mb / load_s:.1f} MB/s")
    return out, load_s


def _dump_edm_pkl(obj, f) -> int:
    """``pickle.dump(obj, f)`` as EDM's ``.pkl`` holds its nets: every
    module class outside torch (EDM decorates each of its layer classes with
    ``persistence.persistent_class``) reduces to
    ``torch_utils.persistence._reconstruct_persistent_obj(meta)``, the
    module's __dict__ in ``meta['state']`` and no BUILD; torch's own modules
    (ModuleDict, Dropout) pickle plainly.  The reconstruct function is a
    stand-in under EDM's module name while the dump runs, and raises if
    anything calls it.  Returns the number of modules wrapped."""
    pkg, mod = types.ModuleType("torch_utils"), types.ModuleType("torch_utils.persistence")

    def _reconstruct_persistent_obj(meta):
        raise RuntimeError("the loader ran the reconstruct function")

    _reconstruct_persistent_obj.__module__ = mod.__name__
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    mod._reconstruct_persistent_obj, pkg.persistence = _reconstruct_persistent_obj, mod
    wrapped = {}

    def persistent(cls):
        if cls not in wrapped:
            def __reduce__(self):  # torch_utils/persistence.py's Decorator.__reduce__
                fields = list(super(wrapped[cls], self).__reduce__())
                fields += [None] * max(3 - len(fields), 0)
                meta = dict(type="class", version=6, module_src="raise SystemExit",
                            class_name=f"training.networks.{cls.__name__}", state=fields[2])
                return (_reconstruct_persistent_obj, (meta,), None, *fields[3:])

            wrapped[cls] = type(cls.__name__, (cls,), {"__reduce__": __reduce__})
        return wrapped[cls]

    mods = [m for r in obj.values() if isinstance(r, torch.nn.Module) for m in r.modules()
            if not type(m).__module__.startswith("torch.")]
    classes = [type(m) for m in mods]
    saved = {k: sys.modules.get(k) for k in (pkg.__name__, mod.__name__)}
    sys.modules.update({pkg.__name__: pkg, mod.__name__: mod})
    try:
        for m in mods:
            m.__class__ = persistent(type(m))
        pickle.dump(obj, f)
    finally:
        for m, cls in zip(mods, classes):
            m.__class__ = cls
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return len(mods)


@torch.no_grad()
def phase_checkpoint_edm(workdir: str) -> dict:
    """Phase 31: the full-width CIFAR-10 EDMPrecond (seeded, redrawn at
    unit scale) written as EDM's ``.pkl`` (a plain pickle of {'ema':
    module}, legacy storages, each module persistence-wrapped:
    ``_dump_edm_pkl``) and as a torch zip of its state_dict, each
    loaded by ``create_model('cifar10', path)``: every tensor bit-equal, D
    at batch 64 in f32 bit-equal to the source net's, with K1 and K3; then
    ``cli.sample --model_path=<.pkl>`` at NFE 5, batch 256, bf16, its PNGs
    byte for byte ``generate``'s images.  Returns the CLI run's counts."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    src, _ = create_model("cifar10", "random", device="cuda")
    _redraw_unit_scale(src, seed=31, device="cuda")
    want = {k: v.cpu() for k, v in src.state_dict().items()}
    files = {"pkl": os.path.join(workdir, EDM_PKL),
             "pt": os.path.join(workdir, "cifar10-state_dict.pt")}
    t0 = time.perf_counter()
    with open(files["pkl"], "wb") as f:
        wrapped = _dump_edm_pkl({"ema": copy.deepcopy(src).cpu(), "augment_pipe": None}, f)
    torch.save(want, files["pt"])
    print(f"[ckpt EDM] {sum(v.numel() for v in src.parameters()) / 1e6:.1f}M parameters; both "
          f"files written in {time.perf_counter() - t0:.3f} s; the .pkl pickles {wrapped} "
          f"modules through torch_utils.persistence, as EDM's snapshots do")
    _check(wrapped > 100, f"ckpt EDM: only {wrapped} modules persistence-wrapped")
    sigma = torch.tensor(np.geomspace(0.002, 80.0, CKPT_D_BATCH), dtype=torch.float32,
                         device="cuda")
    x = stacked_randn(range(CKPT_D_BATCH), (32, 32, 3), device="cuda") * sigma[:, None, None, None]
    torch.backends.cudnn.deterministic = True  # the same cuDNN algorithms for both nets
    d_src = src(x, sigma)
    for kind, path in files.items():
        (module, source), _ = _load_timed(f"ckpt EDM {kind}", "cifar10", path)
        got = module.state_dict()
        same = sum(torch.equal(got[k].cpu(), v) for k, v in want.items())
        _reset_counts()
        d = module(x, sigma)
        counts = _counts()
        print(f"[ckpt EDM {kind}] {same} of {len(want)} tensors bit-equal to the source; D at "
              f"batch {CKPT_D_BATCH} f32: max abs diff from the source net "
              f"{(d - d_src).abs().max().item():.3g}, max|D - c_skip x| "
              f"{(d - x * 0.25 / (sigma[:, None, None, None] ** 2 + 0.25)).abs().max().item():.3g}"
              f"; launches {counts}")
        _check(source == "edm" and same == len(want), f"ckpt EDM {kind}: tensors differ")
        _check(torch.equal(d, d_src), f"ckpt EDM {kind}: D differs from the source net's")
        _check(counts == _only(k1=ATTENTION_SITES, gn=CIFAR_GN_SITES),
               f"ckpt EDM {kind}: launches {counts}")
    del src, module
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    (module, _), _ = _load_timed("ckpt EDM bf16", "cifar10", files["pkl"], dtype=torch.bfloat16)
    images = generate(bind(module), range(BATCH), (32, 32, 3),
                      SolverConfig(solver="ipndm", num_steps=6), max_batch_size=BATCH,
                      device="cuda")
    nfe = 5
    _reset_counts()
    t0 = time.perf_counter()
    _check_cli_pngs("ckpt EDM", ["--dataset_name=cifar10", f"--model_path={files['pkl']}",
                                 "--solver=ipndm", "--num_steps=6", "--bf16=True"], images)
    counts = _counts()
    print(f"[ckpt EDM] cli.sample --model_path=<.pkl>, ipndm NFE {nfe}, batch {BATCH}, bf16: "
          f"{time.perf_counter() - t0:.3f} s host clock with the load; launches {counts}")
    _check(counts == _only(k1=ATTENTION_SITES * nfe, gn=CIFAR_GN_SITES * nfe),
           f"ckpt EDM CLI: launches {counts}")
    return counts


def _timed_generate(den, seeds, per_seed_cond=None):
    """SD bf16 sampling at batch SD_BATCH, ipndm NFE 5 on the discrete
    schedule: (latents, CUDA-event seconds)."""
    cfg = SolverConfig(solver="ipndm", num_steps=6, schedule_type="discrete", schedule_rho=1.0)
    start, end = _events()
    start.record()
    latents = generate(den, seeds, SD_LATENT, cfg, max_batch_size=SD_BATCH, device="cuda",
                       per_seed_cond=per_seed_cond)
    end.record()
    torch.cuda.synchronize()
    return latents, start.elapsed_time(end) / 1000


def _host_timed(fn):
    """(fn(), its host seconds up to a synchronize)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_checkpoint_sd(workdir: str) -> dict:
    """Phase 32: a full-width SD v1.5 checkpoint in
    ``v1-5-pruned-emaonly.ckpt``'s layout from seeded random weights (f16
    storages), a synthetic BPE merges file through $CLIP_BPE_VOCAB and a
    64-row captions CSV in an offline root; ``create_model('ms_coco',
    path)`` binds the text tower, which runs in f32 on 64 prompts against its
    own CPU run; ``cli.sample`` with ``--prompt`` and with per-seed captions
    (batch 8, NFE 5, bf16, guidance 7.5), byte for byte ``generate`` on
    ``get_learned_conditioning``'s contexts; two AMED iterations through
    ``build_trainer`` on the checkpoint and the captions.  Returns the
    launch counts of the two CLI runs and of the AMED run."""
    path = os.path.join(workdir, "v1-5-pruned-emaonly.ckpt")
    csv = os.path.join(workdir, "models", "MS-COCO_val2014_30k_captions.csv")
    vocab = os.path.join(workdir, "merges.txt")
    captions = _captions(SD_TEXT_BATCH)
    os.makedirs(os.path.dirname(csv))
    with open(csv, "w") as f:
        f.write("image_id,id,text\n" + "".join(f'{i},{i},"{c}"\n' for i, c in enumerate(captions)))
    merges = _merges(captions + [SD_PROMPT])
    with open(vocab, "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    pre, _ = create_model(SD, "random", device="cuda")
    src = pre.latent_diffusion
    src.cond_stage_model = init_params(FrozenCLIPEmbedder(device="cuda"), seed=1)
    sd = {k: v.to("cpu", SD_CKPT_STORAGE) for k, v in reference_state_dict(src).items()}
    want = {k: v.to(SD_CKPT_STORAGE).float() for k, v in src.state_dict().items()}
    sd.update(_sd_checkpoint_extras(src.alphas_cumprod))
    torch.save({"state_dict": sd, "global_step": 840000}, path)
    n_loaded = sum(v.numel() for v in want.values())
    print(f"[ckpt SD] {len(sd)} tensors ({n_loaded / 1e6:.1f}M loaded by the port, "
          f"{sum(v.numel() for v in sd.values()) / 1e6:.1f}M in all) in {SD_CKPT_STORAGE} "
          f"storages, {os.path.getsize(path) / 1e9:.3f} GB, written in "
          f"{time.perf_counter() - t0:.3f} s with the random init; vocab {len(merges)} merges")
    del pre, src, sd
    torch.cuda.empty_cache()

    old_vocab = os.environ.get("CLIP_BPE_VOCAB")
    os.environ["CLIP_BPE_VOCAB"] = vocab
    try:
        (pre, source), load_s = _load_timed("ckpt SD", SD, path, guidance_rate=SD_GUIDANCE,
                                            dtype=torch.bfloat16)
        ld = pre.latent_diffusion
        got = ld.state_dict()
        same = sum(torch.equal(got[k], v) for k, v in want.items())
        print(f"[ckpt SD] {same} of {len(want)} tensors bit-equal to the file's")
        _check(source == "sd" and isinstance(ld.cond_stage_model, FrozenCLIPEmbedder),
               "ckpt SD: no text encoder bound")
        _check(same == len(want), "ckpt SD: loaded tensors differ from the file's")
        del want, got

        # the text tower, f32, TF32 off, on the card and on the CPU
        enc = ld.cond_stage_model
        ids = enc.tokenize(captions)
        out = enc.encode_ids(ids)
        ms = _time_ms(lambda: enc.encode_ids(ids), reps=10, warmup=2)
        _, host_s = _host_timed(lambda: ld.get_learned_conditioning(captions))
        ref, cpu_s = _host_timed(lambda: copy.deepcopy(enc).cpu().encode_ids(ids))
        err = (out.cpu() - ref).abs().max().item()
        print(f"[ckpt SD] text tower f32 on {SD_TEXT_BATCH} prompts x 77 tokens: {ms:.4f} ms "
              f"(CUDA events), {host_s * 1e3:.2f} ms host clock with the tokenizer; max abs diff "
              f"from its CPU run {err:.3g} (tol 1e-4 * max|out| = "
              f"{1e-4 * ref.abs().max().item():.3g}; the CPU run {cpu_s:.2f} s)")
        _check(out.shape == (SD_TEXT_BATCH, 77, 768) and bool(torch.isfinite(out).all()),
               "ckpt SD: text contexts not finite")
        _check(err <= 1e-4 * ref.abs().max().item(), "ckpt SD: the tower on the card differs")

        # sampling through the CLI: a prompt, then a caption per seed
        seeds = list(range(SD_BATCH))
        gn = _gn_sites(ld.unet) * 5 + _gn_sites(ld.first_stage)
        (uc, ctx), enc_s = _host_timed(lambda: (ld.get_learned_conditioning([""]),
                                                ld.get_learned_conditioning([SD_PROMPT])))
        runs = {"prompt": (bind(pre, condition=ctx, unconditional_condition=uc), None, enc_s)}
        rows, rows_s = _host_timed(lambda: ld.get_learned_conditioning(
            [captions[s % len(captions)] for s in seeds]))
        runs["captions"] = (bind(pre, unconditional_condition=uc), rows, rows_s + enc_s)
        counts = {}
        for name, (den, per_seed, encode_s) in runs.items():
            _timed_generate(den, seeds, per_seed)  # warm-up
            latents, sample_s = _timed_generate(den, seeds, per_seed)
            images = ld.decode_in_chunks(latents, chunk=DECODE_CHUNK)
            print(f"[ckpt SD {name}] ipndm NFE 5, batch {SD_BATCH}, bf16, guidance {SD_GUIDANCE}: "
                  f"{SD_BATCH / sample_s:.3f} latents/s (CUDA events, {sample_s:.4f} s), "
                  f"{SD_BATCH / (sample_s + encode_s):.3f} latents/s with the text encode "
                  f"({encode_s * 1e3:.2f} ms host clock)")
            argv = [f"--dataset_name={SD}", f"--model_path={path}", "--solver=ipndm",
                    "--num_steps=6", "--bf16=True", f"--guidance_rate={SD_GUIDANCE}"]
            if name == "prompt":
                argv.append(f"--prompt={SD_PROMPT}")
            _reset_counts()
            with contextlib.chdir(workdir):  # the captions CSV in ./models
                cli_s = _host_timed(lambda: _check_cli_pngs(f"ckpt SD {name}", argv, images,
                                                            batch=SD_BATCH))[1]
            counts[name] = _counts()
            print(f"[ckpt SD {name}] cli.sample: {cli_s:.3f} s host clock with the load; "
                  f"launches {counts[name]}")
            _check(counts[name] == _only(k1=SD_SITES * 5, gn=gn),
                   f"ckpt SD {name} CLI: launches {counts[name]}")
        del pre, ld, enc, den, runs
        torch.cuda.empty_cache()

        # AMED on the checkpoint, with the captions
        cfg = AMEDConfig(dataset_name=SD, num_steps=AMED_STEPS, afs=SD_AMED_AFS,
                         batch=SD_AMED_BATCH, batch_gpu=SD_BATCH_GPU, guidance_type="cfg",
                         guidance_rate=SD_GUIDANCE)
        (module, cfg, pred, step, context_fn), build_s = _host_timed(
            lambda: cli_train_amed.build_trainer(cfg, path, "cuda", prompt_path=csv))
        print(f"[ckpt SD AMED] build_trainer with the checkpoint and {csv}: {build_s:.3f} s")
        _check(module.latent_diffusion.cond_stage_model is not None, "ckpt SD AMED: no encoder")
        counts["amed"] = _sd_amed_iterations("ckpt SD AMED", cfg, pred, step, context_fn,
                                             _gn_sites(module.latent_diffusion.unet))
        del module, pred, step, context_fn
        torch.cuda.empty_cache()
    finally:
        if old_vocab is None:
            os.environ.pop("CLIP_BPE_VOCAB", None)
        else:
            os.environ["CLIP_BPE_VOCAB"] = old_vocab
    print(f"[ckpt SD] load {load_s:.3f} s; text encode {ms:.4f} ms per {SD_TEXT_BATCH} prompts")
    return counts


# Phase 33: FID and PRDC of CIFAR-10 samples
EVAL_TRAIN_BATCHES = 5  # data_batch_1..5 of the synthetic CIFAR-10 tarball
EVAL_BATCH_IMAGES = 2000  # images per data_batch: 10,000 in the dataset zip
EVAL_SAMPLES = 10000  # CIFAR-10 samples scored: fid calc's --strict-count holds at 10k
DETECTOR_BATCH = 250
DETECTOR_CHECK_IMAGES = 16  # card against CPU, 32 px, both preprocessing paths
DETECTOR_TOL = 1e-4  # of max|CPU features|: both sum in f32 in other orders
PRDC_NUM = 5000
PRDC_NEAR = 1e-5  # a pair this close (relative) to its radius may decide either way
FID_SELF_TOL = 1e-3  # |FID(dataset, its own reference stats)| <= this * trace(sigma)


class _GraphUnit(torch.nn.Module):
    """One conv unit of an NVIDIA-style detector pickle: a kernel and its
    BN vectors under TF-ish names (the automap's input)."""

    def __init__(self, weight, gamma, beta, mean, var):
        super().__init__()
        self.weight = torch.nn.Parameter(weight)
        for name, v in (("gamma", gamma), ("beta", beta), ("moving_mean", mean),
                        ("moving_variance", var)):
            self.register_buffer(name, v)


def _random_inception(seed: int) -> dict:
    """The detector's state_dict from a numpy seed: He-scaled convs (std
    sqrt(2 / fan_in)), BN scale and var in [0.8, 1.2], bias and mean
    0.05 N(0, 1), so that activations stay of order one."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, ref in InceptionV3FID().state_dict().items():
        shape, leaf = tuple(ref.shape), key.rsplit(".", 1)[1]
        if ref.dim() == 4:
            arr = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif leaf in ("weight", "running_var"):
            arr = rng.uniform(0.8, 1.2, shape)
        else:
            arr = 0.05 * rng.randn(*shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    return sd


def _write_detectors(sd: dict, workdir: str) -> tuple:
    """``sd`` as a torch zip of a torchvision-named state_dict (with
    ``num_batches_tracked`` and the 1008-way ``fc`` head) and as a plain
    pickle of a module tree in TF graph order (the NVIDIA layout the
    automap reads, the head last).  Returns (.pth path, .pkl path)."""
    g = torch.Generator().manual_seed(1008)
    head = {"fc.weight": torch.randn(1008, 2048, generator=g), "fc.bias": torch.zeros(1008)}
    named = dict(sd, **head, **{k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
                                for k in sd if k.endswith("running_var")})
    pth = os.path.join(workdir, "pt_inception-2015-12-05.pth")
    torch.save(named, pth)
    units = torch.nn.Sequential(*[
        _GraphUnit(*(sd[f"{'.'.join(path)}.{leaf}"] for leaf in (
            "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")))
        for path in CONV_UNITS_GRAPH_ORDER])
    units.add_module("output", torch.nn.Linear(2048, 1008))
    pkl = os.path.join(workdir, "inception-2015-12-05.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(units, f)
    return pth, pkl


def _cifar10_tarball(path: str, seed: int) -> None:
    """CIFAR-10's python tarball layout: data_batch_1..5, each a pickle of
    {'data': uint8 [n, 3072] (CHW rows), 'labels': [n]}."""
    rng = np.random.RandomState(seed)
    with tarfile.open(path, "w:gz") as tar:
        for i in range(1, EVAL_TRAIN_BATCHES + 1):
            blob = pickle.dumps({"data": rng.randint(0, 256, (EVAL_BATCH_IMAGES, 3072),
                                                     dtype=np.uint8),
                                 "labels": rng.randint(0, 10, EVAL_BATCH_IMAGES).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/data_batch_{i}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


def _detector_flops(net) -> int:
    """FLOPs of one 299 px image: 2 * Cout * Cin * kh * kw * Ho * Wo over
    the convs, read from their shapes in one forward."""
    flops = []

    def hook(conv, _inp, out):
        flops.append(2 * out[0].numel() * conv.weight[0].numel())

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        net(torch.zeros(1, 299, 299, 3, dtype=torch.uint8,
                        device=next(net.parameters()).device))
    for h in handles:
        h.remove()
    return sum(flops)


def _prdc_f64(real: np.ndarray, fake: np.ndarray, k: int) -> tuple:
    """(d_rf, real radii, fake radii) in float64 numpy: ``x^2 - 2 x y^T +
    y^2`` (its rows spot-checked against ``scipy.spatial.distance.cdist``),
    the radius the (k + 1)-th smallest distance, self included."""
    from scipy.spatial.distance import cdist

    def dist(a, b):
        d2 = (a * a).sum(1)[:, None] - 2.0 * (a @ b.T) + (b * b).sum(1)[None, :]
        return np.sqrt(np.maximum(d2, 0.0))

    r, f = real.astype(np.float64), fake.astype(np.float64)
    d_rf = dist(r, f)
    spot = cdist(r[:64], f)
    _check(np.abs(d_rf[:64] - spot).max() <= 1e-9 * spot.max(),
           "PRDC: the float64 formula disagrees with cdist")
    return (d_rf, np.partition(dist(r, r), k, axis=1)[:, k],
            np.partition(dist(f, f), k, axis=1)[:, k])


def _prdc_gate(tag: str, real: np.ndarray, fake: np.ndarray, k: int, cli_out: dict = None
               ) -> int:
    """The port's precision / recall / density / coverage decisions (its f32
    distances and radii on the card) against float64 ones on the same
    features: equal but for pairs within PRDC_NEAR relative of their radius.
    The CLI's metrics, where given, must be the port's.  Returns the count
    of near pairs."""
    d_rf = P.pairwise_distances(real, fake)
    real_r, fake_r = P.knn_radii(real, k), P.knn_radii(fake, k)
    d64, real64, fake64 = _prdc_f64(real, fake, k)
    decisions = {"precision": (d_rf < real_r[:, None], d64 < real64[:, None],
                               np.abs(d64 - real64[:, None]) <= PRDC_NEAR * real64[:, None]),
                 "recall": (d_rf < fake_r[None, :], d64 < fake64[None, :],
                            np.abs(d64 - fake64[None, :]) <= PRDC_NEAR * fake64[None, :])}
    m32, m64 = d_rf.min(axis=1), d64.min(axis=1)
    decisions["coverage"] = (m32 < real_r, m64 < real64,
                             np.abs(m64 - real64) <= PRDC_NEAR * real64)
    near = 0
    for name, (port, exact, close) in decisions.items():
        flips = int((port != exact).sum())
        bad = int(((port != exact) & ~close).sum())
        near += int(close.sum())
        print(f"[eval PRDC {tag}] {name}: {flips} decisions differ from float64, {bad} of them "
              f"outside {PRDC_NEAR:g} of the radius; {int(close.sum())} pairs within it")
        _check(bad == 0, f"PRDC {name}: {bad} decisions differ from float64 away from the radius")
    p_dec, r_dec, c_dec = (decisions[n][0] for n in ("precision", "recall", "coverage"))
    port = dict(precision=float(p_dec.any(axis=0).mean()), recall=float(r_dec.any(axis=1).mean()),
                density=float((1.0 / k) * p_dec.sum(axis=0).mean()),
                coverage=float(c_dec.mean()))
    print(f"[eval PRDC {tag}] the port's metrics on its decisions: {port}")
    if cli_out is not None:
        _check(all(cli_out[n] == v for n, v in port.items()),
               f"PRDC: the CLI's {[cli_out[n] for n in port]} are not the port's {port}")
    return near


def phase_eval(workdir: str, pkl_path: str) -> dict:
    """Phase 33: FID and PRDC of CIFAR-10 samples.  A synthetic CIFAR-10
    tarball (10,000 images from a seed) -> ``cli.dataset_tool`` -> a zip of
    PNGs; a random Inception detector (``_random_inception``) written as a
    torchvision-named torch zip and as an NVIDIA-style graph-order pickle,
    the two imports equal; the detector on the card against its CPU run
    (both preprocessing paths); ``fid ref`` of the dataset, ``fid calc`` of
    the dataset against it (FID ~ 0) and again in the process (bit-equal);
    10,000 samples of phase 31's ``.pkl`` through ``cli.sample`` (ipndm NFE
    5, batch 256, bf16; K1 / K3 counted), ``fid calc`` and ``prdc calc
    --num 5000`` of them, PRDC held to float64; the detector's images/s at
    batch 250 against its f32 bound.  Returns the sampling's counts."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tarball = os.path.join(workdir, "cifar-10-python.tar.gz")
    data_zip = os.path.join(workdir, "cifar10-32x32.zip")
    _cifar10_tarball(tarball, seed=33)
    (count, tool_s) = _host_timed(lambda: cli_dataset_tool.main([f"--source={tarball}",
                                                                 f"--dest={data_zip}"]))
    print(f"[eval] dataset_tool: {count} PNGs and dataset.json from the CIFAR-10 tarball in "
          f"{tool_s:.3f} s host clock ({os.path.getsize(data_zip) / 1e6:.2f} MB)")
    _check(count == EVAL_TRAIN_BATCHES * EVAL_BATCH_IMAGES, f"dataset_tool wrote {count} images")

    sd = _random_inception(seed=2015)
    pth, pkl = _write_detectors(sd, workdir)
    by_name = import_inception_state_dict(torch_state_dict(load_torch_file(pth)))
    by_order, report = import_nvidia_inception_pickle(pkl)
    same = sum(torch.equal(by_name[k], by_order[k]) for k in by_order)
    print(f"[eval] detector imports: {len(by_name)} tensors by name from the torch zip, "
          f"{report['n_units']} conv units by the automap of the graph-order pickle, {same} "
          f"equal; unused {report['unused']}")
    _check(by_name.keys() == by_order.keys() == sd.keys() and same == len(sd)
           and all(torch.equal(by_name[k], v) for k, v in sd.items())
           and report["unused"] == ["output.weight", "output.bias"],
           "the two detector imports differ")

    imgs = np.random.RandomState(34).randint(0, 256, (DETECTOR_CHECK_IMAGES, 32, 32, 3),
                                             dtype=np.uint8)
    errs = {}
    for tf in (True, False):  # the default path's net stays on the card for the timing
        net = InceptionV3FID(tf_preprocessing=tf)
        net.load_state_dict(sd)
        with torch.inference_mode():
            want = net.eval()(torch.from_numpy(imgs))
            got = net.cuda()(torch.from_numpy(imgs).cuda()).cpu()
        errs[tf] = (got - want).abs().max().item() / want.abs().max().item()
        print(f"[eval] detector {'TF' if tf else 'default'} preprocessing, {len(imgs)} images "
              f"at 32 px: max|f| {want.abs().max().item():.4f}, mean f "
              f"{want.mean().item():.4f}; card vs CPU max abs err {errs[tf]:.3g} of max|f| "
              f"(gate {DETECTOR_TOL:g})")
        _check(errs[tf] <= DETECTOR_TOL and torch.isfinite(got).all().item(),
               f"detector on the card vs CPU: {errs[tf]:.3g}")
    _check((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
           == (True, True), "the detector left the caller's TF32 flags changed")

    flops = _detector_flops(net)
    x = torch.from_numpy(np.random.RandomState(35).randint(
        0, 256, (DETECTOR_BATCH, 32, 32, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        batch_ms = _time_ms(lambda: net(x), reps=5, warmup=2)
    bound_ms = max(DETECTOR_BATCH * flops / PEAK_FLOPS[torch.float32],
                   sum(v.numel() * 4 for v in sd.values()) / PEAK_BYTES_PER_S) * 1e3
    print(f"[eval] detector at batch {DETECTOR_BATCH}, f32 (TF32 off), 32 px input: "
          f"{batch_ms:.4f} ms a batch, {DETECTOR_BATCH / batch_ms * 1e3:.1f} images/s; "
          f"{flops / 1e9:.4f} GFLOP an image from its conv shapes, bound {bound_ms:.4f} ms "
          f"(operations, 67 TFLOP/s f32), {bound_ms / batch_ms:.3f} of it")
    del net, x
    torch.cuda.empty_cache()

    ref = os.path.join(workdir, "cifar10-ref.npz")
    torch.backends.cudnn.deterministic = True  # the CLI and the process pick the same convs
    (ref_out, ref_s) = _host_timed(lambda: cli_fid.main([
        "ref", f"--data={data_zip}", f"--dest={ref}", f"--batch={DETECTOR_BATCH}",
        f"--inception={pth}"]))
    trace = float(np.trace(ref_out["sigma"]))
    (self_out, self_s) = _host_timed(lambda: cli_fid.main([
        "calc", f"--images={data_zip}", f"--ref={ref}", f"--num={EVAL_SAMPLES}",
        f"--batch={DETECTOR_BATCH}", f"--inception={pth}"]))
    print(f"[eval] fid ref of the dataset: {ref_s:.3f} s; fid calc of the dataset against it: "
          f"{self_s:.3f} s, FID {self_out['fid']!r} (trace(sigma) {trace:.6g}, gate "
          f"{FID_SELF_TOL:g} of it)")
    _check(abs(self_out["fid"]) <= FID_SELF_TOL * trace, f"FID of the dataset against itself "
           f"{self_out['fid']!r}")
    ds = ImageFolderDataset(data_zip, max_size=EVAL_SAMPLES)
    mu, sigma = calculate_stats(make_inception_feature_fn(by_name),
                                (im for im, _ in ds.batches(DETECTOR_BATCH)))
    fid_here = compute_fid(mu, sigma, *load_stats(ref))
    print(f"[eval] the same FID from stats built in this process: {fid_here!r}")
    _check(fid_here == self_out["fid"] and np.array_equal(mu, self_out["mu"])
           and np.array_equal(sigma, self_out["sigma"]),
           "the CLI's FID is not the process's compute_fid")
    torch.backends.cudnn.deterministic = False

    samples = os.path.join(workdir, "samples")
    nfe, batches = 5, math.ceil(EVAL_SAMPLES / BATCH)
    _reset_counts()
    (_, sample_s) = _host_timed(lambda: cli_sample.main([
        "--dataset_name=cifar10", f"--model_path={pkl_path}", "--solver=ipndm",
        "--num_steps=6", f"--seeds=0-{EVAL_SAMPLES - 1}", f"--batch={BATCH}", "--bf16=True",
        "--device=cuda", f"--outdir={samples}"]))
    counts = _counts()
    print(f"[eval] cli.sample: {EVAL_SAMPLES} CIFAR-10 PNGs, ipndm NFE {nfe}, batch {BATCH}, "
          f"bf16, in {sample_s:.3f} s host clock with the load ({EVAL_SAMPLES / sample_s:.1f} "
          f"images/s); launches {counts}")
    _check(counts == _only(k1=ATTENTION_SITES * nfe * batches, gn=CIFAR_GN_SITES * nfe * batches),
           f"eval sampling: launches {counts}")
    (fid_out, fid_s) = _host_timed(lambda: cli_fid.main([
        "calc", f"--images={samples}", f"--ref={ref}", f"--batch={DETECTOR_BATCH}",
        f"--inception={pth}", f"--num={EVAL_SAMPLES}"]))
    print(f"[eval] fid calc of the samples: {fid_s:.3f} s host clock: PNG decode "
          f"{fid_out['decode']:.3f} s, features and moments {fid_out['features']:.3f} s, sqrtm "
          f"{fid_out['sqrtm']:.3f} s; FID {fid_out['fid']!r} (random detector and net)")
    _check(np.isfinite(fid_out["fid"]) and fid_out["fid"] > 0, f"FID {fid_out['fid']!r}")
    (prdc_out, prdc_s) = _host_timed(lambda: cli_prdc.main([
        "calc", f"--images={samples}", f"--images_ref={data_zip}", f"--num={PRDC_NUM}",
        f"--batch={DETECTOR_BATCH}", f"--inception={pkl}"]))
    print(f"[eval] prdc calc --num {PRDC_NUM} with the graph-order .pkl (TF preprocessing): "
          f"{prdc_s:.3f} s host clock; " + ", ".join(
              f"{k} {prdc_out[k]!r}" for k in ("precision", "recall", "density", "coverage")))
    _check(prdc_out["real"].shape == prdc_out["fake"].shape == (PRDC_NUM, 2048),
           "PRDC features' shapes")
    near = _prdc_gate("CLI", prdc_out["real"], prdc_out["fake"], 5, prdc_out)
    # samples of random weights lie far from the data: the halves of the
    # dataset's features are a pair whose decisions are not all one way
    half = PRDC_NUM // 2
    near += _prdc_gate("dataset halves", prdc_out["real"][:half], prdc_out["real"][half:], 5)
    print(f"[eval] PRDC: {near} pairs within {PRDC_NEAR:g} of their radius; the rest decide as "
          f"in float64")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return counts


def _new_order_views(b, t, h, d, dtype, g):
    """q, k, v as ``models.adm.new_order_attention`` hands them to sdpa:
    strided views of one [B, T, 3, H, d] projection (token stride 3Hd, the
    attention pool's qkv_proj)."""
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(dtype)
    return qkv.reshape(b, t, 3, h, d).unbind(2)


def _attention_sites(module) -> int:
    """Attention calls of one forward of an ADM net: its attention blocks
    and, in the classifier, its attention pool."""
    return sum(isinstance(m, (adm.AttentionBlock, adm.AttentionPool2d)) for m in module.modules())


def _peak(tag: str) -> None:
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] torch.cuda.max_memory_allocated {peak:.3f} GiB", flush=True)


def phase_adm_kernels() -> dict:
    """K1 and K2 at the 256 px tiers' attention shapes (the U-Net's and the
    classifier's legacy views, the attention pool's new-order views at the
    ragged T=65), K3 at their GroupNorm shapes; returns the kernels-line
    fields."""
    k1 = _k1_checks("ADM K1", ADM_K1_SHAPES, _legacy_views, seed=40, reps=5, warmup=2)
    _k1_checks("ADM pool K1", ADM_POOL_SHAPES, _new_order_views, seed=41, reps=5, warmup=2)
    k2 = _k2_checks("ADM K2", ADM_K2_SHAPES, _legacy_views, seed=42)
    _k2_checks("ADM pool K2", ADM_POOL_SHAPES, _new_order_views, seed=43)
    return dict(k1=k1, k2=k2, gn=_gn_checks(ADM_GN_SHAPES, ADM_GN_ENTRIES, seed=44))


def _adm_inputs(n: int, sigmas, seed: int = 0):
    """x at ``sigmas`` in turn, those sigmas, a cotangent, integer labels."""
    sigma = torch.tensor([sigmas[i % len(sigmas)] for i in range(n)], device="cuda")
    x = stacked_randn(range(seed, seed + n), ADM_SHAPE, device="cuda") * sigma[:, None, None, None]
    cot = stacked_randn(range(seed + 100, seed + 100 + n), ADM_SHAPE, device="cuda")
    labels = torch.arange(n, device="cuda") * 97 % 1000
    return x, sigma, cot, labels


def _adm_model(name: str, dtype, unit_scale: bool = False):
    """The full-width 256 px tier from random weights, on the card
    (``unit_scale``: every weight redrawn at unit scale, TF32 off, for the
    f32 parity); prints its sites and parameters."""
    pre, source = create_model(name, "random", dtype=dtype, device="cuda")
    _check(source == {CM: "cm", CG: "adm"}[name], f"{name}'s model source is {source}")
    nets = [pre.net] + ([pre.classifier] if name == CG else [])
    if unit_scale:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for i, net in enumerate(nets):
            _redraw_unit_scale(net, seed=1 + i, device="cuda")
    print(f"[{name}] " + "; ".join(
        f"{type(net).__name__} {sum(p.numel() for p in net.parameters()) / 1e6:.1f}M parameters, "
        f"{_attention_sites(net)} attention and {_gn_sites(net)} GroupNorm calls a forward"
        for net in nets))
    return pre


def _cm_per_call(pre) -> dict:
    return dict(k1=_attention_sites(pre.net), gn=_gn_sites(pre.net))


def _cg_per_call(pre) -> dict:
    """One CGPrecond call: the U-Net's forward, the classifier's forward and
    its backward (one K2 pair per attention call; K3's backward is plain)."""
    cls = _attention_sites(pre.classifier)
    return dict(k1=_attention_sites(pre.net) + cls, gn=_gn_sites(pre.net) + _gn_sites(
        pre.classifier), dq=cls, dkv=cls)


def phase_cm_denoiser_and_gradient() -> None:
    pre = _adm_model(CM, torch.float32, unit_scale=True)
    x0, sigma0, cot, _ = _adm_inputs(ADM_CHECK_BATCH, [80.0, 10.0, 1.0, 0.1])
    per = _cm_per_call(pre)

    def forward():
        with torch.no_grad():
            return pre(x0, sigma0)

    torch.cuda.reset_peak_memory_stats()
    _plain_vs_kernels("CM D f32", _plain_net_patches(adm), forward=forward, per_forward=per,
                      grads=_grads_fn(pre, x0, sigma0, cot),
                      per_backward=dict(per, dq=per["k1"], dkv=per["k1"]))
    _peak("CM D f32")
    del pre
    torch.cuda.empty_cache()


def phase_cm_sampling() -> dict:
    """bf16 sampling through ``generate`` at NFE 5 and 10, batch 8, then the
    sampling CLI on the same seeds.  Returns the counts."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    pre = _adm_model(CM, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    images, counts, _ = _drive_sampling("CM main", bind(pre), ADM_SHAPE, _cm_per_call(pre),
                                        batch=ADM_BATCH, nfe_steps=ADM_NFE_STEPS)
    _peak("CM main")
    _check_cli_pngs("CM main", [f"--dataset_name={CM}", "--model_path=random", "--solver=ipndm",
                                f"--num_steps={ADM_NFE_STEPS[0][1]}", "--bf16=True"], images,
                    batch=ADM_BATCH)
    del pre
    torch.cuda.empty_cache()
    return counts


def phase_cm_amed(workdir: str) -> dict:
    """The CM AMED trainer as ``cli.train_amed --dataset_name=lsun_bedroom
    --batch_gpu=8`` builds it (``build_trainer``; the CLI's integer
    --total_kimg would run 63 iterations at batch 16), f32, for two
    iterations, then ``cli.sample --predictor`` from its saved predictor.
    Returns the training's counts."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = AMEDConfig(dataset_name=CM, num_steps=AMED_STEPS, batch=ADM_AMED_BATCH,
                     batch_gpu=ADM_BATCH_GPU)
    module, cfg, pred, step, cond_fn = cli_train_amed.build_trainer(cfg, "random", "cuda")
    _check(cond_fn is None, "the CM trainer takes no conditioning")
    per = _cm_per_call(module)
    segments = AMED_STEPS - 1
    micro = ADM_AMED_ITERS * ADM_AMED_BATCH // ADM_BATCH_GPU
    # per microbatch: the heun teacher 2 calls per fine step, 2 fine steps a
    # segment; the amed student 2 calls a segment, the second differentiated
    calls = (2 * 2 * segments + 2 * segments) * micro
    want = _only(**_per_calls(per, calls), dq=per["k1"] * segments * micro,
                 dkv=per["k1"] * segments * micro)
    counts = _trainer_iterations("CM AMED", cfg, pred, step, ADM_SHAPE, ADM_AMED_ITERS, want)
    run_dir = os.path.join(workdir, "cm_amed")
    os.makedirs(run_dir)
    ckpt.save_config(os.path.join(run_dir, "predictor_config.json"), cfg)
    ckpt.save_params(os.path.join(run_dir, "predictor.npz"), params_to_jax(pred.state_dict()))
    del module, step, pred
    torch.cuda.empty_cache()
    _sample_with_predictor("CM AMED", CM, run_dir, os.path.join(workdir, "cm_amed_samples"),
                           ADM_SHAPE, nfe=2 * segments, per_call=per, batch=ADM_BATCH)
    return counts


def phase_cg_denoiser() -> None:
    """The full-width f32 CGPrecond (net and classifier, unit-scale weights,
    TF32 off): D, and the classifier's gradient alone, with K1 + K2 + K3
    against the all-plain model."""
    pre = _adm_model(CG, torch.float32, unit_scale=True)
    x, sigma, _, labels = _adm_inputs(ADM_CHECK_BATCH, [1.0, 0.3, 0.1, 0.02])
    per = _cg_per_call(pre)
    den = bind(pre)
    torch.cuda.reset_peak_memory_stats()
    d = den(x, sigma, labels)
    print(f"[CG D f32] sigma {sigma.tolist()}, labels {labels.tolist()}: share of D inside the "
          f"clamp (|D| < 1) {(d.abs() < 1).float().mean().item():.4f}")
    _plain_vs_kernels("CG D f32", _plain_net_patches(adm), forward=lambda: den(x, sigma, labels),
                      per_forward=per)
    x_in = x / (sigma[:, None, None, None] ** 2 + 1).sqrt()
    t = (pre.M - 1) * pre.sigma_inv(sigma)
    cls = dict(k1=per["dq"], gn=_gn_sites(pre.classifier), dq=per["dq"], dkv=per["dq"])
    _plain_vs_kernels("CG classifier gradient f32", _plain_net_patches(adm),
                      forward=lambda: pre._cond_grad(x_in, t, labels), per_forward=cls)
    _peak("CG D f32")
    del pre, den
    torch.cuda.empty_cache()


def phase_cg_sampling() -> dict:
    """bf16 classifier-guided sampling through ``generate`` with integer
    labels at NFE 5 and 10, batch 8: every net call launches the bf16 K2
    through the classifier's gradient; then the sampling CLI with
    ``--guidance_type=cg``, one CG call split into the U-Net, the
    classifier's forward and its backward (CUDA events), and one profiled
    call.  Returns the counts."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    pre = _adm_model(CG, torch.bfloat16)
    per = _cg_per_call(pre)
    torch.cuda.reset_peak_memory_stats()
    images, counts, _ = _drive_sampling("CG main", bind(pre), ADM_SHAPE, per, label_dim=1000,
                                        batch=ADM_BATCH, nfe_steps=ADM_NFE_STEPS,
                                        label_kind="int")
    _peak("CG main")
    print(f"[CG main] bf16 K2 launches on this path: dQ {counts['dq']}, dK/dV {counts['dkv']}")
    _check(counts["dq"] > 0 and counts["dkv"] > 0, "CG sampling launched no bf16 K2")
    _check_cli_pngs("CG main", [f"--dataset_name={CG}", "--model_path=random", "--solver=ipndm",
                                f"--num_steps={ADM_NFE_STEPS[0][1]}", "--bf16=True",
                                "--guidance_type=cg"], images, batch=ADM_BATCH)
    x, sigma, _, labels = _adm_inputs(ADM_BATCH, [2.5])
    x_in = x / math.sqrt(2.5 ** 2 + 1)
    t = (pre.M - 1) * pre.sigma_inv(sigma)

    def classifier_fwd():
        with torch.no_grad():
            return pre.classifier_fn(x_in, t)

    with torch.no_grad():
        times = _turns({"CG call": lambda: pre(x, sigma, labels),
                        "U-Net forward": lambda: pre.model_fn(x_in, t, labels),
                        "classifier forward": classifier_fwd,
                        "classifier forward + backward": lambda: pre._cond_grad(x_in, t, labels)},
                       reps=5, warmup=2)
    print(f"[CG split] one bf16 CG call at batch {ADM_BATCH} (CUDA events, in turns): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; classifier backward "
          f"{times['classifier forward + backward'] - times['classifier forward']:.3f} ms")
    _profile(f"CG profile, one batch-{ADM_BATCH} bf16 call", lambda: pre(x, sigma, labels),
             {"K1": per["k1"], "K2 dQ": per["dq"], "K2 dK/dV": per["dkv"], "K3": per["gn"]})
    del pre
    torch.cuda.empty_cache()
    return counts


def phase_cg_amed_refusal() -> None:
    """The AMED step on imagenet256 differentiates the student's loss
    through the classifier's gradient: on the card the attention kernels'
    backward refuses the second order with a named error, and the predictor
    does not move."""
    cfg = AMEDConfig(dataset_name=CG, num_steps=2, batch=2, guidance_type="cg")
    module, cfg, pred, step, label_fn = cli_train_amed.build_trainer(cfg, "random", "cuda")
    fresh = {k: v.clone() for k, v in pred.state_dict().items()}
    try:
        step(stacked_randn(range(2), ADM_SHAPE, device="cuda"), label_fn(0))
    except RuntimeError as e:
        message = str(e)
    else:
        message = None
    print(f"[CG AMED] the step raised: {message}")
    _check(message is not None and "second-order gradient through attention kernel K2" in message
           and "JAX package" in message, "the imagenet256 AMED step trained on the card")
    _check(all(torch.equal(pred.state_dict()[k], v) for k, v in fresh.items()),
           "the predictor moved before the refusal")
    del module, step, pred
    torch.cuda.empty_cache()


def phase_adm_checkpoints(workdir: str) -> None:
    """The three tiers from reference-layout files written here from seeded
    random full-width nets in f16 storages (the attention's 1x1 convs as
    Conv1d [O, I, 1]): ``checkpoints/edm_bedroom256_ema.pt``,
    ``checkpoints/256x256_diffusion.pt`` with ``256x256_classifier.pt``, and
    ``lsun_cat.pt``; each loaded strictly through ``create_model`` (the zoo's
    resolver from ./checkpoints, lsun_cat by its path), every tensor
    bit-equal to the file's, D (f32, TF32 off, batch 2) bit-equal to that of
    the same tiers loaded by ``torch.load`` of the file (cuDNN deterministic:
    CG's D holds the classifier's input gradient, whose conv backward may
    otherwise take an algorithm that sums in any order)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    here = os.getcwd()
    os.chdir(workdir)
    try:
        os.makedirs("checkpoints")
        files = {"edm_bedroom256_ema.pt": ("net", CM, 5),
                 "256x256_diffusion.pt": ("net", CG, 6),
                 "256x256_classifier.pt": ("classifier", CG, 7)}
        for fname, (part, name, seed) in files.items():
            src = getattr(create_model(name, "random", device="cuda")[0], part)
            sd = {k: v.to(torch.float16).cpu() for k, v in adm.reference_state_dict(src).items()}
            _check(any(v.dim() == 3 for v in sd.values()), f"{fname} holds no Conv1d weight")
            t0 = time.perf_counter()
            torch.save(sd, os.path.join("checkpoints", fname))
            size = os.path.getsize(os.path.join("checkpoints", fname))
            print(f"[ADM files] wrote {fname}: {len(sd)} tensors, {size / 1e6:.1f} MB, "
                  f"{time.perf_counter() - t0:.3f} s")
            del src, sd
        os.link(os.path.join("checkpoints", "edm_bedroom256_ema.pt"), "lsun_cat.pt")
        x, sigma, _, labels = _adm_inputs(2, [7.0, 0.4])
        for name, path in ((CM, None), ("lsun_cat", "lsun_cat.pt"), (CG, None)):
            parts = {"net": "edm_bedroom256_ema.pt" if name != CG else "256x256_diffusion.pt"}
            if name == CG:
                parts["classifier"] = "256x256_classifier.pt"
            mb = sum(os.path.getsize(os.path.join("checkpoints", f)) for f in parts.values()) / 1e6
            t0 = time.perf_counter()
            pre, _ = create_model(name, path, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            print(f"[ADM files] create_model({name!r}, {path!r}) of {mb:.1f} MB: {load_s:.3f} s "
                  f"host clock, {mb / load_s:.1f} MB/s")
            direct = create_model(CM if name == "lsun_cat" else name, "random", device="cuda")[0]
            for part, fname in parts.items():
                sd = torch.load(os.path.join("checkpoints", fname), weights_only=True)
                adm.load_adm_checkpoint(getattr(direct, part), {k: v.float() for k, v in
                                                                sd.items()})
                got = adm.reference_state_dict(getattr(pre, part))
                _check(set(got) == set(sd) and all(torch.equal(got[k].cpu(), sd[k].float())
                                                   for k in sd),
                       f"{name}: {fname} did not load bit-equal")
            with torch.no_grad():
                d_file = bind(pre)(x, sigma, labels if name == CG else None)
                d_direct = bind(direct)(x, sigma, labels if name == CG else None)
            torch.cuda.synchronize()
            print(f"[ADM files] {name}: every tensor bit-equal to the file's; D max "
                  f"{d_direct.abs().max().item():.4g}, bit-equal to torch.load's: "
                  f"{torch.equal(d_file, d_direct)}")
            _check(torch.isfinite(d_file).all().item() and torch.equal(d_file, d_direct),
                   f"{name}: D from the file differs from D of torch.load's weights")
            del pre, direct
            torch.cuda.empty_cache()
    finally:
        os.chdir(here)
        torch.backends.cudnn.deterministic = False


def _kernel_entry(name, source, replaces, launches, fields) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: fields[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


_CLOCKS = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,"
           "power.draw,clocks_throttle_reasons.active", "--format=csv,noheader"]


def _phase(label: str, fn, *args):
    """Run one phase and print its seconds on the host clock, then the
    card's SM / max SM / memory clocks, temperature, power draw and active
    throttle reasons as nvidia-smi reads them just after."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"[time] {label}: {time.perf_counter() - t0:.2f} s; card after it: {_run(_CLOCKS)}",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = _phase("phase 1, environment", phase_environment)
    _phase("phase 2, build", phase_build)
    k1 = _phase("phase 3, K1 at the CIFAR-10 shapes", phase_kernel)
    _phase("phase 4, CIFAR-10 D f32", phase_denoiser_f32)
    launches, cifar_gn = _phase("phase 5, CIFAR-10 sampling", phase_main_path)
    k2 = _phase("phase 6, K2 at the CIFAR-10 shapes", phase_backward_kernel)
    _phase("phase 7, CIFAR-10 gradient f32", phase_gradient_f32)
    with tempfile.TemporaryDirectory() as workdir:
        amed = _phase("phase 8, CIFAR-10 AMED", phase_amed, workdir)
    in64_k1 = _phase("phase 9, K1 at the ImageNet-64 shapes", phase_in64_kernel)
    in64_k2 = _phase("phase 10, K2 at the ImageNet-64 shapes", phase_in64_backward_kernel)
    _phase("phase 11, ImageNet-64 D and gradient f32", phase_in64_denoiser_and_gradient)
    in64_launches, in64_gn, module = _phase("phase 12, ImageNet-64 sampling",
                                            phase_in64_sampling)
    _phase("phase 14, ImageNet-64 profile", phase_in64_profile, module)
    del module
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        in64_amed = _phase("phase 13, ImageNet-64 AMED", phase_in64_amed, workdir)
    k3 = _phase("phase 15, K3 at the LSUN LDM, CIFAR-10 and ImageNet-64 shapes",
                phase_groupnorm_kernel)
    k2b = _phase("phase 16, K1 / K2 at the LSUN LDM shapes", phase_ldm_attention_kernels)
    _phase("phase 17, LSUN LDM D and gradient f32", phase_ldm_denoiser_and_gradient)
    ldm_gn, vq_gn, pre = _phase("phase 18, LSUN LDM sampling and decode", phase_ldm_sampling)
    _phase("phase 20, LSUN LDM profile", phase_ldm_profile, pre)
    del pre
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        ldm_amed, k2b_launches = _phase("phase 19, LSUN LDM AMED", phase_ldm_amed, workdir)
    sd_k1, sd_k2 = _phase("phase 21, K1 / K2 at the SD head dims", phase_sd_attention_kernels)
    sd_k1c, sd_k2c = _phase("phase 22, K1c / K2c at the SD f32 shape", phase_sd_flat_kernels)
    _phase("phase 23, SD D and gradient f32", phase_sd_denoiser_and_gradient)
    sd_launches, pre, ctx, uc = _phase("phase 24, SD sampling and KL decode", phase_sd_sampling)
    _phase("phase 26, SD profile", phase_sd_profile, pre, ctx, uc)
    del pre
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        sd_amed = _phase("phase 25, SD AMED", phase_sd_amed, workdir)
    k4_launches, k4 = _phase("phase 27, K4 at the CIFAR-10 and FFHQ conv shapes",
                             phase_conv_kernel)
    ffhq_launches, _ = _phase("phase 28, FFHQ-64 D f32, sampling through every solver, CLI, "
                              "profile", phase_ffhq)
    _phase("phase 29, GITS on CIFAR-10 through the CLI", phase_gits_cifar)
    _phase("phase 30, GITS on the LSUN LDM through the CLI", phase_gits_ldm)
    with tempfile.TemporaryDirectory() as workdir:
        ckpt_edm = _phase("phase 31, CIFAR-10 from its checkpoint files", phase_checkpoint_edm,
                          workdir)
        eval_counts = _phase("phase 33, FID and PRDC of CIFAR-10 samples", phase_eval, workdir,
                             os.path.join(workdir, EDM_PKL))
    with tempfile.TemporaryDirectory() as workdir:
        ckpt_sd = _phase("phase 32, Stable Diffusion from a checkpoint, with its text tower",
                         phase_checkpoint_sd, workdir)
    adm_k = _phase("phase 34a, K1 / K2 / K3 at the 256 px shapes", phase_adm_kernels)
    _phase("phase 34b, LSUN-Bedroom 256 (CM) D and gradient f32",
           phase_cm_denoiser_and_gradient)
    cm_counts = _phase("phase 34c, LSUN-Bedroom 256 sampling and CLI", phase_cm_sampling)
    with tempfile.TemporaryDirectory() as workdir:
        cm_amed = _phase("phase 34d, LSUN-Bedroom 256 AMED", phase_cm_amed, workdir)
    _phase("phase 35a, ImageNet-256 classifier-guided D f32", phase_cg_denoiser)
    cg_counts = _phase("phase 35b, ImageNet-256 classifier-guided sampling, CLI, split, profile",
                       phase_cg_sampling)
    _phase("phase 35c, the ImageNet-256 AMED step refuses on the card", phase_cg_amed_refusal)
    with tempfile.TemporaryDirectory() as workdir:
        _phase("phase 36, the 256 px tiers from checkpoint files", phase_adm_checkpoints,
               workdir)
    for name, n in (("K1", launches), ("K2 dQ", amed["dq"]), ("K2 dK/dV", amed["dkv"]),
                    ("K1 on ImageNet-64", in64_launches),
                    ("K2 dQ on ImageNet-64", in64_amed["dq"]),
                    ("K2 dK/dV on ImageNet-64", in64_amed["dkv"]),
                    ("K3 on CIFAR-10", cifar_gn), ("K3 on ImageNet-64", in64_gn),
                    ("K3 on the LSUN LDM", ldm_gn), ("K3 on the VQ decode", vq_gn),
                    ("K2 dQ on the LSUN LDM at T=1024", k2b_launches["dq"]),
                    ("K2 dK/dV on the LSUN LDM at T=1024", k2b_launches["dkv"]),
                    ("K1 on SD", sd_launches), ("K2 dQ on SD", sd_amed["dq"]),
                    ("K2 dK/dV on SD", sd_amed["dkv"]), ("K1c on SD", sd_amed["k1c"]),
                    ("K2c dQ on SD", sd_amed["dqc"]), ("K2c dK/dV on SD", sd_amed["dkvc"]),
                    ("K4 bf16 through its entry points", k4_launches["bfloat16"]),
                    ("K4 f32 through its entry points", k4_launches["float32"]),
                    ("K4 f32's split of w", k4_launches["split"]),
                    ("K1 on FFHQ-64", ffhq_launches),
                    ("K1 on CIFAR-10 from its .pkl", ckpt_edm["k1"]),
                    ("K3 on CIFAR-10 from its .pkl", ckpt_edm["gn"]),
                    ("K1 on SD from its checkpoint, --prompt", ckpt_sd["prompt"]["k1"]),
                    ("K1 on SD from its checkpoint, captions", ckpt_sd["captions"]["k1"]),
                    ("K3 on SD from its checkpoint", ckpt_sd["captions"]["gn"]),
                    ("K1 f32 on SD AMED with captions", ckpt_sd["amed"]["k1"]),
                    ("K1c on SD AMED with captions", ckpt_sd["amed"]["k1c"]),
                    ("K2 dQ f32 on SD AMED with captions", ckpt_sd["amed"]["dq"]),
                    ("K2 dK/dV f32 on SD AMED with captions", ckpt_sd["amed"]["dkv"]),
                    ("K1 on the CIFAR-10 samples for FID", eval_counts["k1"]),
                    ("K3 on the CIFAR-10 samples for FID", eval_counts["gn"]),
                    ("K1 on LSUN-Bedroom 256", cm_counts["k1"]),
                    ("K3 on LSUN-Bedroom 256", cm_counts["gn"]),
                    ("K1 f32 on LSUN-Bedroom 256 AMED", cm_amed["k1"]),
                    ("K2 dQ f32 on LSUN-Bedroom 256 AMED", cm_amed["dq"]),
                    ("K2 dK/dV f32 on LSUN-Bedroom 256 AMED", cm_amed["dkv"]),
                    ("K1 on ImageNet-256 with classifier guidance", cg_counts["k1"]),
                    ("K3 on ImageNet-256 with classifier guidance", cg_counts["gn"]),
                    ("K2 dQ bf16 on ImageNet-256 with classifier guidance", cg_counts["dq"]),
                    ("K2 dK/dV bf16 on ImageNet-256 with classifier guidance",
                     cg_counts["dkv"])):
        _check(n > 0, f"{name} was not launched on its path")
    print(f"[time] whole run: {time.perf_counter() - t_start:.2f} s")
    print(smi)
    fwd, fwd32, bwd, bwd32 = ("diff_sampler_tpu_torch/csrc/flash_attn_fwd.cu",
                              "diff_sampler_tpu_torch/csrc/flash_attn_fwd_tf32.cu",
                              "diff_sampler_tpu_torch/csrc/flash_attn_bwd.cu",
                              "diff_sampler_tpu_torch/csrc/flash_attn_bwd_tf32.cu")
    tpu = "diff_sampler_tpu/ops/pallas_attention.py"
    conv, tpu_conv = ("diff_sampler_tpu_torch/csrc/conv3x3.cu",
                      "diff_sampler_tpu/ops/pallas_conv.py")
    print(json.dumps({"kernels": [
        _kernel_entry("flash_attention_mh (K1, multi-head flash-attention forward)", fwd,
                      f"{tpu}:157", launches, k1["main"]),
        _kernel_entry("flash_attention_mh in f32 (K1 in 3xTF32 on the tensor cores, CIFAR-10 "
                      "AMED path)", fwd32, f"{tpu}:157", amed["k1"], k1["float32"]),
        _kernel_entry("flash_attention_bwd_dq in f32 (K2, flash-attention backward, dQ, in "
                      "3xTF32 on the tensor cores, CIFAR-10 AMED path)", bwd32, f"{tpu}:406",
                      amed["dq"], k2["main"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 (K2, flash-attention backward, dK/dV, in "
                      "3xTF32 on the tensor cores, CIFAR-10 AMED path)", bwd32, f"{tpu}:554",
                      amed["dkv"], k2["main"]["dkv"]),
        _kernel_entry("flash_attention_bwd_dq in bf16 (K2, flash-attention backward, dQ, on the "
                      "tensor cores; ImageNet-256 classifier-guidance sampling path: the bf16 "
                      "classifier's gradient, at its T=1024 H=4 d=64 level)",
                      bwd, f"{tpu}:406", cg_counts["dq"], adm_k["k2"]["bfloat16"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in bf16 (K2, flash-attention backward, dK/dV, on "
                      "the tensor cores; ImageNet-256 classifier-guidance sampling path: the bf16 "
                      "classifier's gradient, at its T=1024 H=4 d=64 level)",
                      bwd, f"{tpu}:554", cg_counts["dkv"], adm_k["k2"]["bfloat16"]["dkv"]),
        _kernel_entry("flash_attention_mh at d=64 (K1 in place of K1b, ImageNet-64 path)",
                      fwd, f"{tpu}:227", in64_launches, in64_k1["main"]),
        _kernel_entry("flash_attention_mh in f32 at d=64 (K1 in 3xTF32 in place of K1b, "
                      "ImageNet-64 AMED path)", fwd32, f"{tpu}:227", in64_amed["k1"],
                      in64_k1["float32"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at d=64 (K2 dQ in 3xTF32 in place of "
                      "K2p, ImageNet-64 AMED path)", bwd32, f"{tpu}:441", in64_amed["dq"],
                      in64_k2["main"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at d=64 (K2 dK/dV in 3xTF32 in place of "
                      "K2p, ImageNet-64 AMED path)", bwd32, f"{tpu}:491", in64_amed["dkv"],
                      in64_k2["main"]["dkv"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at T=1024 H=14 d=32 (K2 dQ in 3xTF32 in "
                      "place of K2b, LSUN LDM AMED path)", bwd32, f"{tpu}:699",
                      k2b_launches["dq"], k2b["main"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at T=1024 H=14 d=32 (K2 dK/dV in 3xTF32 "
                      "in place of K2b, LSUN LDM AMED path)", bwd32, f"{tpu}:757",
                      k2b_launches["dkv"], k2b["main"]["dkv"]),
        *(_kernel_entry(f"groupnorm_silu (K3, fused GroupNorm + affine + SiLU, {label} path, "
                        f"route {k3[label]['route']})", "diff_sampler_tpu_torch/csrc/groupnorm.cu",
                        "diff_sampler_tpu/ops/pallas_groupnorm.py:29", n, k3[label])
          for label, n in (("CIFAR-10", cifar_gn), ("LSUN LDM", ldm_gn),
                           ("ImageNet-64", in64_gn), ("VQ decode", vq_gn))),
        _kernel_entry("flash_attention_mh at d=40/80/160 (K1 at the SD head dims, padded in "
                      "the kernel; SD bf16 sampling path)", fwd, f"{tpu}:157", sd_launches,
                      sd_k1["main"]),
        _kernel_entry("flash_attention_mh in f32 at d=80/160 (K1 in 3xTF32 at the SD head dims, "
                      "SD f32 AMED path)", fwd32, f"{tpu}:157", sd_amed["k1"], sd_k1["float32"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at d=80/160 (K2 dQ in 3xTF32 at the SD "
                      "head dims, SD f32 AMED path)", bwd32, f"{tpu}:406", sd_amed["dq"],
                      sd_k2["main"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at d=80/160 (K2 dK/dV in 3xTF32 at the "
                      "SD head dims, SD f32 AMED path)", bwd32, f"{tpu}:554", sd_amed["dkv"],
                      sd_k2["main"]["dkv"]),
        _kernel_entry("flash_attention (K1c, flat flash-attention forward in 3xTF32, SD f32 "
                      "AMED path)", fwd32, f"{tpu}:49", sd_amed["k1c"], sd_k1c),
        _kernel_entry("flash_attention_flat_bwd_dq (K2c, flat flash-attention backward, dQ, "
                      "in 3xTF32, SD f32 AMED path)", bwd32, f"{tpu}:960", sd_amed["dqc"],
                      sd_k2c["dq"]),
        _kernel_entry("flash_attention_flat_bwd_dkv (K2c, flat flash-attention backward, "
                      "dK/dV, in 3xTF32, SD f32 AMED path)", bwd32, f"{tpu}:994",
                      sd_amed["dkvc"], sd_k2c["dkv"]),
        _kernel_entry("flash_attention_mh (K1, CIFAR-10 samples scored by FID / PRDC: launches of "
                      "phase 33, times of phase 3)", fwd, f"{tpu}:157", eval_counts["k1"],
                      k1["main"]),
        _kernel_entry(f"groupnorm_silu (K3, CIFAR-10 samples scored by FID / PRDC, route "
                      f"{k3['CIFAR-10']['route']}: launches of phase 33, times of phase 15)",
                      "diff_sampler_tpu_torch/csrc/groupnorm.cu",
                      "diff_sampler_tpu/ops/pallas_groupnorm.py:29", eval_counts["gn"],
                      k3["CIFAR-10"]),
        _kernel_entry("flash_attention_mh at the 256 px U-Net's d=64 (K1, LSUN-Bedroom 256 CM "
                      "bf16 sampling path, legacy views at T=1024 H=8)", fwd, f"{tpu}:227",
                      cm_counts["k1"], adm_k["k1"]["bfloat16"]),
        _kernel_entry("flash_attention_mh at the 256 px U-Net's and classifier's d=64 (K1, "
                      "ImageNet-256 classifier-guidance bf16 sampling path, the attention pool's "
                      "T=65 included; times at the U-Net's T=1024 H=8)", fwd, f"{tpu}:227",
                      cg_counts["k1"], adm_k["k1"]["bfloat16"]),
        _kernel_entry("flash_attention_mh in f32 at the 256 px U-Net's d=64 (K1 in 3xTF32, "
                      "LSUN-Bedroom 256 CM f32 AMED path)", fwd32, f"{tpu}:227", cm_amed["k1"],
                      adm_k["k1"]["float32"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at the 256 px U-Net's d=64 (K2 dQ in "
                      "3xTF32, LSUN-Bedroom 256 CM f32 AMED path)", bwd32, f"{tpu}:441",
                      cm_amed["dq"], adm_k["k2"]["float32"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at the 256 px U-Net's d=64 (K2 dK/dV in "
                      "3xTF32, LSUN-Bedroom 256 CM f32 AMED path)", bwd32, f"{tpu}:491",
                      cm_amed["dkv"], adm_k["k2"]["float32"]["dkv"]),
        *(_kernel_entry(f"groupnorm_silu (K3, {label} bf16 sampling path at [8, 256, 256, 256], "
                        f"route {adm_k['gn']['256 px']['route']})",
                        "diff_sampler_tpu_torch/csrc/groupnorm.cu",
                        "diff_sampler_tpu/ops/pallas_groupnorm.py:29", n, adm_k["gn"]["256 px"])
          for label, n in (("LSUN-Bedroom 256 CM", cm_counts["gn"]),
                           ("ImageNet-256 classifier-guidance", cg_counts["gn"]))),
        _kernel_entry("conv3x3 / gn_silu_conv3x3 in bf16 (K4, 3x3 conv with a fused "
                      "GroupNorm-affine + SiLU prologue: wgmma on a TMA-loaded halo tile, the "
                      "prologue once per staged pixel; its entry points, no JAX path)", conv,
                      f"{tpu_conv}:53", k4_launches["bfloat16"], k4["bfloat16"]),
        _kernel_entry("conv3x3 / gn_silu_conv3x3 in f32 (K4 in 3xTF32 on wgmma over the same "
                      "TMA halo tile: A split into TF32 hi / lo in registers, three products a "
                      "k8 step, fresh accumulators folded in f32 per chunk; its entry points, no "
                      "JAX path)", conv, f"{tpu_conv}:53", k4_launches["float32"],
                      k4["float32"]),
        _kernel_entry("split_w (K4 f32's TF32 split of w into K-major hi / lo, one launch per "
                      "f32 K4 call; its entry points, no JAX path)", conv, f"{tpu_conv}:53",
                      k4_launches["split"], k4["split"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
