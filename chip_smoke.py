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
   from a 61-point ipndm teacher, 64 warmup seeds at batch 256 (the
   reference's 256 cut for the script's time), dev metric,
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
   a synthetic CIFAR-10 python tarball (5 batches of 500 uint8 images from
   the seed) through ``cli.dataset_tool`` to a zip of 2,500 PNGs and
   dataset.json; a random Inception detector (He-scaled convs, BN of order
   one, from a numpy seed) written as a torch zip of a torchvision-named
   state_dict and as a plain pickle of a module tree in TF graph order, both
   imports equal; the detector on the card (f32, TF32 off inside it while
   the caller's flags are on) against its CPU run on 16 images at 32 px
   through both preprocessing paths, within 1e-4 * max|f|; ``fid ref`` of
   the dataset and ``fid calc`` of the dataset against it, |FID| <= 1e-3 *
   trace(sigma), and bit-equal to ``compute_fid`` on stats built in this
   process; 2,500 samples of phase 31's ``.pkl`` through ``cli.sample``
   (ipndm NFE 5, batch 256, bf16; exact K1 / K3 launches), ``fid calc`` of
   them with its host seconds split into PNG decode, features and sqrtm,
   ``prdc calc --num 2500`` with the graph-order pickle, whose decisions
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
37. SFD on CIFAR-10 at full width, f32: (a) one segment's weight gradient
   at batch 8 (unit-scale weights, TF32 off, remat on) with K1 + K2 + K3
   against the all-plain student at 1e-4 * max, with exactly the launches
   of the forward and of remat's recompute (each block's K1 and K3 again in
   the backward); the same gradient with remat and without, bit-equal
   (cuDNN deterministic); one primed profile of the segment, every K1 / K2
   in its trace; K1 / K2 f32 at the student's [128, 256, 1, 256] and K3 f32
   at its [128, 32, 32, 256] against their plain versions and the library;
   (b) ``cli.train_sfd`` at batch 128 with its defaults (4 steps, M=3, the
   dpmpp teacher, AFS, remat) for 1 kimg: s/kimg, peak memory, losses,
   exactly the predicted launches, the student moved; (c) one SFD-v
   iteration (num_steps drawn as the CLI draws it): the step-condition
   modules train, Adam counts num_steps - 2 updates, exact launches; (d)
   ``cli.sample`` from the run dir (euler at the restored 4 steps with
   AFS), its PNGs byte for byte ``generate`` on the snapshot's student, with
   and without ``--skip_tuning``.
38. The LSUN LDM student (274M f32 U-Net, remat off) through
   ``cli.train_sfd`` at batch 512 in microbatches of 128 (3 steps, M=1):
   s/kimg, peak memory, exact launches (K2's by (T, H)); then
   ``cli.sample`` from the run dir (the stack rebuilt from the training's
   model path, the U-Net swapped, the discrete schedule), its PNGs byte for
   byte ``generate`` + the VQ decode.
39. (After phase 32, in its directory.) The 860M SD student as
   ``cli.train_sfd`` builds it from phase 32's f16 checkpoint (its text
   tower, guidance 7.5, trained at 1.0): its segment gradient at batch 2
   on caption contexts against the all-plain U-Net (TF32 off, 1e-4 * max,
   exact K1 / K1c / K2 / K2c / K3 launches); K1 / K2 and K1c / K2c f32 at
   the microbatch's shapes; one ``make_ldm_train_step`` iteration at batch
   8 in 2 microbatches of 4 (s/iteration, peak memory, exact launches); a
   snapshot (its params) and its training_options.json naming the
   checkpoint; then
   ``cli.sample --model_path=0`` (the experiment number) with a caption
   per seed, bf16, guidance 7.5, its PNGs byte for byte ``generate`` + the
   KL decode on the snapshot's U-Net.
40. (After phases 32 and 33, in 32's directory.) The CLIP score at the
   width of the reference's detector, OpenCLIP ViT-g-14: a seeded open_clip
   state_dict in f16 storages (``open_clip_pytorch_model.bin``, 1366.7M
   params) loaded through ``make_openclip_encoders`` (host seconds, MB/s,
   every tensor bit-equal to the file's); both towers in f32 (TF32 off) on
   4 images and 4 prompts against the same modules in float64 on the card;
   each tower's device time at batch 64 against its f32 bound (FLOPs from
   the shapes over 67 TFLOP/s) and the vision attention's share of its
   tower (T=257, 16 heads of 88); ``cli.clip_score`` on 256 seeded 512 x
   512 PNGs (the downscale) and on 256 of phase 33's 32 x 32 samples (the
   upscale) against a 256-row captions CSV tokenised by phase 32's vocab;
   the same pairs scored in this process (equal to the CLI's) and their
   images/s.  No kernel of the repo runs there (counted).
41. The trajectory analyzer on the full-width CIFAR-10 net in f32 (random
   weights redrawn at unit scale, loaded from a file the phase writes):
   ``cli.analyze_trajectories`` at 21 steps and batch 16, again with
   ``--num_images=64`` (its statistics against the per-sample statistics
   of its 4 batches combined in float64 on the host),
   ``cli.analyze_extend --mode=sampling`` (euler, 101 steps) and
   ``--mode=low_rank_mog``; every number finite, exact K1 / K3 launches; K1
   and K3 in f32 at the analyzer's [16, ...] shapes against their plain
   versions and the library.
42. (After phase 8, in its directory.) ``export_amed_schedule`` of phase 8's
   saved predictor over the full-width CIFAR-10 net (16 probe seeds, exact
   K1 / K3 launches): every r in (0, 1), every t_mid between its sigmas,
   the saved JSON read back equal.  Every ``train_amed`` and ``train_sfd``
   run (phases 8, 13, 19, 37, 38) holds a ``log.txt`` with every line its
   CLI printed.
43. Data and sequence parallelism (``parallel/``, ``ops/ring_attention.py``;
   after phase 38): one-process references first (the CIFAR-10 sampling
   CLI at full width, bf16, ipndm NFE 5, seeds 0-511 at batch 256; SD v1.5
   seeds 0-1, guided 7.5, NFE 5, decoded, in f32 with TF32 off and in bf16;
   one AMED iteration on CIFAR-10 through ``train_amed.build_trainer`` at
   batch 512 in microbatches of 256, and one at batch 64, f32, TF32 off),
   beside which the sampling CLI runs as one process under NCCL (world size
   1; its PNGs byte-equal to the reference's).  Then, through
   ``parallel.launch.run_local``, two processes over gloo, each on cuda:0
   (NCCL refuses two ranks on one card), run the CLI over 2 data ranks
   (byte-equal PNGs), ``sdpa`` through the ring over one seq group of 2 at
   SD's [2, 4096, 8, 40] in bf16 and f32 and CIFAR-10's [256, 256, 1, 256]
   against the plain attention over the whole T (K1's and K2's tolerances
   on out and dq / dk / dv, exactly 2 K1 and 2 K2 pairs a ring call), SD
   with the ring (exact launches, the ledger: T = 4096 / 1024 / 256 rang,
   T = 64 skipped; in f32 its images within one uint8 level of the
   reference's), one bf16 call on one input with the ring, with the plain
   attention and with planted faults (SD's guided D at sigma_max and the
   ImageNet-256 classifier's gradient: the ring within 1.5 times the plain
   attention's distance from the --sp=1 call, a dropped block beyond it),
   ImageNet-256 classifier-guided sampling with --sp=2 in bf16 (the
   classifier's gradient runs K2 on the ring's tiles; exact launches, the
   ledger), the AMED iteration data parallel and the batch-64 one with
   --sp=2 (the ring inside the train step, K2 on its tiles; exact launches;
   each predictor within 1e-4 of its reference's).  Last, K1 and K2 at the
   ring's tiles on these paths and at SD's tile [2, 2048, 8, 40] beside the
   whole T=4096, in bf16 and f32, as phases 3 and 6.
44. Tensor parallelism and FSDP (``parallel/tp.py``, ``parallel/fsdp.py``).
   Two gloo processes on cuda:0 form one model group of 2 and, for FSDP,
   one data group of 2.  They start before phase 33 and run beside phases
   33 and 32 (gloo's host transport leaves the card idle most of the time;
   the script joins them before phase 39), and phase 44 proper, after 43,
   samples the one-process references and holds the ranks' results to them
   (SD v1.5's: phase 43's one-process f32 run).  The ranks run the CIFAR-10 sampling CLI with
   --tp=2 (64 seeds, f32, TF32 off, ipndm NFE 5: PNGs within one uint8
   level of one process's, exact launches), ImageNet-256 classifier
   guidance with the U-Net and the classifier tp=2-sharded (seeds 0-1, f32,
   within one level; before it the classifier's bf16 gradient at sigma_max
   on one call: within 1.5 times one process's bf16 - f32 distance of one
   process's bf16 call, and beyond it with one row-parallel layer's sum
   skipped), SD v1.5 with its U-Net tp=2-sharded (seeds 0-1, f32, guided
   7.5, within one level of phase 43's reference; K1 on 4 of 8 heads), one
   SFD iteration on CIFAR-10 with --tp=2 and one on SD v1.5 with FSDP
   (batch 2), and one AMED iteration on the LSUN LDM with FSDP (batch 8),
   each against a one-process run of the same rows in the same
   microbatches made first in the rank (weights within 1e-4, Adam's first
   moment within 1e-4 of its largest entry, the predictor within 1e-4;
   cuDNN deterministic), with each rank's resident parameter and Adam
   bytes and its peak memory against one process's, and exact launches.
   Last, K1 / K2 at the shards' local heads ([2, 1024, 4 / 2, 64]) and K3
   on a channel slice ([2, 256, 256, 128] in 16 groups), as phases 3, 6
   and 15.
45. The last modules of the JAX package.  (a) Beside phase 44's ranks, in
   phase 32's directory (gates only): SD v1.5 loaded from phase 32's file
   with its KL encoder (``build_latent_diffusion(..., encoder=True)``), 8
   images of 512 x 512 encoded in f32, TF32 off: the posterior's mean and
   logvar and ``decode(encode(x).mode())`` with K3 against the all-plain
   first stage at 1e-4 * max, exactly 22 K3 launches an encode and 30 in
   the decode.  After phase 40: one profiled encode (K3's share), the
   encode's ms with K3, K3 at the encoder's [8, 512, 512, 128] f32.  (b) LPIPS at 224 from a torchvision-layout
   VGG16 file and an LPIPS-layout heads file: 0 on identical inputs,
   symmetric, the card against the CPU at 1e-4; CIFAR-10 SFD's second
   stage through ``training/sfd.py`` with a unit-scale student and teacher
   (f32, TF32 off, remat): the last segment's weight gradient with LPIPS,
   K1 / K2 / K3 against the all-plain student at 1e-4 * max, two iterations
   at batch 128 with LPIPS and one without (s/iteration, exact launches),
   the LPIPS forward at batch 128 against its f32 bound.  (c) EDM's
   CIFAR-10 augment pipe on 512 images, the card against the CPU on the
   same draws at 1e-5; (b)'s student's weight gradient in train mode
   (dropout 0.13) with the augment labels on 128 of them, K1 / K2 /
   K3 against the all-plain net on the same dropout masks at 1e-4 * max;
   one ``ema_update`` over the LSUN LDM U-Net's f32 parameters, bit-equal
   to the per-tensor formula, against its byte bound.

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
and 35), the f32 K1 / K2 (K1c / K2c on SD) and K3 on the SFD students'
paths (launches of phases 37-39; the LDM's times those of phase 16), K1
and K3 in f32 on the trajectory analyzer's and the AMED export's paths
(launches of phases 41 and 42, times at the analyzer's shapes), K1 and
K2 in bf16 and f32 at the ring's tiles (launches of phase 43's --sp=2
paths, rank 0's and the ring's partials only), K1 / K2 / K3 at the
--tp=2 shards' local shapes (launches of phase 44's paths, rank 0's), K3
at the SD v1.5 KL encoder's shape and K1 / K2 / K3 on phase 45's CIFAR-10
paths (SFD's second stage with LPIPS, the train-mode gradient with augment
labels; times of phase 37 at the same shapes), each
with its error and times at that path's main
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
import dataclasses
import glob
import io
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from diff_sampler_tpu_torch import _build
from diff_sampler_tpu_torch import analysis
from diff_sampler_tpu_torch.cli import analyze_extend as cli_analyze_extend
from diff_sampler_tpu_torch.cli import analyze_trajectories as cli_analyze_trajectories
from diff_sampler_tpu_torch.cli import clip_score as cli_clip_score
from diff_sampler_tpu_torch.cli import dataset_tool as cli_dataset_tool
from diff_sampler_tpu_torch.cli import fid as cli_fid
from diff_sampler_tpu_torch.cli import prdc as cli_prdc
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed as cli_train_amed
from diff_sampler_tpu_torch.cli import train_sfd as cli_train_sfd
from diff_sampler_tpu_torch.eval import prdc as P
from diff_sampler_tpu_torch.eval.clip_score import (clip_preprocess, clip_score,
                                                    make_openclip_encoders)
from diff_sampler_tpu_torch.eval.dataset import ImageFolderDataset
from diff_sampler_tpu_torch.eval.lpips import LPIPS, load_lpips_weights
from diff_sampler_tpu_torch.eval.fid import (calculate_stats, compute_fid, load_stats,
                                             make_inception_feature_fn)
from diff_sampler_tpu_torch.eval.inception import (CONV_UNITS_GRAPH_ORDER, InceptionV3FID,
                                                   exact_f32, import_inception_state_dict,
                                                   import_nvidia_inception_pickle)
from diff_sampler_tpu_torch.integrations.amed_export import (export_amed_schedule,
                                                             save_amed_schedule)
from diff_sampler_tpu_torch.models import adm, convert, layers, unets
from diff_sampler_tpu_torch.models.convert import absent_from_jax, load_jax_params, params_to_jax
from diff_sampler_tpu_torch.parallel.mesh import cut, shard_spec
from diff_sampler_tpu_torch.models.factory import (build_edm_model, build_ldm_model, create_model,
                                                   init_params)
from diff_sampler_tpu_torch.models.ldm import (LDM_CONFIGS, LDMUNet, build_latent_diffusion,
                                               reference_state_dict)
from diff_sampler_tpu_torch.models.openclip import OpenCLIP, OpenCLIPConfig
from diff_sampler_tpu_torch.models.openclip import attention as openclip_attention
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.models.torch_import import load_torch_file, torch_state_dict
from diff_sampler_tpu_torch.models.zoo import load_checkpoint_params
from diff_sampler_tpu_torch.models.text import FrozenCLIPEmbedder
from diff_sampler_tpu_torch.ops import attention as A
from diff_sampler_tpu_torch.ops import conv as C
from diff_sampler_tpu_torch.ops import groupnorm as G
from diff_sampler_tpu_torch.ops.augment import AugmentPipe
from diff_sampler_tpu_torch.ops.geometry import (trajectory_curvature, trajectory_deviation,
                                                 trajectory_lengths)
from diff_sampler_tpu_torch.ops.schedules import get_schedule
from diff_sampler_tpu_torch.sampling import SolverConfig, generate, to_uint8
from diff_sampler_tpu_torch.solvers import SOLVER_REGISTRY
from diff_sampler_tpu_torch.solvers.amed import bind_with_bottleneck
from diff_sampler_tpu_torch.training.amed import AMEDConfig, predictor_from_config
from diff_sampler_tpu_torch.training.conditioning import (load_captions, make_caption_context_fn,
                                                          make_uncond_context)
from diff_sampler_tpu_torch.training.sfd import SFDConfig
from diff_sampler_tpu_torch.training.sfd import adam_count as sfd_adam_count
from diff_sampler_tpu_torch.training.sfd import make_ldm_train_step as make_sfd_ldm_train_step
from diff_sampler_tpu_torch.training.sfd import make_train_step as make_sfd_train_step
from diff_sampler_tpu_torch.utils import checkpoint as ckpt
from diff_sampler_tpu_torch.utils.ema import ema_init, ema_update
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
# 6 student steps picked from a 61-point ipndm teacher over 64 warmup seeds
# (the reference's 256, cut to keep the script's time),
# the "dev" metric at coefficient 1.15.  CIFAR-10 at batch 256, the LSUN LDM
# (BASELINE config 4) at batch 64 in bf16 with --afs=False (its --afs=True is
# a known fault of the reference, ROADMAP Queue 3).
GITS_ARGS = ["--dp=True", "--num_steps=6", "--num_steps_tea=61", "--num_warmup=64",
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
        # the substring tests spare the regexes most of the dump's lines
        m = "Function : " in line and re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = (0, set())
        elif fn is not None and "MMA" in line and re.search(r"\bH(G)?MMA\b", line):
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
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
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
    for name in ("predictor_config.json", "stats.jsonl", "predictor.npz", "log.txt"):
        _check(os.path.isfile(os.path.join(run_dir, name)), f"train_amed wrote no {name}")
    _check_log_txt(tag, run_dir, tee.copy.getvalue())
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


def _gn_other_route(route, n, h, w, c, dtype, groups: int = 32):
    """The route that K3 does not take at this shape, where both apply: the
    stream route beside a slab, or the smallest cluster of ``G.CLUSTER_SIZES``
    that holds the slab beside the stream route (None where none does)."""
    elt, hw = torch.empty((), dtype=dtype).element_size(), h * w
    if route.kind == "slab":
        return G._stream_route(n, hw, c, elt, route.vec)
    for size in G.CLUSTER_SIZES:
        if size <= hw:
            slab = G._slab_route(n, hw, c, groups, elt, route.vec, size)
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


def _gn_checks(shapes, wanted: dict, seed: int, groups: int = 32) -> dict:
    """K3 against its plain version at ``shapes``, on its route and, where
    both apply, on the other one (the same gates, timed on the same data);
    returns the kernels-line fields of ``wanted``'s shapes, with the
    route.  ``groups``: 32, or 32 / tp at a tensor-parallel channel slice."""
    g = torch.Generator("cuda").manual_seed(seed)
    entries = {}
    for n, h, w, c, dtype, eps, silu in shapes:
        x = (torch.randn(n, h, w, c, generator=g, device="cuda") * 3 + 1).to(dtype)
        scale = 1 + 0.5 * torch.randn(c, generator=g, device="cuda")
        bias = torch.randn(c, generator=g, device="cuda")
        kw = dict(groups=groups, eps=eps, apply_silu=silu)
        route = G.gn_route(n, h, w, c, dtype, groups=groups)
        other = _gn_other_route(route, n, h, w, c, dtype, groups)
        ref = G.reference_groupnorm_silu(x, scale, bias, **kw)
        tol = GN_TOL[dtype] * max(1.0, ref.float().abs().max().item())
        name = str(dtype).replace("torch.", "")
        errs = {}
        for which, r in (("route", route), ("other", other)):
            if r is None:
                continue
            got = G._launch(x, scale, bias, groups, eps, silu, route=r)
            again = G._launch(x, scale, bias, groups, eps, silu, route=r)
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
            y = F.group_norm(x_nchw, groups, sc, bi, eps)
            return F.silu(y) if silu else y

        fns = {"kernel": lambda: G.groupnorm_silu(x, scale, bias, **kw),
               "plain": lambda: G.reference_groupnorm_silu(x, scale, bias, **kw),
               "library": library}
        if other is not None:
            fns["other"] = lambda: G._launch(x, scale, bias, groups, eps, silu, route=other)
        times = _turns(fns, reps=10, warmup=2)
        bound_ms, bound_by = _groupnorm_bound(n, h, w, c, dtype, silu)
        nbytes = 2 * x.numel() * x.element_size()
        chunks = -(-h * w // route.rows)
        print(f"[K3] [{n}, {h}, {w}, {c}] {name} eps {eps:g} silu {silu} (group size "
              f"{c // groups}): route {_gn_route_text(route, dtype, n, chunks)}; max abs err "
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
    on the same views; returns the K1 fields (by dtype, as ``_k1_checks``)
    and the K2 fields at K2b's shape."""
    k1 = _k1_checks("LDM K1", LDM_K1_SHAPES, _legacy_views, seed=8, reps=5, warmup=2)
    k2b = _k2_checks("LDM K2", LDM_K2_SHAPES, _legacy_views, seed=9)
    _k2_checks("ADM-G K2", ADMG_K2_SHAPES, _legacy_views, seed=13)
    return k1, k2b


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


def phase_sd_flat_kernels(shapes=SD_FLAT_SHAPES, tag: str = "SD K1c/K2c") -> tuple:
    """K1c and K2c against their plain versions at ``SD_FLAT_SHAPES``: K1's
    and K2's gates, K2c two runs bit-identical; CUDA events in turns against
    the plain versions, ``F.scaled_dot_product_attention`` (its backward for
    K2c) and K1 on the same data in the [B, T, H, d] layout.  Returns the
    kernels-line fields of K1c and of K2c at the main shape."""
    g = torch.Generator("cuda").manual_seed(12)
    main = None
    for b, t, d, dtype in shapes:
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
        print(f"[{tag}] flat B={b} T={t} d={d} {name}: out err {err_out:.3g} (tol "
              f"{tol:.3g}), lse err {err_lse:.3g} (tol {LSE_TOL:.3g}); dq err {errs[0]:.3g} "
              f"(tol {tols[0]:.3g}), dk {errs[1]:.3g} (tol {tols[1]:.3g}), dv {errs[2]:.3g} "
              f"(tol {tols[2]:.3g}); two runs bit-identical: K1c {same_fwd}, K2c {same}; K1c "
              f"route {route.kernel}, padded d {route.padded_d}, {route.load}, "
              f"{route.block_q} x {route.block_k} tiles, {route.warps} warps")
        print(f"[{tag}]   K1c {fwd['kernel']:.4f} ms, plain {fwd['plain']:.4f} ms, "
              f"F.scaled_dot_product_attention {fwd['library']:.4f} ms, K1 on the same data as "
              f"[{b // heads}, {t}, {heads}, {d}] views {fwd['K1']:.4f} ms, bound "
              f"{_bound_text('fwd', b, t, 1, d, dtype)}; "
              f"{2 * 2 * b * t * t * d / fwd['kernel'] / 1e9:.2f} TFLOP/s; K2c {_fmt_times(bwd)}")
        print(f"[{tag}]   K2c {_bwd_route_text(A.bwd_route(q, k, v, do), bwd, b, t, 1, d, dtype)}")
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
    """GITS on the LSUN-Bedroom LDM through the CLI (--afs=False), 64 warmup
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
    """What ``v1-5-pruned-emaonly.ckpt`` holds beside the weights that
    sampling loads: the KL encoder and ``quant_conv`` (seeded random at unit
    scale, weights over sqrt(fan_in), f16; phase 45 encodes with them), the
    EMA counters, the DDPM schedule buffers and the text tower's
    position_ids."""
    g = torch.Generator().manual_seed(32)

    def unit(shape):
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        return (torch.randn(shape, generator=g) / math.sqrt(fan_in)).to(SD_CKPT_STORAGE)

    out = {f"first_stage_model.encoder.{k}": unit(shape)
           for k, shape in _kl_encoder_shapes().items()}
    out["first_stage_model.quant_conv.weight"] = unit((8, 8, 1, 1))
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
EVAL_BATCH_IMAGES = 500  # images per data_batch: 2,500 in the dataset zip
# CIFAR-10 samples scored (cut from 10,000 to 5,000, then to 2,500, to keep
# the script's time, above the detector's 2,048 features so that the
# covariances keep full rank; fid calc runs with --no-strict-count, which
# takes any count)
EVAL_SAMPLES = 2500
DETECTOR_BATCH = 250
DETECTOR_CHECK_IMAGES = 16  # card against CPU, 32 px, both preprocessing paths
DETECTOR_TOL = 1e-4  # of max|CPU features|: both sum in f32 in other orders
PRDC_NUM = 2500
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
    tarball (2,500 images from a seed) -> ``cli.dataset_tool`` -> a zip of
    PNGs; a random Inception detector (``_random_inception``) written as a
    torchvision-named torch zip and as an NVIDIA-style graph-order pickle,
    the two imports equal; the detector on the card against its CPU run
    (both preprocessing paths); ``fid ref`` of the dataset, ``fid calc`` of
    the dataset against it (FID ~ 0) and again in the process (bit-equal);
    2,500 samples of phase 31's ``.pkl`` through ``cli.sample`` (ipndm NFE
    5, batch 256, bf16; K1 / K3 counted), ``fid calc`` and ``prdc calc
    --num 2500`` of them, PRDC held to float64; the detector's images/s at
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
        "--no-strict-count", f"--batch={DETECTOR_BATCH}", f"--inception={pth}"]))
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
        f"--inception={pth}", f"--num={EVAL_SAMPLES}", "--no-strict-count"]))
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


# Phases 37-39: SFD distillation.  The students train at full width in f32
# through ``cli.train_sfd`` (or ``make_ldm_train_step`` for the 860M SD
# U-Net), at the CLI's defaults: 4 steps, M=3, the dpmpp teacher (13 points,
# 12 net calls a trajectory), AFS (segment 0 analytic: 2 differentiated net
# calls a trajectory), Adam at 5e-5.
SFD_BATCH = 128  # CIFAR-10 trajectories an iteration (--batch)
SFD_STEPS, SFD_M = 4, 3
SFD_KIMG = 1
SFD_ITERS = math.ceil(SFD_KIMG * 1000 / SFD_BATCH)  # 8
SFD_CHECK_BATCH = 8  # the segment gradient against the all-plain student
SFD_TEA_CALLS = (SFD_M + 1) * (SFD_STEPS - 1)  # dpmpp: one net call a fine step
SFD_STU_CALLS = SFD_STEPS - 2  # differentiated: every segment but AFS's
SFD_K_SHAPES = [(SFD_BATCH, 256, 1, 256, torch.float32)]  # CIFAR-10's main attention level
SFD_GN_SHAPE = (SFD_BATCH, 32, 32, 256, torch.float32, 1e-6, False)  # its 32x32 GroupNorm
# The LSUN LDM student through the CLI: 2 iterations of 512 in microbatches
# of 128, 3 steps and M=1 (5 teacher points, one differentiated call each)
SFD_LDM_ARGS = ["--batch=512", "--batch_gpu=128", "--num_steps=3", "--m=1",
                "--total_kimg=1", "--guidance_type=uncond"]
SFD_LDM_ITERS, SFD_LDM_MICRO = 2, 4
# The 860M SD student: one iteration of 8 trajectories in 2 microbatches of 4
# on caption contexts (the CLI forces an effective 128, 16 rounds); its
# segment gradient against the all-plain U-Net at batch 2
SFD_SD_BATCH, SFD_SD_ACC, SFD_SD_CHECK_BATCH = 8, 2, 2
SFD_SD_K_SHAPES = [(SFD_SD_BATCH // SFD_SD_ACC, 1024, SD_HEADS, 80, torch.float32)]
SFD_SD_FLAT_SHAPES = [(SFD_SD_BATCH // SFD_SD_ACC * SD_HEADS, 4096, 40, torch.float32)]


def _remat_sites(module) -> dict:
    """The K1 and K3 launches that ``remat`` adds to one backward of an EDM
    U-Net: the attention and GroupNorm calls inside its blocks, which the
    backward recomputes."""
    blocks = [m for m in module.modules() if isinstance(m, unets.UNetBlock)]
    return dict(k1=sum(1 for b in blocks if b.num_heads),
                gn=sum(isinstance(m, layers.GroupNorm) for b in blocks for m in b.modules()))


def _segment_grads(denoise, params, x, tc, tn, tea):
    """The gradient of one SFD segment's loss, sum|x + (tn - tc) (x - D(x,
    tc)) / tc - tea| / batch, by ``params`` (the train step's segment)."""
    def grads():
        stu = x + (tn - tc) * (x - denoise(x, tc)) / tc
        return torch.autograd.grad((stu - tea).abs().sum() / x.shape[0], params)

    return grads


def _param_grads_vs_plain(tag: str, grads_fn, patches, want: dict) -> list:
    """``grads_fn``'s weight gradients with the kernels (exactly ``want``'s
    launches) against the same with ``patches``' plain versions, at 1e-4 *
    max over every weight; prints the worst tensor.  Returns the kernels'."""
    _reset_counts()
    got = grads_fn()
    counts = _counts()
    real = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, plain in patches:
            setattr(mod, name, plain)
        ref = grads_fn()
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    scales = [r.abs().max().item() for r in ref]
    err, scale = max(errs), max(scales)
    worst = max(range(len(errs)), key=lambda i: errs[i] / max(scales[i], 1e-30))
    print(f"[{tag}] d loss / d weights ({len(ref)} tensors, "
          f"{sum(r.numel() for r in ref) / 1e6:.1f}M): max {scale:.4g}, kernels vs plain "
          f"attention + GroupNorm max abs err {err:.3g} (tol 1e-4 * max = {1e-4 * scale:.3g}); "
          f"worst tensor {errs[worst]:.3g} of its max {scales[worst]:.3g}; launches {counts}")
    _check(all(torch.isfinite(g).all().item() for g in got), f"{tag}: gradient not finite")
    _check(err <= 1e-4 * scale, f"{tag}: the segment gradient with the kernels disagrees")
    _check(counts == _only(**want), f"{tag}: launches {counts}, expected {want} and no other")
    del ref
    return got


def _sfd_cli(tag: str, argv: list, want: dict, kimg: float) -> tuple:
    """``cli.train_sfd`` as a user runs it (torch's default precision
    flags), the counts set to 0 and the peak memory cleared just before:
    s/kimg, peak memory, finite losses, the run dir's files, exactly
    ``want``'s launches.  Returns (run dir, launches)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start, end = _events()
    t0 = time.perf_counter()
    start.record()
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        run_dir = cli_train_sfd.main([*argv, "--device=cuda"])
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1000
    counts = _counts()
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    losses = [t["Loss/loss"]["mean"] for t in ticks]
    print(f"[{tag}] train_sfd {' '.join(argv[:-1])}: whole CLI call {host_s:.3f} s host "
          f"clock, {device_s:.3f} s CUDA events ({device_s / kimg:.3f} s/kimg); per-tick "
          f"sec/kimg (host clock) {[round(t['sec_per_kimg'], 3) for t in ticks]}; "
          f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"losses per tick {losses}; launches {counts}, expected {want}")
    _check(ticks and all(math.isfinite(x) for x in losses), f"{tag}: losses not finite")
    files = sorted(os.listdir(run_dir))
    _check("training_options.json" in files and any(f.startswith("snapshot-") for f in files),
           f"{tag}: run dir holds {files}")
    _check(counts == _only(**want), f"{tag}: launches of the training")
    _check_log_txt(tag, run_dir, tee.copy.getvalue())
    return run_dir, counts


def _snapshot_moved(tag: str, run_dir: str, fresh) -> None:
    """The run's last snapshot differs from the student it started from."""
    snap = sorted(f for f in os.listdir(run_dir) if f.startswith("snapshot-"))[-1]
    saved = ckpt.flatten_params(ckpt.load_params(os.path.join(run_dir, snap))["params"])
    start = ckpt.flatten_params(fresh)
    moved = max(float(np.abs(v - start[k]).max()) for k, v in saved.items())
    print(f"[{tag}] {snap}: params moved by max abs {moved:.4g} from the start")
    _check(moved > 0, f"{tag}: the student did not move")


def phase_sfd_cifar(workdir: str) -> dict:
    """Phase 37, SFD on CIFAR-10 at full width in f32: (a) one segment's
    weight gradient at batch 8 (unit-scale weights, TF32 off, remat on)
    with K1 + K2 + K3 against the all-plain student at 1e-4 * max, exact
    launches (the recompute's included); remat against plain bit-equal
    (cuDNN deterministic); one primed profile of the segment; K1 / K2 f32
    at the student's [128, 256, 1, 256]; (b) ``cli.train_sfd`` at batch
    128, remat, AFS, 1 kimg: s/kimg, peak memory, losses, exact launches;
    (c) one SFD-v iteration (num_steps drawn as the CLI draws it); (d)
    ``cli.sample`` from the run dir, byte for byte ``generate`` on the
    snapshot's student, with and without ``--skip_tuning``.  Returns the
    kernels-line fields and the training's launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    student = init_params(build_edm_model("cifar10", sigma_min=0.006, remat=True,
                                          device="cuda"))
    _redraw_unit_scale(student, seed=1, device="cuda")
    params = [p for n, p in student.named_parameters() if not absent_from_jax(n)]
    t = torch.tensor(get_schedule(SFD_STEPS, 0.006, 80.0), dtype=torch.float32, device="cuda")
    x = stacked_randn(range(SFD_CHECK_BATCH), (32, 32, 3), device="cuda") * t[1]
    tea = stacked_randn(range(100, 100 + SFD_CHECK_BATCH), (32, 32, 3), device="cuda") * t[2]
    grads_fn = _segment_grads(lambda x, s: student(x, s), params, x, t[1], t[2], tea)
    re = _remat_sites(student.model)
    per = dict(k1=ATTENTION_SITES + re["k1"], dq=ATTENTION_SITES, dkv=ATTENTION_SITES,
               gn=CIFAR_GN_SITES + re["gn"])
    print(f"[SFD CIFAR-10] f32 student, {sum(p.numel() for p in params) / 1e6:.1f}M trained "
          f"parameters, remat: the backward recomputes {re['k1']} K1 and {re['gn']} K3 of its "
          f"{ATTENTION_SITES} and {CIFAR_GN_SITES}; segment 1 (sigma {t[1].item():.4f} -> "
          f"{t[2].item():.4f}) at batch {SFD_CHECK_BATCH}")
    got = _param_grads_vs_plain("SFD CIFAR-10 segment gradient", grads_fn,
                                _plain_net_patches(layers), per)
    torch.backends.cudnn.deterministic = True
    try:
        with_remat = grads_fn()
        student.model.remat = False
        _reset_counts()
        plain = grads_fn()
        plain_counts = _counts()
        student.model.remat = True
    finally:
        torch.backends.cudnn.deterministic = False
    same = all(torch.equal(a, b) for a, b in zip(with_remat, plain))
    print(f"[SFD CIFAR-10] remat vs plain (cudnn.deterministic): bit-equal {same}; without "
          f"remat {plain_counts}")
    _check(same, "SFD CIFAR-10: the gradient with remat differs from the plain one")
    _check(plain_counts == _only(k1=ATTENTION_SITES, dq=ATTENTION_SITES, dkv=ATTENTION_SITES,
                                 gn=CIFAR_GN_SITES), "SFD CIFAR-10: launches without remat")
    del got, with_remat, plain
    _profile(f"SFD segment profile, one f32 segment gradient at batch {SFD_CHECK_BATCH}",
             grads_fn, {"K1": per["k1"], "K2 dQ": per["dq"], "K2 dK/dV": per["dkv"],
                        "K3": per["gn"]}, grad=True)
    del student, params, grads_fn
    torch.cuda.empty_cache()
    k1 = _k1_checks("SFD K1", SFD_K_SHAPES, _qkv_views, seed=60, reps=5, warmup=2)
    k2 = _k2_checks("SFD K2", SFD_K_SHAPES, _qkv_views, seed=61)
    k3 = _gn_checks([SFD_GN_SHAPE], {"SFD": SFD_GN_SHAPE[:5]}, seed=64)["SFD"]

    # (b) the CLI
    it_calls = SFD_TEA_CALLS + SFD_STU_CALLS
    want = dict(k1=SFD_ITERS * (it_calls * ATTENTION_SITES + SFD_STU_CALLS * re["k1"]),
                gn=SFD_ITERS * (it_calls * CIFAR_GN_SITES + SFD_STU_CALLS * re["gn"]),
                dq=SFD_ITERS * SFD_STU_CALLS * ATTENTION_SITES,
                dkv=SFD_ITERS * SFD_STU_CALLS * ATTENTION_SITES)
    run_dir, counts = _sfd_cli("SFD CIFAR-10", [
        "--dataset_name=cifar10", "--model_path=random", f"--batch={SFD_BATCH}",
        f"--total_kimg={SFD_KIMG}", f"--outdir={os.path.join(workdir, 'exps')}"],
        want, SFD_ITERS * SFD_BATCH / 1000)
    fresh = init_params(build_edm_model("cifar10", device="cuda"))
    _snapshot_moved("SFD CIFAR-10", run_dir, params_to_jax(fresh.state_dict()))
    del fresh

    # (c) one SFD-v iteration
    n = int(np.random.RandomState(0).randint(4, 8))
    cfg = SFDConfig(num_steps=n, M=2 if n == 3 else 3, afs=True, use_step_condition=True,
                    sigma_min=0.006)
    student = init_params(build_edm_model("cifar10", use_step_condition=True, sigma_min=0.006,
                                          remat=True, device="cuda"))
    teacher = copy.deepcopy(student).requires_grad_(False)
    for name, p in student.named_parameters():
        p.requires_grad_(not absent_from_jax(name))
    opt = torch.optim.Adam([p for p in student.parameters() if p.requires_grad], lr=5e-5,
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_sfd_train_step(student, teacher, cfg, opt)
    before = {k: v.clone() for k, v in student.state_dict().items() if "step" in k}
    _reset_counts()
    lat = stacked_randn(range(SFD_BATCH), (32, 32, 3), device="cuda")
    start, end = _events()
    start.record()
    losses = step(lat)["loss_per_step"].tolist()
    end.record()
    torch.cuda.synchronize()
    v_counts = _counts()
    tea_calls, stu_calls = (cfg.M + 1) * (n - 1), n - 2
    v_want = _only(k1=(tea_calls + stu_calls) * ATTENTION_SITES + stu_calls * re["k1"],
                   gn=(tea_calls + stu_calls) * CIFAR_GN_SITES + stu_calls * re["gn"],
                   dq=stu_calls * ATTENTION_SITES, dkv=stu_calls * ATTENTION_SITES)
    moved = max((student.state_dict()[k] - v).abs().max().item() for k, v in before.items())
    print(f"[SFD-v CIFAR-10] one iteration at num_steps {n} (M {cfg.M}), batch {SFD_BATCH}: "
          f"{start.elapsed_time(end) / 1000:.3f} s CUDA events; losses {losses}; the "
          f"step-condition modules moved by {moved:.4g}; Adam count {sfd_adam_count(opt)}; "
          f"launches {v_counts}, expected {v_want}")
    _check(all(math.isfinite(x) for x in losses), "SFD-v: losses not finite")
    _check(moved > 0 and sfd_adam_count(opt) == n - 2, "SFD-v: the step condition did not train")
    _check(v_counts == v_want, "SFD-v: launch counts")
    del student, teacher, opt, step
    torch.cuda.empty_cache()

    # (d) sampling from the run dir
    snap = sorted(f for f in os.listdir(run_dir) if f.startswith("snapshot-"))[-1]
    loaded = load_jax_params(init_params(build_edm_model("cifar10", device="cuda")),
                             ckpt.load_params(os.path.join(run_dir, snap))["params"])
    cfg = SolverConfig(solver="euler", num_steps=SFD_STEPS, afs=True)
    nfe = cfg.nfe()
    for skip in (False, True):
        images = generate(bind(loaded, **({"skip_tuning": True} if skip else {})),
                          list(range(BATCH)), (32, 32, 3), cfg, max_batch_size=BATCH,
                          device="cuda")
        _reset_counts()
        _check_cli_pngs(f"SFD sample, skip_tuning {skip}", [
            "--dataset_name=cifar10", f"--model_path={run_dir}", f"--skip_tuning={skip}"],
            images)
        got = _counts()
        print(f"[SFD sample, skip_tuning {skip}] euler NFE {nfe} (restored), f32: launches {got}")
        _check(got == _only(k1=ATTENTION_SITES * nfe, gn=CIFAR_GN_SITES * nfe),
               "SFD sample: launch counts")
    del loaded
    torch.cuda.empty_cache()
    return dict(k1=k1["main"], k2=k2["main"], k3=k3, counts=counts)


def phase_sfd_ldm(workdir: str) -> dict:
    """Phase 38, the LSUN LDM student (274M f32 U-Net) through
    ``cli.train_sfd`` in microbatches (``SFD_LDM_ARGS``; remat off, the
    latent tiers' default): s/kimg, peak memory, exact launches (by (T, H)
    for K2); then ``cli.sample`` from the run dir, its PNGs byte for byte
    ``generate`` + the VQ decode on the snapshot's U-Net.  Returns the
    training's launches and K2's at T=1024."""
    calls = SFD_LDM_ITERS * SFD_LDM_MICRO * (2 * 2 + 1)  # 4 teacher calls, 1 differentiated
    diff = SFD_LDM_ITERS * SFD_LDM_MICRO
    want = dict(k1=calls * LDM_SITES, gn=calls * LDM_GN_SITES, dq=diff * LDM_SITES,
                dkv=diff * LDM_SITES)
    run_dir, counts = _sfd_cli("SFD LDM", [
        f"--dataset_name={LDM}", "--model_path=random", *SFD_LDM_ARGS,
        f"--outdir={os.path.join(workdir, 'exps')}"], want, SFD_LDM_ITERS * 512 / 1000)
    at_1024 = {k: A.flash_attention_bwd_dq.launches_by_shape.get((1024, 14), 0)
               if k == "dq" else A.flash_attention_bwd_dkv.launches_by_shape.get((1024, 14), 0)
               for k in ("dq", "dkv")}
    print(f"[SFD LDM] K2 launches by (T, H): dQ {A.flash_attention_bwd_dq.launches_by_shape}, "
          f"dK/dV {A.flash_attention_bwd_dkv.launches_by_shape}")
    _check(at_1024["dq"] > 0 and at_1024["dkv"] > 0, "SFD LDM: no K2 at T=1024")
    pre, _ = create_model(LDM, "random", device="cuda")
    fresh = convert.ldm_params_to_jax(pre.latent_diffusion.unet.state_dict())
    _snapshot_moved("SFD LDM", run_dir, fresh)
    snap = sorted(f for f in os.listdir(run_dir) if f.startswith("snapshot-"))[-1]
    unet = pre.latent_diffusion.unet
    unet.load_state_dict(convert.ldm_params_from_jax(
        ckpt.load_params(os.path.join(run_dir, snap))["params"], unet.state_dict()))
    cfg = SolverConfig(solver="euler", num_steps=3, afs=True, schedule_type="discrete",
                       schedule_rho=1.0)
    latents = generate(bind(pre), list(range(LDM_BATCH)), LDM_LATENT, cfg,
                       max_batch_size=LDM_BATCH, device="cuda")
    images = pre.latent_diffusion.decode_in_chunks(latents, chunk=DECODE_CHUNK)
    _reset_counts()
    _check_cli_pngs("SFD LDM sample", [f"--dataset_name={LDM}", f"--model_path={run_dir}"],
                    images, batch=LDM_BATCH)
    got = _counts()
    nfe = cfg.nfe()
    want_s = _only(k1=LDM_SITES * nfe, gn=LDM_GN_SITES * nfe
                   + DECODE_GN_SITES * LDM_BATCH // DECODE_CHUNK)
    print(f"[SFD LDM sample] euler NFE {nfe} on the discrete schedule (restored), f32, and the "
          f"decode: launches {got}, expected {want_s}")
    _check(got == want_s, "SFD LDM sample: launch counts")
    del pre, unet
    torch.cuda.empty_cache()
    return dict(counts=counts, at_1024=at_1024)


def phase_sfd_sd(workdir: str) -> dict:
    """Phase 39 (in phase 32's directory: its f16 SD checkpoint, BPE merges
    and captions CSV), the 860M SD student as ``cli.train_sfd`` builds it
    (``_create_latent_student`` on the checkpoint, guidance 7.5, trained at
    1.0): its segment gradient at batch 2 on caption contexts against the
    all-plain U-Net (TF32 off, 1e-4 * max, exact K1 / K1c / K2 / K2c / K3
    launches); K1 / K2 and K1c / K2c f32 at the microbatch's shapes; one
    ``make_ldm_train_step`` iteration at batch 8 in 2 microbatches of 4 on
    caption contexts (s/iteration, peak memory, exact launches); a snapshot
    and its training_options.json naming the checkpoint; ``cli.sample``
    from that run dir (bf16, guidance 7.5, a caption per seed), byte for byte
    ``generate`` + the KL decode on the snapshot's U-Net.  Returns the
    launches and the kernels-line fields."""
    path = os.path.join(workdir, "v1-5-pruned-emaonly.ckpt")
    csv = os.path.join(workdir, "models", "MS-COCO_val2014_30k_captions.csv")
    old_vocab = os.environ.get("CLIP_BPE_VOCAB")
    os.environ["CLIP_BPE_VOCAB"] = os.path.join(workdir, "merges.txt")
    try:
        return _sfd_sd(workdir, path, csv)
    finally:
        if old_vocab is None:
            os.environ.pop("CLIP_BPE_VOCAB", None)
        else:
            os.environ["CLIP_BPE_VOCAB"] = old_vocab


def _sfd_sd(workdir: str, path: str, csv: str) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pre, student = cli_train_sfd._create_latent_student(SD, path, "cfg", SD_GUIDANCE, False,
                                                        "cuda")
    ld = pre.latent_diffusion
    print(f"[SFD SD] the student from {path}: {time.perf_counter() - t0:.3f} s host clock; "
          f"{sum(p.numel() for _, p in student.named) / 1e6:.1f}M trained parameters; text "
          f"tower bound: {ld.cond_stage_model is not None}")
    _check(ld.cond_stage_model is not None, "SFD SD: no text encoder")
    context_fn = make_caption_context_fn(ld, csv, SFD_SD_BATCH, seed=0)
    ctx = torch.as_tensor(context_fn(0), device="cuda")
    train_pre = dataclasses.replace(pre, guidance_rate=1.0)
    train_pre.sigma_min, train_pre.sigma_max = pre.sigma_min, pre.sigma_max
    t = torch.tensor(get_schedule(SFD_STEPS, pre.sigma_min, pre.sigma_max),
                     dtype=torch.float32, device="cuda")
    n = SFD_SD_CHECK_BATCH
    x = stacked_randn(range(n), SD_LATENT, device="cuda") * t[1]
    tea = stacked_randn(range(100, 100 + n), SD_LATENT, device="cuda") * t[2]
    unet = student.module
    params = [p for _, p in student.named]
    grads_fn = _segment_grads(lambda xs, s: train_pre.denoise_with(
        lambda a, b, c: unet(a, b, c), xs, s, condition=ctx[:n]), params, x, t[1], t[2], tea)
    gn = _gn_sites(unet)
    mh = SD_SITES - SD_FLAT_SITES
    got = _param_grads_vs_plain("SFD SD segment gradient", grads_fn, _plain_net_patches(adm),
                                dict(k1=mh, k1c=SD_FLAT_SITES, gn=gn, dq=mh, dkv=mh,
                                     dqc=SD_FLAT_SITES, dkvc=SD_FLAT_SITES))
    del got, grads_fn
    torch.cuda.empty_cache()
    k1 = _k1_checks("SFD SD K1", SFD_SD_K_SHAPES, _sd_views, seed=62, reps=5, warmup=2)
    k2 = _k2_checks("SFD SD K2", SFD_SD_K_SHAPES, _sd_views, seed=63)
    k1c, k2c = phase_sd_flat_kernels(SFD_SD_FLAT_SHAPES, "SFD SD K1c/K2c")

    # one iteration at batch 8 in 2 microbatches, the CLI's optimizer and schedule
    torch.backends.cudnn.allow_tf32 = True
    cfg = SFDConfig(num_steps=SFD_STEPS, M=SFD_M, afs=True, sigma_min=0.006)
    opt = torch.optim.Adam(params, lr=5e-5, betas=(0.9, 0.999), eps=1e-8)
    step = make_sfd_ldm_train_step(unet, student.teacher, pre, cfg, opt, n_acc=SFD_SD_ACC)
    lat = stacked_randn(range(SFD_SD_BATCH), SD_LATENT, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start, end = _events()
    start.record()
    losses = step(lat, ctx)["loss_per_step"].tolist()
    end.record()
    torch.cuda.synchronize()
    counts = _counts()
    calls = SFD_SD_ACC * (SFD_TEA_CALLS + SFD_STU_CALLS)
    diff = SFD_SD_ACC * SFD_STU_CALLS
    want = _only(k1=calls * mh, k1c=calls * SD_FLAT_SITES, gn=calls * gn, dq=diff * mh,
                 dkv=diff * mh, dqc=diff * SD_FLAT_SITES, dkvc=diff * SD_FLAT_SITES)
    print(f"[SFD SD] one iteration, batch {SFD_SD_BATCH} in {SFD_SD_ACC} microbatches, f32, "
          f"caption contexts: {start.elapsed_time(end) / 1000:.3f} s CUDA events; "
          f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"losses {losses}; Adam count {sfd_adam_count(opt)}; launches {counts}, expected {want}")
    _check(all(math.isfinite(x) for x in losses), "SFD SD: losses not finite")
    _check(counts == want, "SFD SD: launch counts of the iteration")
    run_dir = os.path.join(workdir, "exps", "00000-ms_coco-4step-dpmpp3")
    os.makedirs(run_dir)
    ckpt.save_config(os.path.join(run_dir, "training_options.json"), dict(
        dataset_name=SD, batch=SFD_SD_BATCH, lr=5e-5, total_kimg=1, seed=0, model_path=path,
        guidance_type="cfg", guidance_rate=SD_GUIDANCE, **dataclasses.asdict(cfg)))
    # the snapshot's params and cur_nimg, as save_snapshot writes them less
    # Adam's moments (6.9 GB more to write; the CPU tests hold the latent
    # snapshot's moments and resume), which sampling does not read
    trained = convert.ldm_params_to_jax(unet.state_dict())
    _, save_s = _host_timed(lambda: ckpt.save_params(
        os.path.join(run_dir, "snapshot-000000.npz"), trained,
        meta={"cur_nimg": np.asarray([SFD_SD_BATCH])}))
    print(f"[SFD SD] wrote the snapshot's params: {save_s:.3f} s host clock")
    del pre, ld, student, unet, params, opt, step
    torch.cuda.empty_cache()

    # sampling from the run dir: bf16, guidance 7.5, a caption per seed
    torch.backends.cudnn.allow_tf32 = True
    pre = build_ldm_model(SD, path, guidance_rate=SD_GUIDANCE, dtype=torch.bfloat16,
                          device="cuda")
    ld = pre.latent_diffusion
    ld.unet.load_state_dict(convert.ldm_params_from_jax(trained, ld.unet.state_dict()))
    del trained
    seeds = list(range(SD_BATCH))
    captions = load_captions(csv)
    rows = ld.encode_in_chunks([captions[s % len(captions)] for s in seeds])
    uc = ld.get_learned_conditioning([""])
    cfg_s = SolverConfig(solver="euler", num_steps=SFD_STEPS, afs=True,
                         schedule_type="discrete", schedule_rho=1.0)
    latents = generate(bind(pre, unconditional_condition=uc), seeds, SD_LATENT, cfg_s,
                       max_batch_size=SD_BATCH, device="cuda", per_seed_cond=rows)
    images = ld.decode_in_chunks(latents, chunk=DECODE_CHUNK)
    nfe = cfg_s.nfe()
    want_s = _only(k1=SD_SITES * nfe, gn=_gn_sites(ld.unet) * nfe + _gn_sites(ld.first_stage))
    del pre, ld
    torch.cuda.empty_cache()
    _reset_counts()
    with contextlib.chdir(workdir):  # the captions CSV in ./models
        _check_cli_pngs("SFD SD sample", [f"--dataset_name={SD}", "--model_path=0",
                                          "--bf16=True"], images, batch=SD_BATCH)
    got = _counts()
    print(f"[SFD SD sample] euler NFE {nfe} (restored), guidance {SD_GUIDANCE}, bf16, and the "
          f"KL decode: launches {got}, expected {want_s}")
    _check(got == want_s, "SFD SD sample: launch counts")
    return dict(counts=counts, k1=k1["main"], k2=k2["main"], k1c=k1c, k2c=k2c)


# Phases 40-42: the CLIP score, the trajectory analyzer and the AMED export.
# Phase 40 runs the reference's CLIP detector, OpenCLIP ViT-g-14
# (laion2b_s34b_b88k; open_clip's model_configs/ViT-g-14.json) at its full
# width from a seeded checkpoint in open_clip's layout.
VITG = OpenCLIPConfig(embed_dim=1024, image_size=224, patch_size=14, vision_width=1408,
                      vision_layers=40, vision_heads=16, vision_mlp_dim=6144, text_width=1024,
                      text_layers=24, text_heads=16, text_mlp_dim=4096, vocab_size=49408,
                      context_length=77)
CLIP_CKPT_STORAGE = torch.float16  # open_clip_pytorch_model.bin's
CLIP_IMAGES = 128  # images scored by each CLI run (cut from 256 for the script's time)
CLIP_BATCH = 64  # cli.clip_score's default --batch
CLIP_CHECK_N = 4  # images and prompts of the f32-vs-float64 gate
# Tolerance of the f32 towers against the same modules in float64, relative
# to max|float64 embedding|: f32 sums of up to 6144 terms carried through 40
# pre-LN blocks came to 1.3e-6 on an H100 (PERF.md); a wrong operation
# shows at order one.
CLIP_TOL = 1e-4
# Phase 41: the analyzer's defaults on the full-width CIFAR-10 net, f32
ANALYZE_BATCH = 16
ANALYZE_STEPS = 21  # ipndm: 20 net calls a trajectory
# 4 batches: the whole run must stay inside its time limit, and this run
# is its longest host-bound loop (36 ms a batch-16 forward)
ANALYZE_IMAGES = 64
EXTEND_STEPS = 101  # analyze_extend: euler, 100 net calls (its default 201, cut)
ANALYZE_TOL = 1e-5  # --num_images against the per-sample statistics in float64, of max
ANALYZE_K_SHAPE = (ANALYZE_BATCH, 256, 1, 256, torch.float32)  # CIFAR-10's attention level
ANALYZE_GN_SHAPE = (ANALYZE_BATCH, 32, 32, 256, torch.float32, 1e-6, False)  # its 32x32 GN


def _vitg_state_dict(seed: int) -> dict:
    """ViT-g-14's open_clip state_dict (names and shapes of ``OpenCLIP(VITG)``)
    drawn on the card from ``seed`` and stored in f16: matrices at 1 /
    sqrt(fan_in), LayerNorm scales 1 + 0.02 N, biases and embeddings 0.02 N,
    the logit scale ln(1 / 0.07)."""
    g = torch.Generator("cuda").manual_seed(seed)
    out = {}
    for k, v in OpenCLIP(VITG, device="meta").state_dict().items():
        shape = tuple(v.shape)
        if k == "logit_scale":
            val = torch.tensor(math.log(1 / 0.07))
        elif ("ln_" in k) and k.endswith(".weight"):
            val = 1 + 0.02 * torch.randn(shape, generator=g, device="cuda")
        elif len(shape) >= 2 and "embedding" not in k:
            fan_in = shape[0] if k.endswith(("proj", "projection")) else math.prod(shape[1:])
            val = torch.randn(shape, generator=g, device="cuda") / math.sqrt(fan_in)
        else:
            val = 0.02 * torch.randn(shape, generator=g, device="cuda")
        out[k] = val.to("cpu", CLIP_CKPT_STORAGE)
    return out


def _tower_flops(width: int, layers: int, mlp: int, tokens: int) -> int:
    """FLOPs of one sample through a pre-LN transformer tower (2 a
    multiply-add): the qkv, attention, output and MLP products."""
    per_layer = (2 * tokens * width * 3 * width + 2 * 2 * tokens * tokens * width
                 + 2 * tokens * width * width + 2 * 2 * tokens * width * mlp)
    return layers * per_layer


def _vitg_flops() -> dict:
    c = VITG
    grid = (c.image_size // c.patch_size) ** 2
    vision = (_tower_flops(c.vision_width, c.vision_layers, c.vision_mlp_dim, grid + 1)
              + 2 * grid * 3 * c.patch_size ** 2 * c.vision_width
              + 2 * c.vision_width * c.embed_dim)
    text = (_tower_flops(c.text_width, c.text_layers, c.text_mlp_dim, c.context_length)
            + 2 * c.text_width * c.embed_dim)
    return {"vision": vision, "text": text}


def _write_pngs(outdir: str, n: int, size: int, seed: int) -> None:
    """n seeded RGB PNGs of size x size: 64 x 64 noise blown up by 8x8
    blocks (so that they encode quickly), resized on the way in by the
    score's bicubic."""
    os.makedirs(outdir)
    rng = np.random.RandomState(seed)
    for i in range(n):
        small = rng.randint(0, 256, (size // 8, size // 8, 3), dtype=np.uint8)
        with open(os.path.join(outdir, f"{i:06d}.png"), "wb") as f:
            f.write(encode_png(small.repeat(8, 0).repeat(8, 1)))


def _clip_score_cli(tag: str, images: str, captions: str, ckpt_path: str) -> float:
    """``cli.clip_score`` as a user runs it: its score and host seconds."""
    _reset_counts()
    score, cli_s = _host_timed(lambda: cli_clip_score.main([
        f"--images={images}", f"--captions={captions}", f"--checkpoint={ckpt_path}",
        f"--batch={CLIP_BATCH}", "--device=cuda"]))
    print(f"[{tag}] cli.clip_score on {CLIP_IMAGES} pairs at batch {CLIP_BATCH}: CLIP score "
          f"{score:.4f}, {cli_s:.3f} s host clock with the load")
    _check(math.isfinite(score) and -100 <= score <= 100, f"{tag}: score {score!r}")
    _check(_counts() == _only(), f"{tag}: the towers launched a kernel of the repo")
    return score


def phase_clip_score(workdir: str, cifar_pngs: str) -> dict:
    """Phase 40 (after phase 32, in its directory): the CLIP score at the
    width of OpenCLIP ViT-g-14.  A seeded open_clip state_dict (f16,
    ``torch.save``) loaded through ``make_openclip_encoders`` (host seconds,
    MB/s, every tensor bit-equal to the file's); both towers in f32 (TF32
    off) on 4 images and 4 prompts against the same modules in float64 on
    the card, within CLIP_TOL; ``cli.clip_score`` on 256 seeded 512 x 512
    PNGs (the downscale) and on 256 of phase 33's 32 x 32 CIFAR-10 samples
    (the upscale) against a 256-row captions CSV in phase 32's form, tokenised
    by phase 32's vocab; the score of the same pairs in this process (equal
    to the CLI's), images/s, each tower's device time at batch 64 against
    its f32 bound, and the attention's share of the vision tower (T=257,
    d=88)."""
    path = os.path.join(workdir, "open_clip_pytorch_model.bin")
    captions_csv = os.path.join(workdir, "clip_captions.csv")
    vocab = os.path.join(workdir, "merges.txt")  # phase 32's
    captions = _captions(CLIP_IMAGES)
    with open(captions_csv, "w") as f:
        f.write("image_id,id,text\n" + "".join(f'{i},{i},"{c}"\n' for i, c in enumerate(captions)))
    t0 = time.perf_counter()
    sd = _vitg_state_dict(seed=40)
    torch.save(sd, path)
    n_params = sum(v.numel() for v in sd.values())
    print(f"[CLIP] ViT-g-14 open_clip state_dict: {len(sd)} tensors, {n_params / 1e6:.1f}M "
          f"params in {CLIP_CKPT_STORAGE} storages, {os.path.getsize(path) / 1e9:.3f} GB, drawn "
          f"and written in {time.perf_counter() - t0:.3f} s")

    old_vocab = os.environ.get("CLIP_BPE_VOCAB")
    os.environ["CLIP_BPE_VOCAB"] = vocab
    try:
        mb = os.path.getsize(path) / 1e6
        (image_fn, text_fn), load_s = _host_timed(lambda: make_openclip_encoders(path))
        print(f"[CLIP] make_openclip_encoders of {mb:.2f} MB: {load_s:.3f} s host clock, "
              f"{mb / load_s:.1f} MB/s")
        model = image_fn.__self__.model
        got = model.state_dict()
        same = sum(torch.equal(got[k], v.cuda().float()) for k, v in sd.items())
        _check(model.cfg == VITG and same == len(sd),
               f"CLIP: config {model.cfg}, {same} of {len(sd)} tensors equal to the file's")
        del got, sd

        # the towers in f32 against the same modules in float64
        images = np.random.RandomState(41).randint(0, 256, (CLIP_CHECK_N, 512, 512, 3),
                                                   dtype=np.uint8)
        prompts = _captions(CLIP_CHECK_N, seed=41)
        e_img, e_txt = image_fn(images), text_fn(prompts)
        ids = torch.as_tensor(image_fn.__self__.tokenizer(prompts)).cuda()
        m64 = copy.deepcopy(model).double()
        with torch.no_grad():
            r_img = m64.encode_image(clip_preprocess(images, VITG.image_size).double())
            r_txt = m64.encode_text(ids)
        del m64
        torch.cuda.empty_cache()
        errs = {name: ((got.double() - ref).abs().max() / ref.abs().max()).item()
                for name, got, ref in (("image", e_img, r_img), ("text", e_txt, r_txt))}
        print(f"[CLIP] f32 towers (TF32 off) against float64 on the card, {CLIP_CHECK_N} images "
              f"(512 px) and {CLIP_CHECK_N} prompts: max abs err of max|embedding| image "
              f"{errs['image']:.3g}, text {errs['text']:.3g} (tol {CLIP_TOL:g}); shapes "
              f"{tuple(e_img.shape)}, {tuple(e_txt.shape)}")
        _check(e_img.shape == e_txt.shape == (CLIP_CHECK_N, VITG.embed_dim)
               and max(errs.values()) <= CLIP_TOL, f"CLIP towers vs float64: {errs}")

        # each tower's device time at the CLI's batch, the attention's share
        g = torch.Generator("cuda").manual_seed(42)
        pixels = torch.randn(CLIP_BATCH, 224, 224, 3, generator=g, device="cuda")
        ids64 = torch.as_tensor(image_fn.__self__.tokenizer(_captions(CLIP_BATCH))).cuda()
        t_vis = (VITG.image_size // VITG.patch_size) ** 2 + 1
        qkv = torch.randn(3, CLIP_BATCH, t_vis, VITG.vision_width, generator=g, device="cuda")
        with torch.no_grad(), exact_f32():
            times = _turns({"vision": lambda: model.encode_image(pixels),
                            "text": lambda: model.encode_text(ids64),
                            "attention": lambda: openclip_attention(*qkv, VITG.vision_heads)},
                           reps=3, warmup=1)
        flops = _vitg_flops()
        bound = {k: CLIP_BATCH * flops[k] / PEAK_FLOPS[torch.float32] * 1e3 for k in flops}
        share = VITG.vision_layers * times["attention"] / times["vision"]
        for k in ("vision", "text"):
            print(f"[CLIP] {k} tower at batch {CLIP_BATCH}, f32 (TF32 off): {times[k]:.4f} ms "
                  f"(CUDA events), {flops[k] / 1e9:.3f} GFLOP a sample from its shapes, bound "
                  f"{bound[k]:.4f} ms (operations, 67 TFLOP/s f32), {bound[k] / times[k]:.3f} "
                  f"of it; {CLIP_BATCH / times[k] * 1e3:.1f} samples/s")
        print(f"[CLIP] vision attention (plain matmul + softmax) at [{CLIP_BATCH}, {t_vis}, "
              f"{VITG.vision_heads} heads of {VITG.vision_width // VITG.vision_heads}]: "
              f"{times['attention']:.4f} ms a layer, x {VITG.vision_layers} = {share:.4f} of the "
              f"vision tower's time")

        # the CLI: the downscale (512 px) and the upscale (CIFAR-10's 32 px)
        big = os.path.join(workdir, "clip_images_512")
        _write_pngs(big, CLIP_IMAGES, 512, seed=43)
        scores = {"512 px": _clip_score_cli("CLIP 512 px", big, captions_csv, path),
                  "32 px": _clip_score_cli("CLIP 32 px", cifar_pngs, captions_csv, path)}
        ds = ImageFolderDataset(big)
        imgs = np.stack([ds[i][0] for i in range(CLIP_IMAGES)])
        batches = [(imgs[s:s + CLIP_BATCH], captions[s:s + CLIP_BATCH])
                   for s in range(0, CLIP_IMAGES, CLIP_BATCH)]
        clip_score(image_fn, text_fn, batches[:1])  # warm-up
        here, score_s = _host_timed(lambda: clip_score(image_fn, text_fn, batches))
        print(f"[CLIP] the 512 px pairs scored in this process: {here:.6f} ({score_s:.3f} s host "
              f"clock for {CLIP_IMAGES} pairs: {CLIP_IMAGES / score_s:.1f} images/s with the "
              f"preprocessing and the text tower, decoded PNGs in memory)")
        # the CLI loads its own copy of the towers: cuBLAS may sum in another order
        _check(abs(here - scores["512 px"]) <= 1e-3, "CLIP: the CLI's score differs")
    finally:
        if old_vocab is None:
            os.environ.pop("CLIP_BPE_VOCAB", None)
        else:
            os.environ["CLIP_BPE_VOCAB"] = old_vocab
    del model, image_fn, text_fn
    torch.cuda.empty_cache()
    return dict(scores=scores, images_per_s=CLIP_IMAGES / score_s, times=times, bound=bound,
                attention_share=share, load_s=load_s, errs=errs)


def _finite_report(tag: str, report: dict) -> None:
    bad = [k for k, v in report.items()
           if not isinstance(v, str) and not np.isfinite(np.asarray(v, np.float64)).all()]
    print(f"[{tag}] " + ", ".join(
        f"{k} {np.round(np.asarray(v, np.float64).mean(), 6)!r}" if not isinstance(v, str)
        else f"{k} {v}" for k, v in report.items()))
    _check(not bad, f"{tag}: not finite: {bad}")


def _analyzer_cli(tag: str, fn, argv: list, want: dict):
    _reset_counts()
    out, host_s = _host_timed(lambda: fn([*argv, "--device=cuda"]))
    counts = _counts()
    print(f"[{tag}] {' '.join(argv)}: {host_s:.3f} s host clock; launches {counts}, "
          f"expected {want}")
    _check(counts == _only(**want), f"{tag}: launch counts")
    _finite_report(tag, out)
    return out, counts


def phase_analyzer(workdir: str) -> dict:
    """Phase 41: the trajectory analyzer on the full-width CIFAR-10 net in
    f32, its random weights redrawn at unit scale and saved as a checkpoint
    file that the CLIs load (the init's zero-init convs make D = c_skip * x,
    whose trajectories are straight lines: curvature 0): ``analyze_trajectories``
    at 21 steps and batch 16, then with ``--num_images=64`` (its statistics
    against the per-sample statistics of each batch's trajectory, taken here
    from the trajectories the CLI hands to ``batch_stat_sums`` and combined
    in float64 on the host), ``analyze_extend --mode=sampling``
    (euler, 101 steps) and ``--mode=low_rank_mog`` (no net: no kernel); every
    report finite, exact K1 / K3 launches; K1 and K3 in f32 at the
    analyzer's shapes against their plain versions.  Returns the launches
    and the kernels' fields."""
    module, _ = create_model("cifar10", "random", device="cuda")
    with torch.no_grad():
        _redraw_unit_scale(module, seed=41, device="cuda")
    net = os.path.join(workdir, "cifar10-unit-scale.pt")
    torch.save(module.state_dict(), net)
    per_call = dict(k1=ATTENTION_SITES, gn=CIFAR_GN_SITES)
    base = [f"--model_path={net}", f"--num_steps={ANALYZE_STEPS}", f"--batch={ANALYZE_BATCH}"]
    calls = ANALYZE_STEPS - 1
    n_batches = math.ceil(ANALYZE_IMAGES / ANALYZE_BATCH)
    total = dict(k1=0, gn=0)
    runs = [("analyze_trajectories", cli_analyze_trajectories.main,
             [*base, f"--outdir={os.path.join(workdir, 'traj')}"], calls),
            ("analyze_trajectories --num_images", cli_analyze_trajectories.main,
             [*base, f"--num_images={ANALYZE_IMAGES}",
              f"--outdir={os.path.join(workdir, 'traj_mp')}"], calls * n_batches),
            ("analyze_extend sampling", cli_analyze_extend.main,
             ["--mode=sampling", f"--model_path={net}", "--solver=euler",
              f"--num_steps={EXTEND_STEPS}",
              f"--batch={ANALYZE_BATCH}", f"--outdir={os.path.join(workdir, 'ext')}"],
             EXTEND_STEPS - 1),
            ("analyze_extend low_rank_mog", cli_analyze_extend.main,
             ["--mode=low_rank_mog", f"--outdir={os.path.join(workdir, 'ext_mog')}"], 0)]
    # the --num_images run's per-sample statistics, from the trajectories
    # the CLI sums, kept in float64 on the host
    fns = {"magnitude": analysis.trajectory_magnitude, "deviation": trajectory_deviation,
           "segment_lengths": trajectory_lengths, "direction_cosine": analysis.direction_cosines,
           "curvature": trajectory_curvature}
    per_sample = {k: [] for k in [*fns, "denoised_magnitude"]}
    batch_stat_sums = cli_analyze_trajectories.batch_stat_sums

    def recording(xs, eps, t_steps):
        for k, stat in fns.items():
            per_sample[k].append(stat(xs).double().cpu())
        per_sample["denoised_magnitude"].append(analysis.trajectory_magnitude(
            analysis.denoised_trajectory(xs, eps, t_steps)).double().cpu())
        return batch_stat_sums(xs, eps, t_steps)

    reports = {}
    for tag, fn, argv, n_calls in runs:
        want = _per_calls(per_call, n_calls) if n_calls else {}
        if "--num_images" in tag:
            cli_analyze_trajectories.batch_stat_sums = recording
        try:
            reports[tag], counts = _analyzer_cli(tag, fn, argv, want)
        finally:
            cli_analyze_trajectories.batch_stat_sums = batch_stat_sums
        for k in total:
            total[k] += counts[k]
    report = reports["analyze_trajectories --num_images"]
    combined = {k: torch.cat(v).mean(0).numpy() for k, v in per_sample.items()}
    errs = {k: float(np.abs(np.asarray(report[k]) - v).max() / np.abs(v).max())
            for k, v in combined.items()}
    print(f"[analyzer] --num_images={ANALYZE_IMAGES} statistics against the per-sample ones of "
          f"its {len(per_sample['magnitude'])} batches combined in float64 on the host: max err "
          f"of max {max(errs.values()):.3g} (tol {ANALYZE_TOL:g}); {errs}")
    _check(len(per_sample["magnitude"]) == math.ceil(ANALYZE_IMAGES / ANALYZE_BATCH)
           and sum(len(v) for v in per_sample["magnitude"]) == ANALYZE_IMAGES
           and max(errs.values()) <= ANALYZE_TOL, "analyzer: --num_images statistics differ")
    del module
    torch.cuda.empty_cache()
    print(f"[analyzer] launches over the four CLI runs: K1 {total['k1']}, K3 {total['gn']}")

    k1 = _k1_checks("analyzer K1", [ANALYZE_K_SHAPE], _qkv_views, seed=70, reps=10, warmup=2)
    k3 = _gn_checks([ANALYZE_GN_SHAPE], {"analyzer": ANALYZE_GN_SHAPE[:5]}, seed=71)["analyzer"]
    return dict(counts=total, k1=k1["main"], k3=k3)


def phase_amed_export(workdir: str) -> dict:
    """Phase 42 (after phase 8, in its directory): ``export_amed_schedule``
    of phase 8's saved predictor over the full-width CIFAR-10 net (16 probe
    seeds, f32; two K1 / K3 forwards a segment): every r in (0, 1), every
    t_mid between its two sigmas, the interleaved lists, and
    ``save_amed_schedule``'s JSON read back equal.  (The log.txt of every
    ``train_amed`` / ``train_sfd`` run is checked where the run is.)"""
    run_dir = glob.glob(os.path.join(workdir, "exps", "*-cifar10-*"))[0]
    cfg = ckpt.load_config(os.path.join(run_dir, "predictor_config.json"))
    cfg = AMEDConfig(**{k: v for k, v in cfg.items() if k in AMEDConfig.__dataclass_fields__})
    pred = load_jax_params(predictor_from_config(cfg, device="cuda"),
                           ckpt.load_params(os.path.join(run_dir, "predictor.npz"))["params"])
    module, _ = create_model("cifar10", "random", device="cuda")
    _reset_counts()
    sched, export_s = _host_timed(lambda: export_amed_schedule(
        pred.eval(), bind_with_bottleneck(module), (32, 32, 3), cfg.num_steps, cfg.sigma_min,
        cfg.sigma_max, schedule_type=cfg.schedule_type, schedule_rho=cfg.schedule_rho))
    counts = _counts()
    calls = 2 * (cfg.num_steps - 1)
    want = _only(k1=ATTENTION_SITES * calls, gn=CIFAR_GN_SITES * calls)
    t, r, t_mid = np.asarray(sched["sigmas"]), np.asarray(sched["r"]), np.asarray(sched["t_mid"])
    path = os.path.join(workdir, "amed_schedule.json")
    save_amed_schedule(path, sched)
    with open(path) as f:
        back = json.load(f)
    print(f"[AMED export] {run_dir}: {export_s:.3f} s host clock; sigmas {t.tolist()}, r "
          f"{r.tolist()}, t_mid {t_mid.tolist()}, scale_dir {sched['scale_dir']}, scale_time "
          f"{sched['scale_time']}; launches {counts}, expected {want}")
    _check(np.all((r > 0) & (r < 1)) and np.all((t[1:] < t_mid) & (t_mid < t[:-1])),
           "AMED export: r outside (0, 1) or a midpoint outside its step")
    _check(len(sched["scale_dirs_interleaved"]) == 2 * cfg.num_steps - 1 and back == sched,
           "AMED export: the interleaved lists or the saved JSON")
    _check(counts == want, "AMED export: launch counts")
    del module, pred
    torch.cuda.empty_cache()
    return counts


class _Tee(io.TextIOBase):
    """A stdout that writes through to another and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.copy = stream, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def _check_log_txt(tag: str, run_dir: str, printed: str) -> None:
    """The run's log.txt holds every line the CLI printed from "Run dir:" on,
    in order."""
    with open(os.path.join(run_dir, "log.txt")) as f:
        logged = f.read().splitlines()
    lines = printed.splitlines()
    lines = lines[next(i for i, line in enumerate(lines) if line.startswith("Run dir:")):]
    rest = iter(logged)
    held = all(any(line == got for got in rest) for line in lines)
    print(f"[{tag}] log.txt: {len(logged)} lines, holding the {len(lines)} lines the CLI "
          f"printed: {held}")
    _check(held, f"{tag}: log.txt lacks lines the CLI printed")


# Phase 43: data and sequence parallelism.  Two processes share the one card
# over gloo (NCCL refuses two ranks on one card), each on cuda:0; one
# process under NCCL runs the sampling CLI at world size 1.
P43_SEEDS = 256  # cut from 512 for the script's time
P43_CIFAR_ARGS = ["--dataset_name=cifar10", "--model_path=random", "--solver=ipndm",
                  "--num_steps=6", "--bf16=True", f"--seeds=0-{P43_SEEDS - 1}",
                  f"--batch={BATCH}", "--device=cuda", "--subdirs=False"]
# (B, T, H, d, dtype) of the ring checks over 2 ranks: SD's 64x64 level and
# CIFAR-10's 16x16 level; each rank's tile is [B, T/2, H, d]
P43_RING_SHAPES = [(2, 4096, SD_HEADS, 40, torch.bfloat16), (2, 4096, SD_HEADS, 40, torch.float32),
                   (BATCH, 256, 1, 256, torch.bfloat16), (BATCH, 256, 1, 256, torch.float32)]
P43_SD_BATCH = 2  # images of the --sp=2 SD runs: 4 a guided U-Net call
P43_SD_STEPS = 6  # ipndm at NFE 5
# the ring's ledger over 2 ranks at SD's levels (T=64 stays local)
P43_SD_RANG = {(2 * P43_SD_BATCH, t, SD_HEADS, d): n * (P43_SD_STEPS - 1)
               for t, d, n in SD_LEVELS if t >= 256}
# In bf16 the random SD v1.5 at guidance 7.5 carries any difference in the
# attention's rounding to images many uint8 levels apart (18 levels on an
# H100 between --sp=2 and --sp=1, and as many with the plain attention in
# place of K1; PERF.md), so the one-level gate of the JAX
# test_sample_cli_sp holds in f32, TF32 off.  In bf16 one call on one input
# is held instead: SD's guided D at the first step, and the ImageNet-256
# classifier's gradient (the ring's backward, K2).  The ring's output there
# may move at most P43_ONE_CALL_FACTOR times as far (mean |difference| over
# mean |value|) from the --sp=1 call's as the plain attention in place of
# K1 moves it (the version that K1's gate holds K1 to), and the same call
# with a planted fault (each visiting block dropped from the combine) must
# move further than that.  Read on an H100 (PERF.md): the ring 1.013 (SD)
# and 1.029 (the classifier) times the plain attention's distance, a
# dropped block 2.27 and 9.16 times, an unweighted combine 1.02 and 3.07
# times (random SD's attention at sigma_max weighs its two halves nearly
# alike; the ring checks above hold the combine at K1's tolerance).
P43_ONE_CALL_FACTOR = 1.5
# One AMED iteration on CIFAR-10 at batch 128 in microbatches of 64 (cut
# from 512 in 256s for the script's time), f32, TF32 off, data
# parallel over 2 ranks (32 rows a rank) against one process.  The runs sum
# the rows of a microbatch in other orders and cuDNN may pick other
# algorithms at 32 rows than at 64; Adam scales each gradient by its own
# size.
P43_AMED_BATCH, P43_AMED_BATCH_GPU = 128, 64
P43_AMED_TOL = 1e-4
# One AMED iteration on CIFAR-10 with --sp=2 (the ring inside the train
# step: K1 forward, K2 backward at the T=256 sites; T=64 stays local), at
# the batch whose [64, 128, 1, 256] blocks the gloo transport moves in
# tens of ms; against one process at the same batch, P43_AMED_TOL
P43_SP_AMED_BATCH = 64
# ImageNet-256 with classifier guidance, bf16, --sp=2: the U-Net's and the
# classifier's T=1024 / 256 attention rings, and the classifier's gradient
# runs K2 in bf16 on the ring's tiles
P43_CG_BATCH = 2
P43_CG_SIGMA = 2.5
P43_CG_RANG = {(P43_CG_BATCH, t, h, 64) for levels in (ADM_UNET_LEVELS, ADM_CLS_LEVELS)
               for t, h in levels if t >= 256}
# K1 / K2 at the ring's tiles on the paths above (the first of each dtype
# gives the kernels-line fields), and at SD's 64x64 tile beside the whole T
P43_TILE_K1 = [(2, 2048, SD_HEADS, 40, torch.bfloat16), (2, 2048, SD_HEADS, 40, torch.float32),
               (2, 4096, SD_HEADS, 40, torch.bfloat16), (2, 4096, SD_HEADS, 40, torch.float32)]
P43_TILE_K2 = [(P43_SP_AMED_BATCH, 128, 1, 256, torch.float32),
               (P43_CG_BATCH, 512, 4, 64, torch.bfloat16),
               (2, 2048, SD_HEADS, 40, torch.float32), (2, 2048, SD_HEADS, 40, torch.bfloat16),
               (2, 4096, SD_HEADS, 40, torch.float32), (2, 4096, SD_HEADS, 40, torch.bfloat16)]
P43_TIMEOUT_S = 400


def _p43_sd_sample(pre, layout, dtype):
    """Seeds 0-1 of SD v1.5 ``pre`` (guided 7.5, seeded contexts, ipndm at
    NFE 5 on the discrete schedule), its U-Net computing in ``dtype`` (its
    weights are f32 either way), the ring over ``layout``'s seq groups where
    it is given; f32 with TF32 off, bf16 with torch's default flags (as
    phase 24).  Returns (latents, decoded images, launches, the ring's
    ledger, K3 sites of the U-Net)."""
    from diff_sampler_tpu_torch.ops import ring_attention as RA

    f32 = dtype == torch.float32
    torch.backends.cudnn.allow_tf32 = not f32
    torch.backends.cuda.matmul.allow_tf32 = False
    ld = pre.latent_diffusion
    ld.unet.dtype = dtype
    ctx, uc = _sd_contexts(ld, P43_SD_BATCH)
    den = bind(pre, condition=ctx, unconditional_condition=uc)
    cfg = SolverConfig(solver="ipndm", num_steps=P43_SD_STEPS, schedule_type="discrete",
                       schedule_rho=1.0)
    RA.reset_sp_dispatch()
    RA.set_sp_context(layout)
    _reset_counts()
    try:
        latents = generate(den, range(P43_SD_BATCH), SD_LATENT, cfg,
                           max_batch_size=P43_SD_BATCH, device="cuda", layout=layout)
        torch.cuda.synchronize()
        counts = _counts()
    finally:
        RA.set_sp_context(None)
    ledger = RA.sp_dispatch_counts()
    images = ld.decode_in_chunks(latents, chunk=DECODE_CHUNK)
    return latents, images, counts, ledger, _gn_sites(ld.unet)


def _p43_amed(layout, batch=P43_AMED_BATCH, batch_gpu=P43_AMED_BATCH_GPU):
    """One AMED iteration through ``train_amed.build_trainer`` on CIFAR-10
    at ``batch`` (seeds 0 to batch - 1) in microbatches of ``batch_gpu``,
    f32, TF32 off, over ``layout`` (None: one process; a layout with seq
    groups installs the ring, as ``train_amed --sp`` does); returns the
    predictor's weights by path, the losses per segment, the step's launches
    (K2's also by (T, H)) and the ring's ledger."""
    from diff_sampler_tpu_torch.ops import ring_attention as RA

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = AMEDConfig(dataset_name="cifar10", batch=batch, batch_gpu=batch_gpu)
    module, cfg, pred, step, _ = cli_train_amed.build_trainer(cfg, "random", "cuda", seed=0,
                                                              layout=layout)
    latents = stacked_randn(range(batch), (32, 32, 3), device="cuda")
    RA.reset_sp_dispatch()
    RA.set_sp_context(layout if layout is not None and layout.sp > 1 else None)
    torch.cuda.synchronize()
    _reset_counts()
    try:
        losses = step(latents)["loss_per_step"].tolist()
        torch.cuda.synchronize()
    finally:
        RA.set_sp_context(None)
    by_shape = {name: {repr(k): n for k, n in fn.launches_by_shape.items()}
                for name, fn in (("dq", A.flash_attention_bwd_dq),
                                 ("dkv", A.flash_attention_bwd_dkv))}
    res = dict(losses=losses, counts=_counts(), by_shape=by_shape,
               rang={repr(k): n for k, n in RA.sp_dispatch_counts()["rang"].items()},
               weights={k: np.asarray(v) for k, v in
                        ckpt.flatten_params(params_to_jax(pred.state_dict())).items()})
    del module, pred, step
    torch.cuda.empty_cache()
    return res


def _p43_one_call(call, layout) -> dict:
    """``call()`` (one net call on fixed inputs) without the ring, with the
    plain attention in place of K1, through the ring over ``layout``, and
    through the ring with a planted fault: each visiting block dropped from
    the combine, or the two partials averaged unweighted.  Returns each
    output's mean |difference| from the first over its mean |value|."""
    from diff_sampler_tpu_torch.ops import ring_attention as RA

    def dist(x, ref):
        return ((x.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()

    ref = call()
    real_sdpa, real_combine = adm.sdpa, RA._combine
    adm.sdpa = _plain_sdpa
    try:
        out = {"plain": dist(call(), ref)}
    finally:
        adm.sdpa = real_sdpa
    combines = {"ring": real_combine,
                "dropped block": lambda o_a, lse_a, o_b, lse_b: (o_a, lse_a),
                "unweighted combine": lambda o_a, lse_a, o_b, lse_b: (
                    (o_a + o_b) / 2, torch.logaddexp(lse_a, lse_b))}
    RA.set_sp_context(layout)
    try:
        for name, fn in combines.items():
            RA._combine = fn
            out[name] = dist(call(), ref)
    finally:
        RA._combine = real_combine
        RA.set_sp_context(None)
    return out


def _p43_sd_one_call(pre, layout) -> dict:
    """``_p43_one_call`` on SD v1.5's guided D in bf16 at the first step's
    sigma (sigma_max), on seeds 0-1's latents and the seeded contexts."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    ld = pre.latent_diffusion
    ld.unet.dtype = torch.bfloat16
    ctx, uc = _sd_contexts(ld, P43_SD_BATCH)
    den = bind(pre, condition=ctx, unconditional_condition=uc)
    sigma = torch.full((P43_SD_BATCH,), float(pre.sigma_max), device="cuda")
    x = stacked_randn(range(P43_SD_BATCH), SD_LATENT, device="cuda") * sigma[:, None, None, None]
    return _p43_one_call(lambda: den(x, sigma), layout)


def _p43_cg(layout) -> dict:
    """ImageNet-256 with classifier guidance in bf16 (random weights) with
    the ring over ``layout``: ``_p43_one_call`` on the classifier's gradient
    at sigma ``P43_CG_SIGMA``, then seeds 0-1 through ``generate`` at NFE 5
    (integer labels per seed); returns the one-call distances, the
    sampling's launches (K2's by (T, H)), the ring's ledger, the sites per
    CG call and the samples."""
    from diff_sampler_tpu_torch.ops import ring_attention as RA

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    pre, _ = create_model(CG, "random", dtype=torch.bfloat16, device="cuda")
    x, sigma, _, labels = _adm_inputs(P43_CG_BATCH, [P43_CG_SIGMA])
    x_in = x / math.sqrt(P43_CG_SIGMA ** 2 + 1)
    t = (pre.M - 1) * pre.sigma_inv(sigma)
    with torch.no_grad():
        one_call = _p43_one_call(lambda: pre._cond_grad(x_in, t, labels), layout)
    cfg = SolverConfig(solver="ipndm", num_steps=P43_SD_STEPS)
    RA.reset_sp_dispatch()
    RA.set_sp_context(layout)
    torch.cuda.synchronize()
    _reset_counts()
    try:
        samples = generate(bind(pre), range(P43_CG_BATCH), ADM_SHAPE, cfg,
                           max_batch_size=P43_CG_BATCH, device="cuda", label_dim=1000,
                           label_kind="int", layout=layout)
        torch.cuda.synchronize()
    finally:
        RA.set_sp_context(None)
    ledger = RA.sp_dispatch_counts()
    cls_tiles = {(t // 2, h) for t, h in ADM_CLS_LEVELS if t >= 256}
    res = dict(one_call=one_call, counts=_counts(), per=_cg_per_call(pre),
               rang={repr(k): n for k, n in ledger["rang"].items()},
               skipped={repr(k): r for k, r in ledger["skipped"].items()},
               ledger_ok=(set(ledger["rang"]) == P43_CG_RANG
                          and all(k[1] < 256 for k in ledger["skipped"])),
               ring_calls=sum(ledger["rang"].values()),
               cls_ring_calls=sum(n for k, n in ledger["rang"].items()
                                  if (k[1], k[2]) in ADM_CLS_LEVELS),
               ring_k2={name: sum(n for k, n in fn.launches_by_shape.items() if k in cls_tiles)
                        for name, fn in (("dq", A.flash_attention_bwd_dq),
                                         ("dkv", A.flash_attention_bwd_dkv))},
               finite=bool(np.isfinite(samples).all()), shape=list(samples.shape))
    del pre
    torch.cuda.empty_cache()
    return res


def _p43_ring_check(b, t, h, d, dtype, seed):
    """sdpa through the ring (the installed layout) against the plain
    attention over the whole T on this rank: forward and dq / dk / dv at
    K1's and K2's tolerances, and exactly n K1 and n K2 pairs."""
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v = _sd_views(b, t, h, d, dtype, g)
    do = torch.randn(b, t, h, d, generator=g, device="cuda").to(dtype)
    scale = d ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = A.reference_sdpa(*leaves, scale)[0]
    ref_grads = torch.autograd.grad(ref, leaves, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.cuda.synchronize()
    _reset_counts()
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    start.record()
    out = A.sdpa(*leaves, scale)
    mid.record()
    grads = torch.autograd.grad(out, leaves, do)
    end.record()
    torch.cuda.synchronize()
    counts = _counts()
    err = (out.float() - ref.float()).abs().max().item()
    tol = _out_tol(dtype, ref)
    gerr = [(x.float() - y.float()).abs().max().item() for x, y in zip(grads, ref_grads)]
    gtol = [K2_TOL[dtype] * y.float().abs().max().item() for y in ref_grads]
    name = str(dtype).replace("torch.", "")
    return dict(shape=[b, t, h, d], dtype=name, err=err, tol=tol, grad_err=gerr, grad_tol=gtol,
                counts=counts, fwd_ms=start.elapsed_time(mid), bwd_ms=mid.elapsed_time(end))


def _phase43_rank(workdir: str) -> int:
    """One of the two gloo processes of phase 43 (``parallel.launch`` sets
    its DST_* variables): the CIFAR-10 sampling CLI over 2 data ranks, the
    ring checks, the --sp=2 SD sampling (f32, bf16) and SD's bf16 one-call
    check over one seq group of 2, the ImageNet-256 classifier-guided
    sampling with --sp=2, one data-parallel AMED iteration and one with
    --sp=2; its results go to ``workdir``."""
    from diff_sampler_tpu_torch.ops import ring_attention as RA
    from diff_sampler_tpu_torch.parallel import mesh

    mesh.maybe_initialize_distributed("cuda")
    rank, layout = mesh.process_index(), mesh.make_layout(2)
    res = dict(backend=layout.backend, world=layout.world, device=str(torch.cuda.current_device()))
    t0 = time.perf_counter()
    cli_sample.main([*P43_CIFAR_ARGS, f"--outdir={os.path.join(workdir, 'dp2')}"])
    res["cifar_s"] = time.perf_counter() - t0
    RA.set_sp_context(layout)
    try:
        res["ring"] = [_p43_ring_check(*shape, seed=430 + i)
                       for i, shape in enumerate(P43_RING_SHAPES)]
    finally:
        RA.set_sp_context(None)
    res["sd"] = {}
    pre = _sd_model(torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        t0 = time.perf_counter()
        latents, images, counts, ledger, gn = _p43_sd_sample(pre, layout, dtype)
        res["sd"][name] = dict(s=time.perf_counter() - t0, counts=counts, gn=gn,
                               rang={repr(k): n for k, n in ledger["rang"].items()},
                               skipped={repr(k): r for k, r in ledger["skipped"].items()})
        if rank == 0:
            np.savez(os.path.join(workdir, f"sd_sp2_{name}.npz"), latents=latents,
                     images=images)
    res["sd_one_call"] = _p43_sd_one_call(pre, layout)
    del pre
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["cg"] = _p43_cg(layout)
    res["cg"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = _p43_amed(mesh.make_layout())
    res.update(amed_s=time.perf_counter() - t0, amed_losses=dp["losses"])
    t0 = time.perf_counter()
    sp = _p43_amed(layout, batch=P43_SP_AMED_BATCH, batch_gpu=P43_SP_AMED_BATCH)
    res["amed_sp"] = dict(s=time.perf_counter() - t0,
                          **{k: v for k, v in sp.items() if k != "weights"})
    if rank == 0:
        np.savez(os.path.join(workdir, "amed2.npz"), **dp["weights"])
        np.savez(os.path.join(workdir, "amed_sp2.npz"), **sp["weights"])
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_parallel(workdir: str) -> dict:
    """Phase 43: one-process references, then the NCCL world-1 CLI and the
    two gloo ranks on the card, held to them; K1 / K2 at the ring's tile."""
    from diff_sampler_tpu_torch.parallel.launch import run_local

    root = os.path.dirname(os.path.abspath(__file__))

    def _report(tag, results, t0):
        _check(len(results) > 0, f"{tag}: no process ran")
        for rank, (code, text) in enumerate(results):
            lines = text.splitlines()
            print(f"[{tag}] rank {rank} exited {code} after {time.perf_counter() - t0:.2f} s; "
                  f"its last lines:\n  " + "\n  ".join(lines[-12 if code == 0 else -60:]))
            _check(code == 0, f"{tag}: rank {rank} exited {code}")

    def launch(tag, nproc, args, **kw):
        t0 = time.perf_counter()
        results = run_local(nproc, args, cwd=root, timeout_s=P43_TIMEOUT_S, **kw)
        _report(tag, results, t0)
        return results

    # world size 1 under NCCL (the sampling CLI), in a thread beside the
    # references: its PNGs byte for byte the reference's
    nccl = []
    nccl_thread = threading.Thread(target=lambda: nccl.extend(run_local(
        1, ["-m", "diff_sampler_tpu_torch.cli.sample", *P43_CIFAR_ARGS,
            f"--outdir={os.path.join(workdir, 'nccl1')}"], backend="nccl", devices=[0],
        cwd=root, timeout_s=P43_TIMEOUT_S)))
    t_nccl = time.perf_counter()
    nccl_thread.start()
    # one process, no process group: the references
    one = os.path.join(workdir, "one")
    t0 = time.perf_counter()
    cli_sample.main([*P43_CIFAR_ARGS, f"--outdir={one}"])
    print(f"[parallel] CIFAR-10 sampling CLI, one process: {time.perf_counter() - t0:.2f} s")
    sd1 = {}
    pre = _sd_model(torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        t0 = time.perf_counter()
        latents, images, counts, _, gn = _p43_sd_sample(pre, None, dtype)
        want = (_only(k1=(SD_SITES - SD_FLAT_SITES) * (P43_SD_STEPS - 1),
                      k1c=SD_FLAT_SITES * (P43_SD_STEPS - 1), gn=gn * (P43_SD_STEPS - 1))
                if dtype == torch.float32 else
                _only(k1=SD_SITES * (P43_SD_STEPS - 1), gn=gn * (P43_SD_STEPS - 1)))
        print(f"[parallel] SD v1.5 {name}, one process: {time.perf_counter() - t0:.2f} s, "
              f"launches {counts}")
        _check(counts == want, f"SD {name} --sp=1 launches {counts}, expected {want}")
        sd1[name] = (latents, images)
    np.savez(os.path.join(workdir, "sd_one_float32.npz"), latents=sd1["float32"][0],
             images=sd1["float32"][1])  # phase 44's reference
    del pre
    torch.cuda.empty_cache()
    amed1 = _p43_amed(None)
    amed_sp1 = _p43_amed(None, batch=P43_SP_AMED_BATCH, batch_gpu=P43_SP_AMED_BATCH)
    nccl_thread.join()
    _report("parallel NCCL x1", nccl, t_nccl)
    _check("processes: 1 (nccl)" in nccl[0][1], "the NCCL run did not start a process group")
    # two gloo ranks on cuda:0
    code = "import sys, chip_smoke; sys.exit(chip_smoke._phase43_rank(sys.argv[1]))"
    launch("parallel gloo x2", 2, ["-c", code, workdir], backend="gloo", devices=[0, 0])
    ranks = [json.load(open(os.path.join(workdir, f"rank{r}.json"))) for r in range(2)]

    ref = {os.path.basename(p): open(p, "rb").read()
           for p in glob.glob(os.path.join(one, "*.png"))}
    for tag in ("nccl1", "dp2"):
        got = {os.path.basename(p): open(p, "rb").read()
               for p in glob.glob(os.path.join(workdir, tag, "*.png"))}
        same = sum(got.get(name) == data for name, data in ref.items())
        print(f"[parallel] {tag}: {len(got)} PNGs, {same} of {len(ref)} byte-equal to one "
              f"process's")
        _check(len(ref) == P43_SEEDS and got.keys() == ref.keys() and same == len(ref),
               f"{tag}: PNGs differ from one process's")
    print(f"[parallel] the ranks: backend {ranks[0]['backend']}, world {ranks[0]['world']}, "
          f"current device cuda:{ranks[0]['device']} / cuda:{ranks[1]['device']}; CIFAR-10 "
          f"CLI {ranks[0]['cifar_s']:.2f} s (host clock); the ring's blocks go through pinned "
          f"host memory under gloo")
    _check(all(r["backend"] == "gloo" and r["world"] == 2 for r in ranks), "gloo ranks")

    for r, rk in enumerate(ranks):
        for c in rk["ring"]:
            print(f"[parallel ring] rank {r} {c['shape']} {c['dtype']}: out err {c['err']:.3g} "
                  f"(tol {c['tol']:.3g}); dq / dk / dv err "
                  f"{[float(f'{x:.3g}') for x in c['grad_err']]} (tol "
                  f"{[float(f'{x:.3g}') for x in c['grad_tol']]}); launches {c['counts']}; "
                  f"forward {c['fwd_ms']:.3f} ms, backward {c['bwd_ms']:.3f} ms (CUDA events, "
                  f"the gloo transport included)")
            _check(c["err"] <= c["tol"] and all(e <= t for e, t in
                                                zip(c["grad_err"], c["grad_tol"])),
                   f"ring attention disagrees with plain attention at {c['shape']} {c['dtype']}")
            _check(c["counts"] == _only(k1=2, dq=2, dkv=2),
                   f"ring at {c['shape']}: launches {c['counts']}, expected 2 K1 and 2 K2 pairs")

    want_rang = {repr(k): n for k, n in P43_SD_RANG.items()}
    want_skip = [repr((2 * P43_SD_BATCH, 64, SD_HEADS, 160))]
    for name in ("float32", "bfloat16"):
        for r, rk in enumerate(ranks):
            sd = rk["sd"][name]
            want = _only(k1=(2 * (SD_SITES - 1) + 1) * (P43_SD_STEPS - 1),
                         gn=sd["gn"] * (P43_SD_STEPS - 1))
            print(f"[parallel SD --sp=2] {name} rank {r}: {sd['s']:.2f} s; launches "
                  f"{sd['counts']} (expected {want}); rang {sd['rang']}; skipped "
                  f"{sd['skipped']}")
            _check(sd["counts"] == want, f"SD --sp=2 {name} rank {r}: launches {sd['counts']}")
            _check(sd["rang"] == want_rang and list(sd["skipped"]) == want_skip,
                   f"SD --sp=2 {name} rank {r}: the ring's ledger")
        sp2 = np.load(os.path.join(workdir, f"sd_sp2_{name}.npz"))
        latents1, images1 = sd1[name]
        levels = np.abs(to_uint8(sp2["images"]).astype(np.int16)
                        - to_uint8(images1).astype(np.int16))
        print(f"[parallel SD --sp=2] {name}: latents max abs diff "
              f"{np.abs(sp2['latents'] - latents1).max():.4g} (max|x| "
              f"{np.abs(latents1).max():.4g}); decoded images {levels.max()} uint8 levels from "
              f"--sp=1 at most, {levels.mean():.4f} on average, {(levels > 0).mean():.4f} of "
              f"the values differ")
        if name == "float32":
            _check(levels.max() <= 1, "SD --sp=2 f32 images more than one level from --sp=1")
        _check(np.isfinite(sp2["images"]).all(), f"SD --sp=2 {name} images are not finite")

    def one_call_gate(tag, got):
        bar = P43_ONE_CALL_FACTOR * got["plain"]
        print(f"[parallel one call] {tag}, bf16, mean |difference| over mean |value| from the "
              f"--sp=1 call: ring {got['ring']:.4g}, plain attention in place of K1 "
              f"{got['plain']:.4g} (gate {P43_ONE_CALL_FACTOR:g} x: {bar:.4g}); planted faults "
              f"through the ring: dropped block {got['dropped block']:.4g}, unweighted combine "
              f"{got['unweighted combine']:.4g}")
        _check(got["ring"] <= bar, f"{tag}: the ring moved the call {got['ring']:.4g} from "
                                   f"--sp=1, more than {bar:.4g}")
        _check(got["dropped block"] > bar, f"{tag}: the gate does not see a dropped block")

    for r, rk in enumerate(ranks):
        one_call_gate(f"SD v1.5 guided D at sigma_max, rank {r}", rk["sd_one_call"])
        one_call_gate(f"ImageNet-256 classifier gradient at sigma {P43_CG_SIGMA}, rank {r}",
                      rk["cg"]["one_call"])

    for r, rk in enumerate(ranks):
        cg = rk["cg"]
        per, nfe, cls_rang = cg["per"], P43_SD_STEPS - 1, cg["cls_ring_calls"]
        want = _only(k1=per["k1"] * nfe + cg["ring_calls"], gn=per["gn"] * nfe,
                     dq=per["dq"] * nfe + cls_rang, dkv=per["dkv"] * nfe + cls_rang)
        print(f"[parallel CG --sp=2] ImageNet-256 classifier-guided bf16 sampling, seeds "
              f"0-{P43_CG_BATCH - 1}, NFE {nfe}, rank {r}: {cg['s']:.2f} s with the set-up; "
              f"launches {cg['counts']} (expected {want}); K2 at the classifier's ring tiles "
              f"{cg['ring_k2']} (expected {2 * cls_rang} each); rang {cg['rang']}; skipped "
              f"{cg['skipped']}; samples {cg['shape']}, finite {cg['finite']}")
        _check(cg["counts"] == want and all(n == 2 * cls_rang > 0 for n in cg["ring_k2"].values()),
               f"CG --sp=2 rank {r}: launches {cg['counts']}")
        _check(cg["ledger_ok"], f"CG --sp=2 rank {r}: the ring's ledger")
        _check(cg["finite"] and cg["shape"] == [P43_CG_BATCH, *ADM_SHAPE],
               f"CG --sp=2 rank {r}: samples")

    def amed_diff(one, path):
        got = dict(np.load(path))
        scale = max(1.0, max(float(np.abs(x).max()) for x in one["weights"].values()))
        diff = max(float(np.abs(one["weights"][k] - got[k]).max()) for k in one["weights"])
        return one["weights"].keys() == got.keys(), diff, scale

    same_keys, diff, scale = amed_diff(amed1, os.path.join(workdir, "amed2.npz"))
    print(f"[parallel AMED] one iteration at batch {P43_AMED_BATCH} in microbatches of "
          f"{P43_AMED_BATCH_GPU}, f32, TF32 off: one process {amed1['losses']}, 2 data ranks "
          f"({P43_AMED_BATCH_GPU // 2} rows a rank; rank 0's loss, {ranks[0]['amed_s']:.2f} s with the set-up) "
          f"{ranks[0]['amed_losses']}; predictor max abs diff {diff:.3g} (tol {P43_AMED_TOL} * "
          f"{scale:.3g})")
    _check(same_keys and diff <= P43_AMED_TOL * scale,
           "data-parallel AMED moved away from one process's predictor")

    same_keys, diff, scale = amed_diff(amed_sp1, os.path.join(workdir, "amed_sp2.npz"))
    print(f"[parallel AMED --sp=2] one iteration at batch {P43_SP_AMED_BATCH}, f32, TF32 off: "
          f"one process {amed_sp1['losses']}, launches {amed_sp1['counts']}, K2 by (T, H) "
          f"{amed_sp1['by_shape']}; predictor max abs diff {diff:.3g} (tol {P43_AMED_TOL} * "
          f"{scale:.3g})")
    _check(same_keys and diff <= P43_AMED_TOL * scale,
           "AMED with --sp=2 moved away from one process's predictor")
    for r, rk in enumerate(ranks):
        sp = rk["amed_sp"]
        rang = sum(sp["rang"].values())
        ring_t, local_t = (repr((256, 1)), repr((64, 1)))
        one = amed_sp1["counts"]
        want = _only(**{**one, "k1": one["k1"] + rang,
                        **{k: one[k] + amed_sp1["by_shape"][k][ring_t] for k in ("dq", "dkv")}})
        want_by = {k: {repr((128, 1)): 2 * v[ring_t], local_t: v[local_t]}
                   for k, v in amed_sp1["by_shape"].items()}
        print(f"[parallel AMED --sp=2] rank {r}: {sp['s']:.2f} s with the set-up; losses "
              f"{sp['losses']}; launches {sp['counts']} (expected {want}); K2 by (T, H) "
              f"{sp['by_shape']} (expected {want_by}); rang {sp['rang']}")
        _check(sp["counts"] == want and sp["by_shape"] == want_by
               and list(sp["rang"]) == [repr((P43_SP_AMED_BATCH, 256, 1, 256))],
               f"AMED --sp=2 rank {r}: launches or ledger")

    # K1 / K2 at the ring's tiles on these paths and at SD's tile beside the
    # whole T, in this process
    k1 = _k1_checks("ring K1", P43_TILE_K1, _sd_views, seed=431, reps=5, warmup=2)
    k2 = _k2_checks("ring K2", P43_TILE_K2, _sd_views, seed=432)
    sd, amed_sp, cg = ranks[0]["sd"], ranks[0]["amed_sp"], ranks[0]["cg"]
    return dict(k1=k1, k2=k2,
                sd_k1={name: 2 * sum(sd[name]["rang"].values()) for name in sd},
                amed_sp={k: amed_sp["by_shape"][k][repr((128, 1))] for k in ("dq", "dkv")},
                cg=cg["ring_k2"])


# Phase 44: tensor parallelism and FSDP.  Two gloo processes share the one
# card (as in phase 43), each on cuda:0, after the one-process references in
# this process.  The model group of --tp=2 holds both ranks (a data group of
# one); FSDP's data group holds both (each rank its row of the batch).
# CIFAR-10's net is redrawn at unit scale and loaded from a file (as phase
# 41's): at its random init conv1, proj and the output convs start at
# 1e-5, so D ~ c_skip * x and no row layer or gather would show in a PNG.
# Its one-level gate has a planted fault that must read beyond it: the
# ranks' parts of each gathered qkv joined in the wrong order
P44_CIFAR_NET = "cifar10-unit-scale.pt"
P44_CIFAR_SEEDS = 64
P44_FAULT_SEEDS = 8  # the faulty CLI run: the first 8 seeds
P44_CIFAR_ARGS = ["--dataset_name=cifar10", "--solver=ipndm", "--num_steps=6",
                  "--device=cuda", "--subdirs=False"]
P44_CG_BATCH = 2  # ImageNet-256 CG: seeds 0-1, ipndm at NFE 5, f32 and bf16
P44_CG_ARGS = [f"--dataset_name={CG}", "--model_path=random", "--guidance_type=cg",
               "--solver=ipndm", "--num_steps=6", f"--seeds=0-{P44_CG_BATCH - 1}",
               f"--batch={P44_CG_BATCH}", "--device=cuda", "--subdirs=False"]
# bf16 classifier guidance is held on one call (the classifier's gradient at
# sigma_max): its distance from the one-process call (mean |difference| over
# mean |value|) at most P44_ONE_CALL_FACTOR times the one-process call's
# distance between bf16 and f32; a planted fault (one row-parallel layer's
# sum over the model group skipped) must read beyond that
P44_ONE_CALL_FACTOR = 1.5
# one CIFAR-10 D call in f32 (TF32 off): the shards at most 1e-5 of one
# process's mean |D| from it (two f32 runs that sum in other orders: ~1e-7),
# the swapped gather and one conv1 without its sum beyond it
P44_D_TOL = 1e-5
# teacher dpmpp: CIFAR-10 at 3 steps with AFS off (2 segments, 2 Adam
# updates), SD at 2 steps (1 segment, 1 update: 2 teacher calls, the
# gathers of FSDP through gloo being the time)
P44_SFD_CFG = {"cifar": SFDConfig(num_steps=3, M=1), "sd": SFDConfig(num_steps=2, M=1)}
P44_SFD_LR = 5e-5  # train_sfd's default
P44_SFD_BATCH = {"cifar": 8, "sd": 2}
P44_AMED_BATCH = 8
P44_AMED_STEPS = 3
# The trainings' gates.  Adam's first moment, linear in the gradients, is
# the gradients' gate: within 1e-4 of its largest entry of one process's
# (two f32 runs that sum over channels, heads and rows in other orders, TF32
# off), and a planted fault on each path must read beyond it (CIFAR-10
# --tp=2: one conv1 without its sum over the model group; SD --fsdp: the
# reduce-scatter's sum not divided by the data group's size).  Each rank's
# shards of the weights after the step are held within 1e-4 of the same
# entries of one process's too, which checks the shards' places (a shard in
# the wrong place moves a weight by its own scale), not the gradients:
# Adam's first update moves each weight by about lr whatever its gradient's
# size, so two runs differ by at most 2 lr = 1e-4 an update there
P44_TOL = 1e-4
P44_MOMENT_TOL = 1e-4
P44_TIMEOUT_S = 600
# K1 / K2 / K3 at the tp=2 shards' local shapes: ImageNet-256's 32x32 level
# (the U-Net's 8 heads of 64 and the classifier's 4, two a rank of the latter
# in bf16 in the one-call gate), and its first level's GroupNorm between the
# column and the row conv (256 channels, 128 a rank in 16 groups)
P44_K1_SHAPES = [(P44_CG_BATCH, 1024, 4, 64, torch.float32),
                 (P44_CG_BATCH, 1024, 2, 64, torch.bfloat16)]
P44_K2_SHAPES = [(P44_CG_BATCH, 1024, 2, 64, torch.float32),
                 (P44_CG_BATCH, 1024, 2, 64, torch.bfloat16)]
P44_GN_SHAPES = [(P44_CG_BATCH, 256, 256, 128, torch.float32, 1e-5, False)]


def _p44_flags(f32: bool) -> None:
    torch.backends.cudnn.allow_tf32 = not f32
    torch.backends.cuda.matmul.allow_tf32 = False


def _p44_sample_cli(args: list, outdir: str) -> dict:
    """The sampling CLI in f32, TF32 off, the counts set to 0 just before;
    returns its launches and seconds."""
    _p44_flags(True)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    cli_sample.main([*args, f"--outdir={outdir}"])
    torch.cuda.synchronize()
    return dict(counts=_counts(), s=time.perf_counter() - t0)


def _p44_cifar_args(workdir: str, seeds: int, *extra) -> list:
    """The CIFAR-10 sampling CLI's flags on phase 44's unit-scale net, seeds
    0 to ``seeds`` - 1 in one batch."""
    return [*P44_CIFAR_ARGS, f"--model_path={os.path.join(workdir, P44_CIFAR_NET)}",
            f"--seeds=0-{seeds - 1}", f"--batch={seeds}", *extra]


def _p44_write_cifar_net(workdir: str) -> None:
    """Phase 44's full-width CIFAR-10 EDMPrecond, from seed 0 redrawn at
    unit scale, saved into ``workdir`` for every process to load."""
    module, _ = create_model("cifar10", "random", device="cuda")
    with torch.no_grad():
        _redraw_unit_scale(module, seed=44, device="cuda")
    torch.save(module.state_dict(), os.path.join(workdir, P44_CIFAR_NET))
    del module
    torch.cuda.empty_cache()


def _p44_skip_a_sum(module) -> str:
    """The planted fault of the CIFAR-10 --tp=2 paths: the row-parallel
    ``conv1`` of the first attention block that gathers its head runs
    without its sum over the model group; returns its name."""
    for name, m in module.named_modules():
        if isinstance(m, unets.UNetBlock) and m.tp_heads is not None and m.tp_heads.gather:
            m.conv1.tp_role = None
            return f"{name}.conv1"
    raise RuntimeError("no tensor-parallel attention block gathers its heads")


@contextlib.contextmanager
def _p44_patched(owner, name: str, value):
    """``owner.name`` set to ``value`` inside the block (a planted fault)."""
    old = vars(owner)[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _p44_undivided():
    """The planted fault of the SD --fsdp path, as a patch: FSDP's gradient
    reduce-scatter summed over the data group and not divided by its size."""
    from diff_sampler_tpu_torch.parallel import fsdp

    backward = fsdp._GatherShard.backward

    def undivided(ctx, g):
        grad, _ = backward(ctx, g)
        return grad * ctx.spec.size, None

    return _p44_patched(fsdp._GatherShard, "backward", staticmethod(undivided))


def _p44_swapped_gather():
    """The planted fault of the gather path, as a patch: the ranks' parts of
    a gathered projection joined in the wrong order."""
    from diff_sampler_tpu_torch.parallel import tp

    forward = tp._GatherFromModel.forward

    def swapped(ctx, x, group, rank, size):
        return torch.cat(forward(ctx, x, group, rank, size).chunk(size, dim=-1)[::-1], dim=-1)

    return _p44_patched(tp._GatherFromModel, "forward", staticmethod(swapped))


def _p44_dist(x, ref) -> float:
    """Mean |difference| over mean |value| of ``ref``."""
    return ((x.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()


def _p44_cifar_call(workdir: str, layout) -> dict:
    """D of the unit-scale CIFAR-10 net on one call (f32, TF32 off, batch 8
    at sigma 80, 10, 1, 0.1) on the tp=2 shards against one process's, then
    with two planted faults in turn: the gathered parts swapped, one conv1
    without its sum (``_p44_skip_a_sum``); distances by ``_p44_dist``."""
    from diff_sampler_tpu_torch.models.factory import shard_pixel_tensor_parallel

    _p44_flags(True)
    module, source = create_model("cifar10", os.path.join(workdir, P44_CIFAR_NET),
                                  device="cuda")
    den = bind(module)
    sigma = torch.tensor([80.0, 10.0, 1.0, 0.1] * 2, device="cuda")
    x = stacked_randn(range(8), (32, 32, 3), device="cuda") * sigma[:, None, None, None]
    with torch.no_grad():
        ref = den(x, sigma)
        shard_pixel_tensor_parallel(module, layout, source)
        got = den(x, sigma)
        with _p44_swapped_gather():
            swapped = den(x, sigma)
        planted = _p44_skip_a_sum(module)
        skipped = den(x, sigma)
    return dict(tp=_p44_dist(got, ref), swapped=_p44_dist(swapped, ref), planted=planted,
                skipped=_p44_dist(skipped, ref))


def _p44_cli_fault(workdir: str) -> dict:
    """The CIFAR-10 sampling CLI with --tp=2 on the first ``P44_FAULT_SEEDS``
    seeds, with ``_p44_swapped_gather``'s fault; launches and seconds."""
    with _p44_swapped_gather():
        return _p44_sample_cli(_p44_cifar_args(workdir, P44_FAULT_SEEDS, "--tp=2"),
                               os.path.join(workdir, "cifar_fault"))


def _p44_sd_student(pre):
    """train_sfd's latent student (``_create_latent_student``) over the SD
    stack ``pre`` already built: the U-Net trainable, a frozen copy the
    teacher."""
    ld = pre.latent_diffusion
    ld.requires_grad_(False)
    unet = ld.unet.requires_grad_(True)
    return cli_train_sfd.Student(unet, copy.deepcopy(unet).requires_grad_(False),
                                 list(unet.named_parameters()), None, None)


def _p44_sfd(kind: str, layout, source, n_acc: int = 1, fault: bool = False) -> dict:
    """One SFD iteration through train_sfd's student, shard and train step,
    f32, TF32 off: the full-width CIFAR-10 SongUNet from the file ``source``
    (``kind`` "cifar", remat on; tensor parallel over ``layout``'s model
    group) or SD v1.5's U-Net of the stack ``source`` (``kind`` "sd"; FSDP
    over ``layout``'s data ranks); None: one process; ``n_acc``
    microbatches; ``fault``: with the path's planted fault.  Returns the
    student's weights and Adam's first moment as this rank holds them (one
    process's on the host, a sharded run's shards on the card, with their
    shard specs), the resident parameter and Adam bytes, the peak memory,
    the launches, the losses and the seconds."""
    _p44_flags(True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = P44_SFD_BATCH[kind]
    if kind == "cifar":
        student = cli_train_sfd._create_student("cifar10", source, False, True, "cuda")
        latents, cond = stacked_randn(range(batch), (32, 32, 3), device="cuda"), ()
    else:
        student = _p44_sd_student(source)
        latents = stacked_randn(range(batch), SD_LATENT, device="cuda")
        cond = (_sd_contexts(source.latent_diffusion, batch)[0],)
    if layout is not None:
        cli_train_sfd.shard_student(student, layout, fsdp=kind == "sd")
    planted, patch = None, contextlib.nullcontext()
    if fault and kind == "cifar":
        planted = _p44_skip_a_sum(student.module)
    elif fault:
        planted, patch = "the gradient reduce-scatter not divided by 2", _p44_undivided()
    opt = torch.optim.Adam([p for _, p in student.named], lr=P44_SFD_LR, betas=(0.9, 0.999),
                           eps=1e-8)
    if kind == "cifar":
        step = make_sfd_train_step(student.module, student.teacher, P44_SFD_CFG[kind], opt,
                                   n_acc=n_acc, layout=layout)
    else:
        step = make_sfd_ldm_train_step(student.module, student.teacher, source,
                                       P44_SFD_CFG[kind], opt, n_acc=n_acc, layout=layout)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with patch:
        losses = step(latents, *cond)["loss_per_step"].tolist()
    torch.cuda.synchronize()
    res = dict(counts=_counts(), s=time.perf_counter() - t0, losses=losses,
               peak=torch.cuda.max_memory_allocated(), planted=planted)
    res["param_bytes"] = sum(p.numel() * p.element_size() for m in (student.module,
                                                                    student.teacher)
                             for p in m.parameters())
    res["adam_bytes"] = sum(t.numel() * t.element_size() for st in opt.state.values()
                            for t in st.values() if torch.is_tensor(t) and t.dim() > 0)
    # a sharded run's shards stay on the card: gathering SD's 860M weights
    # and moments whole through gloo would take longer than the step
    keep = (lambda t: t.detach().cpu()) if layout is None else (lambda t: t.detach().clone())
    res["weights"] = {n: keep(p) for n, p in student.named}
    res["mu"] = {n: keep(opt.state[p]["exp_avg"]) for n, p in student.named if p in opt.state}
    res["specs"] = {n: shard_spec(p) for n, p in student.named}
    del student, opt, step
    return res


def _p44_against(one: dict, got: dict) -> dict:
    """``got``'s weights and first moment (this rank's shards) against the
    same entries of one process's (whole, on the host)."""
    def apart(ref, mine, spec):
        ref = ref if spec is None else cut(ref, spec)
        return float((mine - ref.to(mine.device)).abs().max())

    return dict(diff=max(apart(v, got["weights"][k], got["specs"][k])
                         for k, v in one["weights"].items()),
                mu_diff=max(apart(v, got["mu"][k], got["specs"][k])
                            for k, v in one["mu"].items()),
                same_keys=got["weights"].keys() == one["weights"].keys()
                and got["mu"].keys() == one["mu"].keys())


def _p44_amed(layout, batch_gpu: int) -> dict:
    """One AMED iteration on the LSUN LDM through ``train_amed.build_trainer``
    at batch ``P44_AMED_BATCH`` in microbatches of ``batch_gpu``, f32, TF32
    off, its frozen U-Net FSDP-sharded over ``layout``'s data ranks (None:
    one process); the predictor's weights, the U-Net's resident bytes, the
    peak, the launches, the losses."""
    _p44_flags(True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = AMEDConfig(dataset_name=LDM, batch=P44_AMED_BATCH, num_steps=P44_AMED_STEPS,
                     afs=LDM_AMED_AFS, batch_gpu=batch_gpu)
    module, cfg, pred, step, _ = cli_train_amed.build_trainer(
        cfg, "random", "cuda", seed=0, layout=layout, fsdp=layout is not None)
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    latents = stacked_randn(range(P44_AMED_BATCH), shape, device="cuda")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    losses = step(latents)["loss_per_step"].tolist()
    torch.cuda.synchronize()
    unet = module.latent_diffusion.unet
    res = dict(counts=_counts(), s=time.perf_counter() - t0, losses=losses,
               peak=torch.cuda.max_memory_allocated(),
               unet_bytes=sum(p.numel() * p.element_size() for p in unet.parameters()),
               weights={k: np.asarray(v) for k, v in
                        ckpt.flatten_params(params_to_jax(pred.state_dict())).items()})
    del module, pred, step
    torch.cuda.empty_cache()
    return res


def _p44_one_call(pre, shard) -> dict:
    """The bf16 one-call gate of ImageNet-256 CG on the whole ``pre`` (the
    classifier's gradient at sigma_max on seeds 0-1): one process's call in
    bf16 and in f32, then ``shard()`` cuts the nets to their tp=2 shards,
    the shards' bf16 call, and the same with one row-parallel layer's sum
    skipped (a planted fault); leaves ``pre`` sharded, in f32, the counts at
    0 and TF32 off.  Returns the distances (``_p44_dist``) and the
    launches."""
    cls = pre.classifier
    x, sigma, _, labels = _adm_inputs(P44_CG_BATCH, [float(pre.sigma_max)])
    x_in = x / torch.sqrt(sigma ** 2 + 1)[:, None, None, None]
    t = (pre.M - 1) * pre.sigma_inv(sigma)
    with torch.no_grad():
        _p44_flags(True)
        ref32 = pre._cond_grad(x_in, t, labels)
        _p44_flags(False)
        cls.dtype = torch.bfloat16
        ref = pre._cond_grad(x_in, t, labels)
        shard()
        torch.cuda.synchronize()
        _reset_counts()
        got = pre._cond_grad(x_in, t, labels)
        torch.cuda.synchronize()
        counts = _counts()
        row = next(m for m in cls.modules() if getattr(m, "tp_role", None) == "row")
        row.tp_role = None  # the planted fault: this layer's partial sums not summed
        fault = pre._cond_grad(x_in, t, labels)
        row.tp_role = "row"
        cls.dtype = torch.float32
    _p44_flags(True)
    _reset_counts()
    return dict(tp=_p44_dist(got, ref), bf16_vs_f32=_p44_dist(ref, ref32),
                fault=_p44_dist(fault, ref), counts=counts,
                want=_only(k1=_attention_sites(cls), gn=_gn_sites(cls), dq=_attention_sites(cls),
                           dkv=_attention_sites(cls)))


def _p44_cg(layout, outdir: str) -> dict:
    """ImageNet-256 with classifier guidance (random weights, guidance 1):
    the sampling CLI in f32 on seeds 0-1 (ipndm at NFE 5, TF32 off), its
    PNGs into ``outdir``; with ``layout``, with --tp=2 (which cuts the U-Net
    and the classifier), and before the CLI samples, the bf16 one-call gate
    (``_p44_one_call``) on the nets it built.  Returns the CLI's launches
    (its sampling's) and seconds, and the gate's distances and launches."""
    if layout is None:
        return _p44_sample_cli(P44_CG_ARGS, outdir)
    shard, gate = cli_sample.shard_tensor_parallel_model, {}

    def gated(module, source, lay, *args, **kwargs):
        gate.update(_p44_one_call(module, lambda: shard(module, source, lay, *args, **kwargs)))

    with _p44_patched(cli_sample, "shard_tensor_parallel_model", gated):
        res = _p44_sample_cli([*P44_CG_ARGS, "--tp=2"], outdir)
    return dict(res, one_call=gate)


def _p44_sd_sample(pre, layout) -> dict:
    """Seeds 0-1 of SD v1.5 ``pre`` in f32 (TF32 off), guided 7.5 on the
    seeded contexts, ipndm at NFE 5 on the discrete schedule (phase 43's
    one-process run), its U-Net cut to the tp=2 shard; launches, latents,
    images."""
    from diff_sampler_tpu_torch.models.factory import shard_ldm_tensor_parallel

    _p44_flags(True)
    ld = pre.latent_diffusion
    shard_ldm_tensor_parallel(pre, layout)
    ctx, uc = _sd_contexts(ld, P43_SD_BATCH)
    den = bind(pre, condition=ctx, unconditional_condition=uc)
    cfg = SolverConfig(solver="ipndm", num_steps=P43_SD_STEPS, schedule_type="discrete",
                       schedule_rho=1.0)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    latents = generate(den, range(P43_SD_BATCH), SD_LATENT, cfg, max_batch_size=P43_SD_BATCH,
                       device="cuda", layout=layout)
    torch.cuda.synchronize()
    res = dict(counts=_counts(), s=time.perf_counter() - t0, gn=_gn_sites(ld.unet))
    res["images"] = ld.decode_in_chunks(latents, chunk=DECODE_CHUNK)
    res["latents"] = latents
    return res


def _phase44_rank(workdir: str) -> int:
    """One of the two gloo processes of phase 44 (``parallel.launch`` sets
    its DST_* variables): the CIFAR-10 sampling CLI with --tp=2 in f32 on
    the unit-scale net of ``workdir`` (and on its first seeds with a planted
    fault), the CG bf16 one-call gate and the ImageNet-256 CG sampling CLI
    with --tp=2, SD v1.5 with the U-Net tp=2-sharded, one SFD iteration with
    --tp=2 on CIFAR-10 and one with FSDP on SD v1.5 (each also with its
    planted fault), one AMED iteration on the LSUN LDM with FSDP; results
    (and rank 0's SD outputs) go to ``workdir``."""
    from diff_sampler_tpu_torch.parallel import mesh

    mesh.maybe_initialize_distributed("cuda")
    rank = mesh.process_index()
    layout_tp, layout_dp = mesh.make_layout(tp=2), mesh.make_layout()
    res = dict(backend=layout_tp.backend, world=layout_tp.world)
    res["cifar"] = _p44_sample_cli(_p44_cifar_args(workdir, P44_CIFAR_SEEDS, "--tp=2"),
                                   os.path.join(workdir, "cifar_tp"))
    res["cifar_fault"] = _p44_cli_fault(workdir)
    res["cifar_call"] = _p44_cifar_call(workdir, layout_tp)
    res["cg"] = _p44_cg(layout_tp, os.path.join(workdir, "cg_tp"))
    t0 = time.perf_counter()
    pre = _sd_model(torch.float32)
    spare = copy.deepcopy(pre.latent_diffusion.unet)
    sd = _p44_sd_sample(pre, layout_tp)
    res["sd"] = {k: v for k, v in sd.items() if k not in ("images", "latents")}
    res["sd"]["setup_s"] = time.perf_counter() - t0 - sd["s"]
    pre.latent_diffusion.unet = None  # the tp=2 shard; ``spare`` is the whole U-Net
    torch.cuda.empty_cache()
    outs = {"sd_tp": dict(latents=sd.pop("latents"), images=sd.pop("images"))}
    # cuDNN's deterministic algorithms for the trainings, whose weights are
    # compared after Adam: a nondeterministic weight gradient at rounding
    # noise may change sign between two runs, and Adam moves such a weight
    # by lr either way
    torch.backends.cudnn.deterministic = True
    # the trainings: each rank runs the one-process reference itself first
    # (no collective), on the same rows in the same microbatches as the
    # sharded run's ranks take them (SD: batch 2 as two microbatches of 1
    # against 1 row a rank; the LDM's AMED: 8 as two of 4 against 4 a
    # rank), so that the two runs' kernels see the same shapes and data;
    # then the sharded run with the path's planted fault, then without
    net = os.path.join(workdir, P44_CIFAR_NET)
    for kind, layout, n_acc in (("cifar", layout_tp, 1), ("sd", layout_dp, 2)):
        source = pre if kind == "sd" else net
        runs = {}
        for run, lay, acc, fault in (("one", None, n_acc, False), ("fault", layout, 1, True),
                                     ("got", layout, 1, False)):
            if kind == "sd":
                pre.latent_diffusion.unet = spare if run == "got" else copy.deepcopy(spare)
            runs[run] = _p44_sfd(kind, lay, source, n_acc=acc, fault=fault)
            if run == "fault":
                f = runs.pop("fault")
                runs["planted"] = dict(_p44_against(runs["one"], f), planted=f["planted"],
                                       losses=f["losses"])
                del f
        one, got = runs["one"], runs["got"]
        res[f"sfd_{kind}"] = dict(
            one={k: v for k, v in one.items() if k not in ("weights", "mu", "specs")},
            **{k: v for k, v in got.items() if k not in ("weights", "mu", "specs")},
            **_p44_against(one, got), fault=runs["planted"],
            mu_scale=max(float(v.abs().max()) for v in one["mu"].values()))
        del one, got, runs
    del pre, spare
    torch.cuda.empty_cache()
    amed1 = _p44_amed(None, batch_gpu=P44_AMED_BATCH // 2)
    t0 = time.perf_counter()
    amed = _p44_amed(layout_dp, batch_gpu=P44_AMED_BATCH)
    res["amed"] = dict(one={k: v for k, v in amed1.items() if k != "weights"},
                       **{k: v for k, v in amed.items() if k != "weights"},
                       setup_s=time.perf_counter() - t0 - amed["s"],
                       same_keys=amed["weights"].keys() == amed1["weights"].keys(),
                       diff=max(float(np.abs(amed1["weights"][k] - amed["weights"][k]).max())
                                for k in amed1["weights"]),
                       scale=max(1.0, max(float(np.abs(x).max())
                                          for x in amed1["weights"].values())))
    if rank == 0:
        np.savez(os.path.join(workdir, "sd_tp.npz"), **outs["sd_tp"])
    with open(os.path.join(workdir, f"p44_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def _p44_launch(workdir: str) -> tuple:
    """Write phase 44's unit-scale CIFAR-10 net into ``workdir``, then start
    its two gloo ranks on cuda:0 (``_phase44_rank``, results into
    ``workdir``) from a thread; returns (the thread, the list it fills with
    the ranks' (exit code, output), the start on the host clock).  The
    script starts them before phase 33 and joins them before phase 39: they
    wait on gloo's host transport most of the time, beside phases 33 and
    32, whose seconds and rates are taken with the ranks on the same card
    and host (so they are not comparable with those of runs before the
    ranks ran beside them), then beside phases 35a and 35c, which time
    nothing, and phase 44's one-process references."""
    from diff_sampler_tpu_torch.parallel.launch import run_local

    _p44_write_cifar_net(workdir)
    root = os.path.dirname(os.path.abspath(__file__))
    code = "import sys, chip_smoke; sys.exit(chip_smoke._phase44_rank(sys.argv[1]))"
    results = []
    thread = threading.Thread(target=lambda: results.extend(run_local(
        2, ["-c", code, workdir], cwd=root, timeout_s=P44_TIMEOUT_S, backend="gloo",
        devices=[0, 0])))
    thread.start()
    return thread, results, time.perf_counter()


def phase_p44_references(workdir: str) -> dict:
    """Phase 44's one-process sampling references: the CIFAR-10 and CG
    sampling CLIs, their PNGs into ``workdir``; their launches and seconds."""
    return {"cifar": _p44_sample_cli(_p44_cifar_args(workdir, P44_CIFAR_SEEDS),
                                     os.path.join(workdir, "cifar_one")),
            "cg": _p44_cg(None, os.path.join(workdir, "cg_one"))}


def phase_tensor_parallel(workdir: str, launched: tuple, one: dict, sd_ref_dir: str) -> dict:
    """Phase 44: the two gloo ranks that ``_p44_launch`` started (into
    ``workdir``) held to the one-process references ``one``
    (``phase_p44_references``) and to those they ran themselves; K1 / K2 /
    K3 at the tp=2 shards' local shapes.  ``sd_ref_dir``: phase 43's
    directory, whose one-process SD v1.5 f32 run is the reference."""
    thread, results, t0 = launched
    thread.join()
    print(f"[tp] the ranks ran {time.perf_counter() - t0:.2f} s from their start (before "
          f"phase 33) to this join")
    _check(len(results) == 2, "phase 44: the ranks did not run")
    for rank, (rc, text) in enumerate(results):
        lines = text.splitlines()
        print(f"[tp gloo x2] rank {rank} exited {rc} after {time.perf_counter() - t0:.2f} s; "
              f"its last lines:\n  " + "\n  ".join(lines[-12 if rc == 0 else -60:]))
        _check(rc == 0, f"phase 44: rank {rank} exited {rc}")
    ranks = [json.load(open(os.path.join(workdir, f"p44_rank{r}.json"))) for r in range(2)]
    _check(all(r["backend"] == "gloo" and r["world"] == 2 for r in ranks), "gloo ranks")

    from PIL import Image

    def pngs(tag):
        return {os.path.basename(p): np.asarray(Image.open(p))
                for p in sorted(glob.glob(os.path.join(workdir, tag, "*.png")))}

    def levels_apart(ref, got):
        if not ref or not got.keys() <= ref.keys():
            return 99
        return max(int(np.abs(ref[f].astype(np.int16) - got[f].astype(np.int16)).max())
                   for f in got)

    for name, n in (("cifar", P44_CIFAR_SEEDS), ("cg", P44_CG_BATCH)):
        ref, got = pngs(f"{name}_one"), pngs(f"{name}_tp")
        levels = levels_apart(ref, got)
        what = (f"CIFAR-10 sampling CLI, {n} seeds (the unit-scale net)" if name == "cifar" else
                f"ImageNet-256 CG sampling CLI, seeds 0-{n - 1} (U-Net and classifier "
                f"tp=2-sharded)")
        # the share of uint8 values at 0 or 255: clipped values hide differences
        clipped = np.mean([np.isin(v, (0, 255)).mean() for v in ref.values()]) if ref else 1.0
        print(f"[tp] {what}, --tp=2, f32: at most {levels} uint8 levels from one process's "
              f"(one process's values clipped at 0 or 255: {clipped:.4f}); rank 0 "
              f"{ranks[0][name]['s']:.2f} s (one process {one[name]['s']:.2f} s); launches per "
              f"rank {[r[name]['counts'] for r in ranks]} (one process {one[name]['counts']})")
        _check(levels <= 1 and len(ref) == len(got) == n,
               f"{name} --tp=2 samples differ from one process's by more than one level")
        _check(all(r[name]["counts"] == one[name]["counts"] for r in ranks)
               and one[name]["counts"]["k1"] > 0 and one[name]["counts"]["gn"] > 0,
               f"{name} --tp=2 launches")
    # the planted fault through the CLI: the gathered parts swapped
    ref, fault = pngs("cifar_one"), pngs("cifar_fault")
    levels = levels_apart(ref, fault)
    print(f"[tp] CIFAR-10 sampling CLI, --tp=2, seeds 0-{P44_FAULT_SEEDS - 1}, planted fault "
          f"(the ranks' parts of each gathered qkv joined in the wrong order): {levels} uint8 "
          f"levels from one process's at most (gate: 1)")
    _check(len(fault) == P44_FAULT_SEEDS and levels > 1,
           "the CIFAR-10 --tp=2 one-level gate does not see a wrong gather")
    for r, rk in enumerate(ranks):
        c = rk["cifar_call"]
        print(f"[tp one call] CIFAR-10 D f32 (the unit-scale net, batch 8, sigma 80 / 10 / 1 / "
              f"0.1), rank {r}: mean |difference| over mean |value| from one process's: --tp=2 "
              f"(the one head gathered) {c['tp']:.4g} (gate {P44_D_TOL:g}); planted faults: "
              f"the gathered parts swapped {c['swapped']:.4g}, {c['planted']} without its sum "
              f"{c['skipped']:.4g}")
        _check(c["tp"] <= P44_D_TOL, "CIFAR-10 --tp=2 D moved from one process's")
        _check(min(c["swapped"], c["skipped"]) > P44_D_TOL,
               "the CIFAR-10 one-call gate does not see a planted fault")
    for r, rk in enumerate(ranks):
        c = rk["cg"]["one_call"]
        bar = P44_ONE_CALL_FACTOR * c["bf16_vs_f32"]
        print(f"[tp one call] ImageNet-256 classifier gradient at sigma_max, bf16, rank {r}: "
              f"mean |difference| over mean |value| from one process's bf16 call: --tp=2 "
              f"{c['tp']:.4g}, one process's f32 call {c['bf16_vs_f32']:.4g} (gate "
              f"{P44_ONE_CALL_FACTOR:g} x: {bar:.4g}), a row-parallel layer's sum skipped "
              f"{c['fault']:.4g}; launches {c['counts']} (expected {c['want']})")
        _check(c["tp"] <= bar, "CG bf16 --tp=2 moved the classifier gradient too far")
        _check(c["fault"] > bar, "the CG one-call gate does not see a skipped sum")
        _check(c["counts"] == c["want"], "CG --tp=2 one call: launches")

    sd1 = np.load(os.path.join(sd_ref_dir, "sd_one_float32.npz"))
    sd2 = np.load(os.path.join(workdir, "sd_tp.npz"))
    levels = np.abs(to_uint8(sd2["images"]).astype(np.int16)
                    - to_uint8(sd1["images"]).astype(np.int16))
    nfe = P43_SD_STEPS - 1
    heads = SD_HEADS // 2
    flat = sum(n for t, d, n in SD_LEVELS if A.takes_flat_kernel(t, heads, d, torch.float32))
    for r, rk in enumerate(ranks):
        want = _only(k1=(SD_SITES - flat) * nfe, k1c=flat * nfe, gn=rk["sd"]["gn"] * nfe)
        print(f"[tp SD] SD v1.5 f32 guided 7.5, seeds 0-1, ipndm NFE {nfe}, U-Net tp=2, rank "
              f"{r}: {rk['sd']['s']:.2f} s sampling ({rk['sd']['setup_s']:.2f} s set-up); "
              f"launches {rk['sd']['counts']} (expected {want}: {heads} heads a rank)")
        _check(rk["sd"]["counts"] == want, f"SD --tp=2 rank {r}: launches")
    print(f"[tp SD] latents max abs diff {np.abs(sd2['latents'] - sd1['latents']).max():.4g}; "
          f"decoded images {levels.max()} uint8 levels from one process's at most, "
          f"{levels.mean():.4f} on average")
    _check(levels.max() <= 1 and np.isfinite(sd2["images"]).all(),
           "SD --tp=2 f32 images more than one level from one process's")

    for kind, what in (("cifar", "CIFAR-10 --tp=2"), ("sd", "SD v1.5 --fsdp")):
        for r, rk in enumerate(ranks):
            s_, one1 = rk[f"sfd_{kind}"], rk[f"sfd_{kind}"]["one"]
            print(f"[tp SFD] {what}, one iteration at batch {P44_SFD_BATCH[kind]}, f32, TF32 "
                  f"off, rank {r}: losses {s_['losses']} (one process, the same microbatches "
                  f"in this rank: {one1['losses']}); student weights max abs diff "
                  f"{s_['diff']:.3g} (tol {P44_TOL}); Adam's first moment max abs diff "
                  f"{s_['mu_diff']:.3g} (tol {P44_MOMENT_TOL} x {s_['mu_scale']:.3g}); "
                  f"parameters resident {s_['param_bytes'] / 2**30:.3f} GiB (student + teacher; "
                  f"one process {one1['param_bytes'] / 2**30:.3f}), Adam's moments "
                  f"{s_['adam_bytes'] / 2**30:.3f} GiB (one process "
                  f"{one1['adam_bytes'] / 2**30:.3f}), peak {s_['peak'] / 2**30:.3f} GiB (one "
                  f"process {one1['peak'] / 2**30:.3f}); the step {s_['s']:.2f} s (one process "
                  f"{one1['s']:.2f}); launches {s_['counts']} (one process {one1['counts']})")
            _check(s_["same_keys"] and s_["diff"] <= P44_TOL
                   and s_["mu_diff"] <= P44_MOMENT_TOL * s_["mu_scale"],
                   f"{what} rank {r}: the student moved away from one process's")
            f = s_["fault"]
            print(f"[tp SFD] {what}, rank {r}, planted fault ({f['planted']}): Adam's first "
                  f"moment max abs diff {f['mu_diff']:.3g} (gate {P44_MOMENT_TOL} x "
                  f"{s_['mu_scale']:.3g}), weights {f['diff']:.3g}; losses {f['losses']}")
            _check(f["same_keys"] and f["mu_diff"] > P44_MOMENT_TOL * s_["mu_scale"],
                   f"{what} rank {r}: the first-moment gate does not see the planted fault")
            _check(s_["param_bytes"] < one1["param_bytes"]
                   and s_["adam_bytes"] < one1["adam_bytes"], f"{what}: bytes")
            # each rank runs every site once a call, on its heads or its rows
            _check(s_["counts"] == one1["counts"]
                   if kind == "cifar" else all(s_["counts"][k] * 2 == one1["counts"][k]
                                               for k in s_["counts"]),
                   f"{what} rank {r}: launches")
    for r, rk in enumerate(ranks):
        a, one1 = rk["amed"], rk["amed"]["one"]
        print(f"[tp AMED] LSUN LDM --fsdp, one iteration at batch {P44_AMED_BATCH}, f32, TF32 "
              f"off, rank {r}: losses {a['losses']} (one process in microbatches of "
              f"{P44_AMED_BATCH // 2}, this rank's: {one1['losses']}); predictor max abs diff "
              f"{a['diff']:.3g} (tol {P44_TOL} * {a['scale']:.3g}, as phase 43's); the frozen "
              f"U-Net resident {a['unet_bytes'] / 2**30:.3f} GiB (one process "
              f"{one1['unet_bytes'] / 2**30:.3f}); peak {a['peak'] / 2**30:.3f} GiB (one "
              f"process {one1['peak'] / 2**30:.3f}); the step {a['s']:.2f} s (one process "
              f"{one1['s']:.2f}, set-up {a['setup_s']:.2f}); launches {a['counts']} (one "
              f"process {one1['counts']})")
        _check(a["same_keys"] and a["diff"] <= P44_TOL * a["scale"], "AMED --fsdp predictor")
        _check(a["unet_bytes"] < one1["unet_bytes"], "AMED --fsdp bytes")
        _check(all(a["counts"][k] * 2 == one1["counts"][k] for k in a["counts"]),
               "AMED --fsdp launches: half the one process's two microbatches")

    # K1 / K2 / K3 at the tp=2 shards' local shapes of these paths
    k1 = _k1_checks("tp K1", P44_K1_SHAPES, _legacy_views, seed=441, reps=5, warmup=2)
    k2 = _k2_checks("tp K2", P44_K2_SHAPES, _legacy_views, seed=442)
    k3 = _gn_checks(P44_GN_SHAPES, {"local": P44_GN_SHAPES[0][:5]}, seed=443, groups=16)
    r0 = ranks[0]
    tp_paths = ("cifar", "cg")
    return dict(k1=k1, k2=k2, k3=k3["local"],
                k1_f32=sum(r0[p]["counts"]["k1"] for p in tp_paths) + r0["sd"]["counts"]["k1"]
                + r0["sfd_cifar"]["counts"]["k1"],
                k1_bf16=r0["cg"]["one_call"]["counts"]["k1"],
                k2_f32={k: r0["cg"]["counts"][k] + r0["sfd_cifar"]["counts"][k]
                        for k in ("dq", "dkv")},
                k2_bf16={k: r0["cg"]["one_call"]["counts"][k] for k in ("dq", "dkv")},
                gn=sum(r0[p]["counts"]["gn"] for p in tp_paths) + r0["sd"]["counts"]["gn"]
                + r0["sfd_cifar"]["counts"]["gn"] + r0["cg"]["one_call"]["counts"]["gn"])


# ---------------------------------------------------------------------------
# Phase 45: the KL encoder, LPIPS in SFD's second stage, the augment pipe
# with augment labels and dropout, and the parameter EMA
# ---------------------------------------------------------------------------

KL_BATCH = 8  # 512 x 512 images an encode
KL_ENC_GN_SITES = 22  # K3 per SD v1.5 encode: 16 in the down levels, 5 in mid, norm_out
KL_DEC_GN_SITES = 30  # K3 per KL decode
KL_GN_SHAPE = (KL_BATCH, 512, 512, 128, torch.float32, 1e-6, True)  # the encoder's main norm
KL_TOL = 1e-4  # of max|plain|: the moments and the round trip, TF32 off
LPIPS_ITERS = 2  # second-stage iterations at SFD_BATCH with LPIPS (the second one steady)
PLAIN_ITERS = 1  # and without it, after them (cuDNN's plans warm): cut for the script's time
LPIPS_CHECK_N = 2  # image pairs of the premetric gates (card, and card against the CPU)
LPIPS_ZERO_TOL = 1e-6  # of max d: identical inputs and swapped arguments
LPIPS_CPU_TOL = 1e-4  # of max|CPU d|
# EDM's CIFAR-10 pipe (train.py: --augment=0.12 with these probabilities)
EDM_AUGMENT = dict(p=0.12, xflip=1e8, yflip=1, scale=1, rotate_frac=1, aniso=1,
                   translate_frac=1)
AUGMENT_BATCH = 512
AUGMENT_GRAD_BATCH = 128  # the train-mode weight gradient: the batch's first 128
WARP_TOL = 1e-5  # of max|CPU|: the card's pipe against the CPU's on the same draws


@torch.no_grad()
def phase_kl_encode(workdir: str) -> dict:
    """Phase 45a (in phase 32's directory, beside phase 44's ranks: gates
    only, nothing timed): SD v1.5 from phase 32's f16 checkpoint with its
    first stage's encoder (``build_latent_diffusion(..., encoder=True)``;
    the text tower's keys left out), 8 images of 512 x 512 encoded in f32
    with TF32 off: the posterior's mean and logvar and the round trip
    ``decode(encode(x).mode())`` with K3 against the all-plain first stage
    (``reference_groupnorm_silu``) at 1e-4 * max, exactly 22 K3 launches an
    encode and 30 more in the decode.  Returns the first stage and the
    images (phase 45 times them) and the launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    path = os.path.join(workdir, "v1-5-pruned-emaonly.ckpt")
    t0 = time.perf_counter()
    sd = {k: v for k, v in load_checkpoint_params(path).items()
          if not k.startswith("cond_stage_model.")}
    ld = build_latent_diffusion(SD, state_dict=sd, encoder=True, device="cuda")
    first = ld.first_stage
    del ld, sd
    torch.cuda.empty_cache()
    load_s = time.perf_counter() - t0
    g = torch.Generator("cuda").manual_seed(45)
    x = torch.rand((KL_BATCH, *SD_IMAGE), generator=g, device="cuda") * 2 - 1
    _reset_counts()
    post = first.encode(x)
    enc_counts = _counts()
    round_trip = first.decode(post.mode())
    counts = _counts()
    real = adm.groupnorm_silu
    adm.groupnorm_silu = G.reference_groupnorm_silu
    try:
        plain = first.encode(x)
        plain_round_trip = first.decode(plain.mode())
    finally:
        adm.groupnorm_silu = real
    torch.cuda.synchronize()
    print(f"[KL encode] SD v1.5 from {os.path.basename(path)} with its encoder (the text tower "
          f"left out): {load_s:.2f} s host clock; x [{KL_BATCH}, 512, 512, 3] -> the "
          f"posterior's mean {list(post.mean.shape)}, f32, TF32 off; launches: the encode "
          f"{enc_counts}, with the round trip's decode {counts}")
    _check(tuple(post.mean.shape) == (KL_BATCH, 64, 64, 4), "KL encode: latent shape")
    for name, got, want in (("mean", post.mean, plain.mean), ("logvar", post.logvar,
                                                              plain.logvar),
                            ("decode(encode(x).mode())", round_trip, plain_round_trip)):
        err = (got - want).abs().max().item()
        bound = KL_TOL * want.abs().max().item()
        print(f"[KL encode] {name}: max {want.abs().max().item():.4g}, K3 vs the plain GroupNorm "
              f"max abs err {err:.3g} (tol {KL_TOL:g} * max = {bound:.3g})")
        _check(torch.isfinite(got).all().item(), f"KL encode: {name} is not finite")
        _check(err <= bound, f"KL encode: {name} with K3 disagrees with the plain first stage")
    _check(enc_counts == _only(gn=KL_ENC_GN_SITES), f"KL encode: launches {enc_counts}")
    _check(counts == _only(gn=KL_ENC_GN_SITES + KL_DEC_GN_SITES),
           f"KL encode: round-trip launches {counts}")
    return dict(first=first, x=x, gn=counts["gn"])


def _p45_encode_times(kl: dict) -> dict:
    """Phase 45 (a, after the ranks): one profiled encode (K3's share of its
    device time, 22 K3 launches in the trace), the encode's ms (CUDA events,
    warm), and K3 at the encoder's main shape [8, 512, 512, 128] f32 (SiLU,
    eps 1e-6) against its plain version, the library and its byte bound."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    first, x = kl.pop("first"), kl.pop("x")

    def encode():
        return first.encode(x).mean

    prof = _profile(f"KL encode profile, one f32 encode of {KL_BATCH} x 512 x 512", encode,
                    {"K3": KL_ENC_GN_SITES})
    with torch.no_grad():
        ms = _time_ms(encode, reps=2, warmup=0)
    k3_share = prof["categories"]["K3"]["share"]
    print(f"[KL encode] one encode of {KL_BATCH} images: {ms:.3f} ms (CUDA events, "
          f"{KL_BATCH / ms * 1e3:.2f} images/s); K3 {prof['categories']['K3']['ms']:.3f} ms, "
          f"{k3_share:.4f} of the profiled device time")
    del first, x
    torch.cuda.empty_cache()
    k3 = _gn_checks([KL_GN_SHAPE], {"KL encoder": KL_GN_SHAPE[:5]}, seed=450)["KL encoder"]
    return dict(kl_k3=k3, kl_gn=kl["gn"])


def _lpips_files(workdir: str, lp: LPIPS) -> tuple:
    """Seeded weights in LPIPS's shapes, written as torchvision's VGG16 file
    (``features.*``: He-normal convs, small biases) and the LPIPS package's
    heads file (``lin{i}.model.1.weight``, uniform in [0, 1)); returns the
    two paths."""
    g = torch.Generator().manual_seed(451)
    vgg, lin = {}, {}
    for name, p in lp.state_dict().items():
        if name.startswith("features.") and name.endswith("weight"):
            vgg[name] = torch.randn(p.shape, generator=g) * math.sqrt(2.0 / p[0].numel())
        elif name.startswith("features."):
            vgg[name] = 0.01 * torch.randn(p.shape, generator=g)
        else:
            lin[name] = torch.rand(p.shape, generator=g)
    paths = os.path.join(workdir, "vgg16-397923af.pth"), os.path.join(workdir, "vgg.pth")
    for path, sd in zip(paths, (vgg, lin)):
        torch.save(sd, path)
    return paths


def _lpips_flops(lp: LPIPS, n: int) -> int:
    """The multiply-adds x 2 of LPIPS's VGG16 convs on n images of
    ``resize_to`` (x and y: 2n), from the shapes; the rest is elementwise."""
    size, flops = lp.resize_to, 0
    for i, conv in enumerate(lp.features.values()):
        if i in (2, 4, 7, 10):  # an average pool before stages 2-5
            size //= 2
        flops += 2 * size * size * conv.weight.numel()
    return 2 * n * flops


def _p45_lpips(workdir: str) -> dict:
    """Phase 45 (b): LPIPS at 224 from a torchvision-layout VGG16 file and
    an LPIPS-layout heads file, in f32 with TF32 off as in phase 37: the
    premetric on the card (0 on identical inputs, symmetric) and against the
    CPU's on the same weights; the full-width CIFAR-10 student (unit scale,
    remat) and teacher (another unit-scale draw) of SFD's second stage: the
    last segment's weight gradient with LPIPS, K1 + K2 + K3 against the
    all-plain student, 1e-4 * max, exact launches; two iterations at batch
    128 of ``training/sfd.py``'s step with ``lpips_fn`` and one without
    (s/iteration, exact launches); the LPIPS forward at batch 128 against
    its f32 bound.  Returns the launches and the student (phase 45 (c)'s
    net)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    vgg_path, lin_path = _lpips_files(workdir, LPIPS(device="cpu"))
    lp = load_lpips_weights(LPIPS(device="cuda"), load_torch_file(vgg_path),
                            load_torch_file(lin_path)).requires_grad_(False)
    g = torch.Generator("cuda").manual_seed(452)
    a, b = (torch.rand((LPIPS_CHECK_N, 32, 32, 3), generator=g, device="cuda") * 2 - 1
            for _ in range(2))
    with torch.no_grad():
        d_ab, d_ba, d_aa = lp(a, b), lp(b, a), lp(a, a)
        d_cpu = copy.deepcopy(lp).cpu()(a.cpu(), b.cpu())
    top = d_ab.abs().max().item()
    cpu_err = (d_ab.cpu() - d_cpu).abs().max().item()
    print(f"[LPIPS] VGG16 + heads from {os.path.basename(vgg_path)} and "
          f"{os.path.basename(lin_path)}, 32 px pairs resized to 224, f32: d(a, b) "
          f"{[round(v, 5) for v in d_ab.tolist()]}; max |d(a, a)| {d_aa.abs().max().item():.3g}, "
          f"max |d(a, b) - d(b, a)| {(d_ab - d_ba).abs().max().item():.3g} (tol "
          f"{LPIPS_ZERO_TOL:g} * max d); the CPU's on the same weights: max abs err "
          f"{cpu_err:.3g} (tol {LPIPS_CPU_TOL:g} * max = {LPIPS_CPU_TOL * top:.3g})")
    _check(top > 0 and torch.isfinite(d_ab).all().item(), "LPIPS: d(a, b) not positive")
    _check(d_aa.abs().max().item() <= LPIPS_ZERO_TOL * top, "LPIPS: d(a, a) is not 0")
    _check((d_ab - d_ba).abs().max().item() <= LPIPS_ZERO_TOL * top, "LPIPS is not symmetric")
    _check(cpu_err <= LPIPS_CPU_TOL * d_cpu.abs().max().item(), "LPIPS: card and CPU disagree")

    student = init_params(build_edm_model("cifar10", sigma_min=0.006, remat=True,
                                          device="cuda"))
    _redraw_unit_scale(student, seed=1, device="cuda")
    teacher = copy.deepcopy(student).requires_grad_(False)
    _redraw_unit_scale(teacher, seed=2, device="cuda")
    for name, p in student.named_parameters():
        p.requires_grad_(not absent_from_jax(name))
    params = [p for p in student.parameters() if p.requires_grad]
    cfg = SFDConfig(num_steps=SFD_STEPS, M=SFD_M, afs=True, is_second_stage=True,
                    sigma_min=0.006)
    t = torch.tensor(get_schedule(SFD_STEPS, 0.006, 80.0), dtype=torch.float32, device="cuda")
    opt = torch.optim.Adam(params, lr=5e-5, betas=(0.9, 0.999), eps=1e-8)
    step = make_sfd_train_step(student, teacher, cfg, opt, lpips_fn=lp)
    traj = step.teacher_traj(stacked_randn(range(SFD_CHECK_BATCH), (32, 32, 3),
                                           device="cuda"), None)
    x, tea = traj[-2], traj[-1]

    def grads():
        stu = x + (t[-1] - t[-2]) * (x - student(x, t[-2])) / t[-2]
        elem = (stu - tea).abs() + lp(stu, tea).mean()
        return torch.autograd.grad(elem.sum() / x.shape[0], params)

    re = _remat_sites(student.model)
    per = dict(k1=ATTENTION_SITES + re["k1"], dq=ATTENTION_SITES, dkv=ATTENTION_SITES,
               gn=CIFAR_GN_SITES + re["gn"])
    print(f"[SFD LPIPS] second stage, the last segment (sigma {t[-2].item():.4f} -> "
          f"{t[-1].item():.4f}) at batch {SFD_CHECK_BATCH} from the teacher's trajectory, "
          f"lpips(student, teacher).mean() on every element")
    got = _param_grads_vs_plain("SFD LPIPS last-segment gradient", grads,
                                _plain_net_patches(layers), per)
    del got, traj, x, tea

    it_calls = SFD_TEA_CALLS + SFD_STU_CALLS
    out = {}
    for label, fn, iters in (("with LPIPS", lp, LPIPS_ITERS), ("without LPIPS", None,
                                                               PLAIN_ITERS)):
        want = _only(k1=iters * (it_calls * ATTENTION_SITES + SFD_STU_CALLS * re["k1"]),
                     gn=iters * (it_calls * CIFAR_GN_SITES + SFD_STU_CALLS * re["gn"]),
                     dq=iters * SFD_STU_CALLS * ATTENTION_SITES,
                     dkv=iters * SFD_STU_CALLS * ATTENTION_SITES)
        step = make_sfd_train_step(student, teacher, cfg, opt, lpips_fn=fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        secs, losses = [], []
        for it in range(iters):
            lat = stacked_randn(range(it * SFD_BATCH, (it + 1) * SFD_BATCH), (32, 32, 3),
                                device="cuda")
            start, end = _events()
            start.record()
            losses.append(step(lat)["loss"].item())
            end.record()
            torch.cuda.synchronize()
            secs.append(start.elapsed_time(end) / 1000)
        counts = _counts()
        print(f"[SFD LPIPS] {label}: {iters} iteration(s) of {SFD_BATCH} (num_steps "
              f"{SFD_STEPS}, M {SFD_M}, the euler teacher, AFS, remat), s/iteration "
              f"{[round(v, 4) for v in secs]} (CUDA events; the first with LPIPS includes "
              f"cuDNN's plans), losses {[round(v, 4) for v in losses]}, torch.cuda.max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {counts}")
        _check(all(math.isfinite(v) for v in losses), f"SFD LPIPS: {label}: losses not finite")
        _check(counts == want, f"SFD LPIPS: {label}: launches {counts}, expected {want}")
        out[label] = dict(secs=secs, counts=counts)
    a, b = (stacked_randn(range(k, k + SFD_BATCH), (32, 32, 3), device="cuda").clamp(-1, 1)
            for k in (0, SFD_BATCH))
    with torch.no_grad():
        ms = _time_ms(lambda: lp(a, b), reps=3, warmup=1)
    flops = _lpips_flops(lp, SFD_BATCH)
    bound = flops / PEAK_FLOPS[torch.float32] * 1e3
    steady = {k: v["secs"][-1] for k, v in out.items()}
    print(f"[SFD LPIPS] the LPIPS forward at batch {SFD_BATCH} (2 x {SFD_BATCH} images at 224): "
          f"{ms:.3f} ms, its f32 bound {bound:.3f} ms ({flops / 1e12:.3f} TFLOP of VGG16 convs "
          f"over 67 TFLOP/s, TF32 off), {bound / ms:.3f} of it; the second iteration "
          f"{steady['with LPIPS']:.4f} s with LPIPS, {steady['without LPIPS']:.4f} s without "
          f"(LPIPS's share {1 - steady['without LPIPS'] / steady['with LPIPS']:.4f})")
    del teacher, opt, step, lp, a, b
    torch.cuda.empty_cache()
    return dict(lpips_counts=out["with LPIPS"]["counts"], net=student)


def _p45_augment_and_ema(net) -> dict:
    """Phase 45 (c): EDM's CIFAR-10 augment pipe on 512 images, the card's
    result against the CPU's on the same draws (1e-5 * max); one weight
    gradient of the full-width CIFAR-10 EDMPrecond ``net`` (phase 45 (b)'s
    student, unit scale, remat off, every weight trained; f32, TF32 off) in
    train mode (dropout 0.13) on the first 128 augmented images with
    their augment labels, under EDM's loss, K1 + K2 + K3 against the
    all-plain net on the same dropout masks (one seeded generator each), 1e-4
    * max, exact launches; then one ``ema_update`` over the LSUN-Bedroom LDM
    U-Net's f32 parameters, bit-equal to the plain formula tensor by tensor,
    timed against its byte bound (read two, write one) and the per-tensor
    loop."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = AugmentPipe(**EDM_AUGMENT)
    _check(pipe.label_dim == 9, f"augment pipe: {pipe.label_dim} labels, EDM's augment_dim is 9")
    g = torch.Generator("cuda").manual_seed(453)
    images = torch.rand((AUGMENT_BATCH, 32, 32, 3), generator=g, device="cuda") * 2 - 1
    draws = pipe.draw(AUGMENT_BATCH, 32, 32, g, "cuda")
    aug = pipe.apply(images, draws)
    aug_cpu = pipe.apply(images.cpu(), draws.to("cpu"))
    err = (aug.cpu() - aug_cpu).abs().max().item()
    bound = WARP_TOL * aug_cpu.abs().max().item()
    with torch.no_grad():
        ms = _time_ms(lambda: pipe(images, g), reps=5, warmup=1)
    moved = (draws.labels != 0).any(1).sum().item()
    print(f"[augment] EDM's CIFAR-10 pipe {EDM_AUGMENT} on {AUGMENT_BATCH} images: "
          f"{moved} with a transform, {int((draws.labels[:, 0] == 1).sum().item())} x-flipped; "
          f"the card against the CPU on the same draws: max abs err {err:.3g} (tol "
          f"{WARP_TOL:g} * max = {bound:.3g}); one call (draws and apply) {ms:.3f} ms")
    _check(torch.isfinite(aug).all().item() and err <= bound,
           "augment pipe: the card's warp disagrees with the CPU's")

    net.model.remat = False
    net.requires_grad_(True).train()
    n = AUGMENT_GRAD_BATCH
    y, labels = aug[:n], draws.labels[:n]
    sigma = (torch.randn(n, generator=g, device="cuda") * 1.2 - 1.2).exp()  # EDM's P_mean, P_std
    noisy = y + torch.randn(y.shape, generator=g, device="cuda") * sigma[:, None, None, None]
    weight = ((sigma ** 2 + 0.25) / (sigma * 0.5) ** 2)[:, None, None, None]
    params = list(net.parameters())

    def grads():
        masks = torch.Generator("cuda").manual_seed(454)
        d = net(noisy, sigma, augment_labels=labels, generator=masks)
        return torch.autograd.grad((weight * (d - y) ** 2).sum() / n, params)

    print(f"[train mode] the CIFAR-10 EDMPrecond in train mode (dropout "
          f"{net.model.enc['32x32_block0'].dropout_rate}), EDM's loss at batch {n}, sigma "
          f"lognormal(-1.2, 1.2), the pipe's augment labels through map_augment")
    got = _param_grads_vs_plain("train-mode weight gradient", grads, _plain_net_patches(layers),
                                dict(k1=ATTENTION_SITES, dq=ATTENTION_SITES, dkv=ATTENTION_SITES,
                                     gn=CIFAR_GN_SITES))
    train_counts = _counts()
    aug_grad = got[[name for name, _ in net.named_parameters()].index("model.map_augment.weight")]
    with torch.no_grad():
        masks = torch.Generator("cuda").manual_seed(454)
        d_train = net(noisy, sigma, augment_labels=labels, generator=masks)
        net.eval()
        d_eval = net(noisy, sigma, augment_labels=labels)
    print(f"[train mode] map_augment's gradient max {aug_grad.abs().max().item():.4g}; D in "
          f"train mode against eval mode: max abs diff {(d_train - d_eval).abs().max().item():.4g}")
    _check(aug_grad.abs().max().item() > 0, "train mode: the augment labels reach no weight")
    _check((d_train - d_eval).abs().max().item() > 0, "train mode: dropout did nothing")
    del net, got, params, aug_grad, d_train, d_eval, images, aug, aug_cpu
    torch.cuda.empty_cache()

    shapes = {k: p.shape for k, p in LDMUNet(device="meta", **LDM_CONFIGS[LDM]["unet"])
              .named_parameters()}
    p0 = {k: torch.randn(shape, generator=g, device="cuda") for k, shape in shapes.items()}
    p1 = {k: v + 0.01 * torch.randn(v.shape, generator=g, device="cuda") for k, v in p0.items()}
    state = ema_init(p0)
    c = torch.ones((), device="cuda")
    d = torch.clamp((1.0 + c) / (10.0 + c), max=0.9999)
    want = {k: e - (1.0 - d) * (e - p1[k]) for k, e in p0.items()}
    state = ema_update(state, p1)
    same = all(torch.equal(state.params[k], want[k]) for k in want)
    del want
    count = sum(v.numel() for v in p0.values())
    ms = _time_ms(lambda: ema_update(state, p1), reps=10, warmup=2)

    def loop():
        w = 1.0 - torch.clamp((1.0 + c) / (10.0 + c), max=0.9999)
        for k, e in state.params.items():
            e.sub_(w * (e - p1[k]))

    loop_ms = _time_ms(loop, reps=3, warmup=1)
    nbytes = 3 * 4 * count
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"[EMA] ema_update over the LSUN-Bedroom LDM U-Net's {len(p0)} f32 tensors "
          f"({count / 1e6:.1f}M parameters): bit-equal to e - (1 - d) * (e - p) tensor by "
          f"tensor {same}; {ms:.4f} ms (CUDA events), bound {bound:.4f} ms ({nbytes / 1e9:.3f} "
          f"GB: the averages and the parameters read, the averages written, over 3.35 TB/s), "
          f"{bound / ms:.3f} of it; the per-tensor loop {loop_ms:.4f} ms; count "
          f"{int(state.count)}")
    _check(same, "EMA: ema_update differs from the plain formula")
    del p0, p1, state
    torch.cuda.empty_cache()
    return dict(train_counts=train_counts)


def _p45_attention_rows(sfd: dict, fwd32: str, bwd32: str, tpu: str) -> list:
    """(name, source, TPU kernel, launch key, fields) of K1 / K2 / K3 in f32
    at the CIFAR-10 student's [128, ...] shapes, whose times phase 37
    measured: the rows of phase 45's CIFAR-10 paths."""
    return [("flash_attention_mh in f32 at [128, 256, 1, 256] (K1 in 3xTF32)", fwd32,
             f"{tpu}:157", "k1", sfd["k1"]),
            ("flash_attention_bwd_dq in f32 at [128, 256, 1, 256] (K2 dQ in 3xTF32)", bwd32,
             f"{tpu}:406", "dq", sfd["k2"]["dq"]),
            ("flash_attention_bwd_dkv in f32 at [128, 256, 1, 256] (K2 dK/dV in 3xTF32)", bwd32,
             f"{tpu}:554", "dkv", sfd["k2"]["dkv"]),
            (f"groupnorm_silu in f32 at [128, 32, 32, 256] (K3, route {sfd['k3']['route']})",
             "diff_sampler_tpu_torch/csrc/groupnorm.cu",
             "diff_sampler_tpu/ops/pallas_groupnorm.py:29", "gn", sfd["k3"])]


def phase_last_modules(kl: dict, workdir: str) -> dict:
    """Phase 45 (after phase 40, the ranks joined; 45a's gates ran beside
    them): the KL encode's times, LPIPS in SFD's second stage, the augment
    pipe with augment labels and dropout, and the parameter EMA."""
    out = _p45_encode_times(kl)
    out.update(_p45_lpips(workdir))
    out.update(_p45_augment_and_ema(out.pop("net")))
    return out


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
        export_counts = _phase("phase 42, the AMED export of phase 8's predictor",
                               phase_amed_export, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        analyzer = _phase("phase 41, the trajectory analyzer on CIFAR-10", phase_analyzer,
                          workdir)
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
    ldm_k1, k2b = _phase("phase 16, K1 / K2 at the LSUN LDM shapes",
                         phase_ldm_attention_kernels)
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
    with tempfile.TemporaryDirectory() as edm_dir:
        ckpt_edm = _phase("phase 31, CIFAR-10 from its checkpoint files", phase_checkpoint_edm,
                          edm_dir)
        # phase 44's two ranks run beside phases 33 and 32, then beside
        # phases that time nothing (see _p44_launch)
        p44_dir = tempfile.mkdtemp()
        p44_ranks = _p44_launch(p44_dir)
        eval_counts = _phase("phase 33, FID and PRDC of CIFAR-10 samples", phase_eval, edm_dir,
                             os.path.join(edm_dir, EDM_PKL))
        with tempfile.TemporaryDirectory() as workdir:
            ckpt_sd = _phase("phase 32, Stable Diffusion from a checkpoint, with its text tower",
                             phase_checkpoint_sd, workdir)
            # while the ranks finish: phases that time nothing, and phase
            # 44's one-process references; the precision flags as they were
            flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.deterministic)
            _phase("phase 35a, ImageNet-256 classifier-guided D f32", phase_cg_denoiser)
            _phase("phase 35c, the ImageNet-256 AMED step refuses on the card",
                   phase_cg_amed_refusal)
            p44_one = _phase("phase 44's one-process references", phase_p44_references, p44_dir)
            kl = _phase("phase 45a, the SD v1.5 KL encode from phase 32's checkpoint (gates)",
                        phase_kl_encode, workdir)
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic) = flags
            t_wait = time.perf_counter()
            p44_ranks[0].join()  # before phase 39's memory
            print(f"[time] waiting for phase 44's ranks after phases 32, 35a, 35c, 44's "
                  f"references and 45a: {time.perf_counter() - t_wait:.2f} s", flush=True)
            sfd_sd = _phase("phase 39, the SD student from phase 32's checkpoint", phase_sfd_sd,
                            workdir)
            _phase("phase 40, the CLIP score at ViT-g-14's width", phase_clip_score, workdir,
                   os.path.join(edm_dir, "samples"))
            p45 = _phase("phase 45, the KL encode's times, LPIPS in SFD's second stage, the "
                         "augment pipe with augment labels and dropout, the EMA",
                         phase_last_modules, kl, workdir)
    adm_k = _phase("phase 34a, K1 / K2 / K3 at the 256 px shapes", phase_adm_kernels)
    _phase("phase 34b, LSUN-Bedroom 256 (CM) D and gradient f32",
           phase_cm_denoiser_and_gradient)
    cm_counts = _phase("phase 34c, LSUN-Bedroom 256 sampling and CLI", phase_cm_sampling)
    with tempfile.TemporaryDirectory() as workdir:
        cm_amed = _phase("phase 34d, LSUN-Bedroom 256 AMED", phase_cm_amed, workdir)
    cg_counts = _phase("phase 35b, ImageNet-256 classifier-guided sampling, CLI, split, profile",
                       phase_cg_sampling)
    with tempfile.TemporaryDirectory() as workdir:
        _phase("phase 36, the 256 px tiers from checkpoint files", phase_adm_checkpoints,
               workdir)
    with tempfile.TemporaryDirectory() as workdir:
        sfd = _phase("phase 37, SFD on CIFAR-10 through train_sfd", phase_sfd_cifar, workdir)
        sfd_ldm = _phase("phase 38, the LSUN LDM student through train_sfd", phase_sfd_ldm,
                         workdir)
    with tempfile.TemporaryDirectory() as workdir:
        par = _phase("phase 43, data and sequence parallelism", phase_parallel, workdir)
        tp = _phase("phase 44, tensor parallelism and FSDP (the ranks ran beside phases 33, "
                    "32, 35a and 35c)", phase_tensor_parallel, p44_dir, p44_ranks, p44_one,
                    workdir)
    shutil.rmtree(p44_dir, ignore_errors=True)
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
                     cg_counts["dkv"]),
                    ("K1 f32 on the CIFAR-10 SFD student", sfd["counts"]["k1"]),
                    ("K2 dQ f32 on the CIFAR-10 SFD student", sfd["counts"]["dq"]),
                    ("K2 dK/dV f32 on the CIFAR-10 SFD student", sfd["counts"]["dkv"]),
                    ("K3 f32 on the CIFAR-10 SFD student", sfd["counts"]["gn"]),
                    ("K1 f32 on the LSUN LDM SFD student", sfd_ldm["counts"]["k1"]),
                    ("K2 dQ f32 on the LSUN LDM SFD student at T=1024", sfd_ldm["at_1024"]["dq"]),
                    ("K2 dK/dV f32 on the LSUN LDM SFD student at T=1024",
                     sfd_ldm["at_1024"]["dkv"]),
                    ("K1 f32 on the SD SFD student", sfd_sd["counts"]["k1"]),
                    ("K1c on the SD SFD student", sfd_sd["counts"]["k1c"]),
                    ("K2 dQ f32 on the SD SFD student", sfd_sd["counts"]["dq"]),
                    ("K2 dK/dV f32 on the SD SFD student", sfd_sd["counts"]["dkv"]),
                    ("K2c dQ on the SD SFD student", sfd_sd["counts"]["dqc"]),
                    ("K2c dK/dV on the SD SFD student", sfd_sd["counts"]["dkvc"]),
                    ("K1 f32 on the trajectory analyzer", analyzer["counts"]["k1"]),
                    ("K3 f32 on the trajectory analyzer", analyzer["counts"]["gn"]),
                    ("K1 f32 on the AMED export", export_counts["k1"]),
                    ("K3 f32 on the AMED export", export_counts["gn"]),
                    ("K1 bf16 in the ring on SD --sp=2", par["sd_k1"]["bfloat16"]),
                    ("K1 f32 in the ring on SD --sp=2", par["sd_k1"]["float32"]),
                    ("K2 dQ / dK/dV f32 in the ring on CIFAR-10 AMED --sp=2",
                     min(par["amed_sp"].values())),
                    ("K2 dQ / dK/dV bf16 in the ring on ImageNet-256 CG --sp=2",
                     min(par["cg"].values())),
                    ("K3 f32 on the SD v1.5 KL encode and its round trip", p45["kl_gn"]),
                    *((f"{k} f32 on the CIFAR-10 SFD second stage with LPIPS",
                       p45["lpips_counts"][k]) for k in ("k1", "dq", "dkv", "gn")),
                    *((f"{k} f32 on the CIFAR-10 train-mode gradient with augment labels",
                       p45["train_counts"][k]) for k in ("k1", "dq", "dkv", "gn"))):
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
        _kernel_entry("flash_attention_mh in f32 at the CIFAR-10 SFD student's [128, 256, 1, 256] "
                      "(K1 in 3xTF32; phase 37: train_sfd at batch 128, the forward of every "
                      "net call and remat's recompute)", fwd32, f"{tpu}:157", sfd["counts"]["k1"],
                      sfd["k1"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at the CIFAR-10 SFD student's [128, 256, 1, "
                      "256] (K2 dQ in 3xTF32, phase 37)", bwd32, f"{tpu}:406",
                      sfd["counts"]["dq"], sfd["k2"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at the CIFAR-10 SFD student's [128, 256, 1, "
                      "256] (K2 dK/dV in 3xTF32, phase 37)", bwd32, f"{tpu}:554",
                      sfd["counts"]["dkv"], sfd["k2"]["dkv"]),
        _kernel_entry(f"groupnorm_silu in f32 (K3 on the CIFAR-10 SFD student at [128, 32, 32, "
                      f"256], route {sfd['k3']['route']}, phase 37)",
                      "diff_sampler_tpu_torch/csrc/groupnorm.cu",
                      "diff_sampler_tpu/ops/pallas_groupnorm.py:29", sfd["counts"]["gn"],
                      sfd["k3"]),
        _kernel_entry("flash_attention_mh in f32 at d=32 (K1 in 3xTF32 in place of K1b, LSUN LDM "
                      "SFD student in microbatches of 128, phase 38; times at T=1024 H=14 of "
                      "phase 16)", fwd32, f"{tpu}:227", sfd_ldm["counts"]["k1"],
                      ldm_k1["float32"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at T=1024 H=14 d=32 (K2 dQ in 3xTF32 in "
                      "place of K2b, LSUN LDM SFD student, phase 38; times of phase 16)", bwd32,
                      f"{tpu}:699", sfd_ldm["at_1024"]["dq"], k2b["main"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at T=1024 H=14 d=32 (K2 dK/dV in 3xTF32 in "
                      "place of K2b, LSUN LDM SFD student, phase 38; times of phase 16)", bwd32,
                      f"{tpu}:757", sfd_ldm["at_1024"]["dkv"], k2b["main"]["dkv"]),
        _kernel_entry("flash_attention_mh in f32 at d=80/160 (K1 in 3xTF32, SD SFD student's "
                      "microbatch of 4, phase 39; times at [4, 1024, 8, 80])", fwd32,
                      f"{tpu}:157", sfd_sd["counts"]["k1"], sfd_sd["k1"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at d=80/160 (K2 dQ in 3xTF32, SD SFD "
                      "student, phase 39)", bwd32, f"{tpu}:406", sfd_sd["counts"]["dq"],
                      sfd_sd["k2"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at d=80/160 (K2 dK/dV in 3xTF32, SD SFD "
                      "student, phase 39)", bwd32, f"{tpu}:554", sfd_sd["counts"]["dkv"],
                      sfd_sd["k2"]["dkv"]),
        _kernel_entry("flash_attention (K1c in 3xTF32 at the SD SFD student's flat [32, 4096, "
                      "40], phase 39)", fwd32, f"{tpu}:49", sfd_sd["counts"]["k1c"],
                      sfd_sd["k1c"]),
        _kernel_entry("flash_attention_flat_bwd_dq (K2c dQ in 3xTF32, SD SFD student, phase 39)",
                      bwd32, f"{tpu}:960", sfd_sd["counts"]["dqc"], sfd_sd["k2c"]["dq"]),
        _kernel_entry("flash_attention_flat_bwd_dkv (K2c dK/dV in 3xTF32, SD SFD student, "
                      "phase 39)", bwd32, f"{tpu}:994", sfd_sd["counts"]["dkvc"],
                      sfd_sd["k2c"]["dkv"]),
        _kernel_entry("flash_attention_mh in f32 at [16, 256, 1, 256] (K1 in 3xTF32, the "
                      "trajectory analyzer on CIFAR-10: analyze_trajectories and analyze_extend, "
                      "phase 41)", fwd32, f"{tpu}:157", analyzer["counts"]["k1"], analyzer["k1"]),
        _kernel_entry(f"groupnorm_silu in f32 (K3 at [16, 32, 32, 256], route "
                      f"{analyzer['k3']['route']}, the trajectory analyzer, phase 41)",
                      "diff_sampler_tpu_torch/csrc/groupnorm.cu",
                      "diff_sampler_tpu/ops/pallas_groupnorm.py:29", analyzer["counts"]["gn"],
                      analyzer["k3"]),
        _kernel_entry("flash_attention_mh in f32 at [16, 256, 1, 256] (K1 in 3xTF32, the AMED "
                      "export of phase 8's predictor over 16 probe seeds, phase 42; times of "
                      "phase 41)", fwd32, f"{tpu}:157", export_counts["k1"], analyzer["k1"]),
        _kernel_entry(f"groupnorm_silu in f32 (K3 at [16, 32, 32, 256], route "
                      f"{analyzer['k3']['route']}, the AMED export, phase 42; times of phase 41)",
                      "diff_sampler_tpu_torch/csrc/groupnorm.cu",
                      "diff_sampler_tpu/ops/pallas_groupnorm.py:29", export_counts["gn"],
                      analyzer["k3"]),
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
        _kernel_entry("flash_attention_mh in bf16 at the ring's tiles (K1, the ring's partials "
                      "only: SD v1.5 --sp=2 over two gloo ranks, phase 43, at [4, 2048, 8, 40], "
                      "[4, 512, 8, 80] and [4, 128, 8, 160]; launches: rank 0's; times at "
                      "[2, 2048, 8, 40])", fwd, f"{tpu}:227", par["sd_k1"]["bfloat16"],
                      par["k1"]["bfloat16"]),
        _kernel_entry("flash_attention_mh in f32 at the ring's tiles (K1 in 3xTF32, the ring's "
                      "partials only: SD v1.5 --sp=2 in f32, phase 43; launches: rank 0's; times "
                      "at [2, 2048, 8, 40])", fwd32, f"{tpu}:227", par["sd_k1"]["float32"],
                      par["k1"]["float32"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at the ring's tile [64, 128, 1, 256] (K2 dQ "
                      "in 3xTF32 on delta - g_lse, the partials' backward: the CIFAR-10 AMED "
                      "--sp=2 train step, phase 43; launches: rank 0's)", bwd32, f"{tpu}:406",
                      par["amed_sp"]["dq"], par["k2"]["float32"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at the ring's tile [64, 128, 1, 256] (K2 "
                      "dK/dV in 3xTF32, the partials' backward: the CIFAR-10 AMED --sp=2 train "
                      "step, phase 43; launches: rank 0's)", bwd32, f"{tpu}:554",
                      par["amed_sp"]["dkv"], par["k2"]["float32"]["dkv"]),
        _kernel_entry("flash_attention_bwd_dq in bf16 at the ring's tiles (K2 dQ on delta - "
                      "g_lse: the classifier's gradient in ImageNet-256 classifier-guided --sp=2 "
                      "sampling, phase 43, at [2, 512, 4, 64] and [2, 128, 8, 64]; launches: "
                      "rank 0's; times at [2, 512, 4, 64])", bwd, f"{tpu}:441", par["cg"]["dq"],
                      par["k2"]["bfloat16"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in bf16 at the ring's tiles (K2 dK/dV, the "
                      "classifier's gradient in ImageNet-256 classifier-guided --sp=2 sampling, "
                      "phase 43; launches: rank 0's; times at [2, 512, 4, 64])", bwd,
                      f"{tpu}:491", par["cg"]["dkv"], par["k2"]["bfloat16"]["dkv"]),
        _kernel_entry("flash_attention_mh in f32 at the --tp=2 shards (K1 in 3xTF32 on each "
                      "rank's heads: ImageNet-256 classifier-guided sampling, SD v1.5's 4 of 8 "
                      "heads, CIFAR-10's gathered qkv, the CIFAR-10 SFD step, phase 44; "
                      "launches: rank 0's; times at [2, 1024, 4, 64])", fwd32, f"{tpu}:227",
                      tp["k1_f32"], tp["k1"]["float32"]),
        _kernel_entry("flash_attention_mh in bf16 at the --tp=2 shards (K1 on each rank's "
                      "heads: the ImageNet-256 classifier's gradient, phase 44's one-call gate; "
                      "launches: rank 0's; times at [2, 1024, 2, 64])", fwd, f"{tpu}:227",
                      tp["k1_bf16"], tp["k1"]["bfloat16"]),
        _kernel_entry("flash_attention_bwd_dq in f32 at the --tp=2 shards (K2 dQ in 3xTF32: the "
                      "classifier's gradient on 2 of its 4 heads at 32x32, the CIFAR-10 SFD "
                      "step, phase 44; launches: rank 0's; times at [2, 1024, 2, 64])", bwd32,
                      f"{tpu}:441", tp["k2_f32"]["dq"], tp["k2"]["float32"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in f32 at the --tp=2 shards (K2 dK/dV in "
                      "3xTF32, as the dQ row, phase 44; launches: rank 0's)", bwd32,
                      f"{tpu}:491", tp["k2_f32"]["dkv"], tp["k2"]["float32"]["dkv"]),
        _kernel_entry("flash_attention_bwd_dq in bf16 at the --tp=2 shards (K2 dQ: the "
                      "classifier's gradient, phase 44's one-call gate; launches: rank 0's; "
                      "times at [2, 1024, 2, 64])", bwd, f"{tpu}:441", tp["k2_bf16"]["dq"],
                      tp["k2"]["bfloat16"]["dq"]),
        _kernel_entry("flash_attention_bwd_dkv in bf16 at the --tp=2 shards (K2 dK/dV, as the "
                      "dQ row, phase 44; launches: rank 0's)", bwd, f"{tpu}:491",
                      tp["k2_bf16"]["dkv"], tp["k2"]["bfloat16"]["dkv"]),
        _kernel_entry(f"groupnorm_silu in f32 at the --tp=2 channel slices (K3 on C / 2 "
                      f"channels in 16 groups between each column and row conv, route "
                      f"{tp['k3']['route']}: every --tp=2 path of phase 44; launches: rank "
                      f"0's; times at [2, 256, 256, 128])",
                      "diff_sampler_tpu_torch/csrc/groupnorm.cu",
                      "diff_sampler_tpu/ops/pallas_groupnorm.py:29", tp["gn"], tp["k3"]),
        _kernel_entry(f"groupnorm_silu in f32 at the SD v1.5 KL encoder's [8, 512, 512, 128] (K3, "
                      f"route {p45['kl_k3']['route']}: the encode's 22 GroupNorms and the round "
                      f"trip's decode, phase 45)", "diff_sampler_tpu_torch/csrc/groupnorm.cu",
                      "diff_sampler_tpu/ops/pallas_groupnorm.py:29", p45["kl_gn"], p45["kl_k3"]),
        *(_kernel_entry(f"{what} (the CIFAR-10 SFD second stage with LPIPS at 224, two "
                        f"iterations at batch 128 through training/sfd.py, phase 45; times of "
                        f"phase 37 at the same shape)", src, f"{tpu_src}", p45["lpips_counts"][k],
                        fields)
          for what, src, tpu_src, k, fields in _p45_attention_rows(sfd, fwd32, bwd32, tpu)),
        *(_kernel_entry(f"{what} (the CIFAR-10 EDMPrecond's weight gradient in train mode, "
                        f"dropout 0.13, with EDM's augment labels at batch 128, phase 45; times "
                        f"of phase 37 at the same shape)", src, f"{tpu_src}",
                        p45["train_counts"][k], fields)
          for what, src, tpu_src, k, fields in _p45_attention_rows(sfd, fwd32, bwd32, tpu)),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
