"""diff_sampler_tpu_torch: the PyTorch and CUDA port of diff_sampler_tpu.

It runs the EDM sampling paths of CIFAR-10 and FFHQ-64 (SongUNet) and
class-conditional ImageNet-64 (DhariwalUNet) -- the euler / heun / dpm /
ipndm / ipndm_v / deis / dpmpp / unipc samplers, per-seed generation and
labels, PNG, grid and trajectory output, the GITS schedule search -- the
latent tiers (the LSUN-Bedroom LDM with its VQ decode, Stable Diffusion v1.5
with classifier-free guidance over the contexts of its CLIP text tower and
its KL decode), AMED (predictor training through the frozen net, AMED
sampling) and SFD distillation (the pixel and latent students, SFD-v's
step condition, block recompute, sampling from their snapshots) on an
NVIDIA Hopper card, with hand-written kernels built from
``csrc/`` at first use.  Every tier runs on random weights from a seed or
on the reference's checkpoint files, read by a restricted unpickler that
runs none of their code; nothing is downloaded.  Samples are scored by FID
and PRDC through the FID Inception-V3 detector, against reference
statistics of a dataset zip that its dataset tool builds.  Its entry points run on the card unless the caller passes
``device="cpu"``.  It imports torch and nothing of the JAX package: the
noise schedules and multistep coefficients are its own copies of that
package's numpy code.

Subpackages mirror the JAX package's module names:
  ops      - attention (kernels K1, K1c, K2 and K2c and their plain
             versions), GroupNorm (K3), the direct 3x3 conv (K4),
             trajectory geometry, schedules, multistep coefficients
  models   - layers, SongUNet, DhariwalUNet, EDMPrecond, the ADM layers,
             LDMUNet, the VQ / KL first stages, CFGPrecond, the CLIP and
             BERT text towers, factory, checkpoint loader and zoo,
             JAX-params converter, analytic denoisers
  solvers  - samplers, AMED predictor and samplers
  gits     - the GITS schedule search
  training - AMED and SFD trainers, SD's conditioning contexts
  eval     - the FID Inception-V3 detector and its importers, FID, PRDC,
             the image dataset reader
  utils    - per-seed RNG, image IO, checkpoints, training stats, timing,
             the CLIP BPE tokenizer, a read-only LMDB reader
  cli      - sample, train_amed, train_sfd, fid, prdc, dataset_tool
"""

__version__ = "0.1.0"
