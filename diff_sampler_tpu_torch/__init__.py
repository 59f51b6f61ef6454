"""diff_sampler_tpu_torch: the PyTorch and CUDA port of diff_sampler_tpu.

It runs the CIFAR-10 EDM sampling path (SongUNet denoiser, euler / heun /
dpm / ipndm / ipndm_v / dpmpp samplers, per-seed generation, PNG output) and
AMED (predictor training through the frozen net, AMED sampling) on an NVIDIA
Hopper card, with hand-written kernels built from ``csrc/`` at first use.
It imports torch and never jax; the noise schedules and multistep
coefficients are the JAX package's host-side numpy code.

Subpackages mirror the JAX package's module names:
  ops      - attention (kernels K1 and K2 and their plain versions), GroupNorm
  models   - layers, SongUNet, EDMPrecond, factory, JAX-params converter
  solvers  - samplers, AMED predictor and samplers
  training - AMED trainer
  utils    - per-seed RNG, image IO, checkpoints, training stats, timing
  cli      - sample, train_amed
"""

__version__ = "0.1.0"
