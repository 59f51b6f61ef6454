"""Host helpers of the port: per-seed RNG, image IO, checkpoints, training stats,
profiling and the CLIP BPE tokenizer."""
