"""Host helpers of the port: per-seed RNG, image IO, checkpoints, training stats,
profiling, the CLIP BPE tokenizer and a read-only LMDB reader."""
