"""Host helpers of the port: per-seed RNG and image IO."""
