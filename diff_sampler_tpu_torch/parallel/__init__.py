"""Multi-process runs of the port: process-group set-up from the
environment, the (data, seq) layout of the processes and the collectives
that the sampling and training paths use (``mesh``), and a local launcher
(``launch``).

Counterpart of ``diff_sampler_tpu/parallel/mesh.py`` (data parallelism and
the multi-host bring-up); the sequence-parallel ring is
``ops/ring_attention.py``."""
