"""Multi-process runs of the port: process-group set-up from the
environment, the (data, seq) or (data, model) layout of the processes and
the collectives that the sampling and training paths use (``mesh``), a
local launcher (``launch``), Megatron-style tensor parallelism of the
U-Nets (``tp``) and fully-sharded data parallelism of their weights
(``fsdp``).

Counterpart of ``diff_sampler_tpu/parallel/{mesh,tp,fsdp}.py`` (data,
tensor and fully-sharded parallelism and the multi-host bring-up); the
sequence-parallel ring is ``ops/ring_attention.py``."""
