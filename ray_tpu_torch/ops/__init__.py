"""Device ops of the port (counterpart: ``ray_tpu/ops``). Hand-written
CUDA sources live in ``csrc/`` and are built by ``_build.py``."""
