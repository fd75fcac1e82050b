"""Training of the port (counterpart: ``ray_tpu/train``)."""
