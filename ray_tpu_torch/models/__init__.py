"""Models of the port (counterpart: ``ray_tpu/models``)."""
