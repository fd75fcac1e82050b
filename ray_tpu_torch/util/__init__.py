"""Utilities of the port (counterpart: ``ray_tpu/util``)."""
