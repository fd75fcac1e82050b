"""LLM serving of the port (counterpart: ``ray_tpu/serve``)."""
