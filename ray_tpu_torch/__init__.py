"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``, built for an
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``ray_tpu`` stays beside this one as the reference.
This package imports ``torch`` and never ``jax``, ``jaxlib``, ``flax``
or anything under ``ray_tpu``: what it needs from there it keeps as
its own copy.

Slices landed so far, each on one card:

- LLM serving: ``serve.llm`` ``LlamaDeployment`` -> ``serve.engine``
  ``LLMEngine`` -> the paged branch of ``models.llama`` ->
  ``models.kv_cache`` -> ``ops.paged_attention`` (hand-written CUDA
  paged-decode kernel);
- GPT-2 training: ``train.spmd`` ``make_train_step`` -> ``models.gpt2``
  -> ``ops.attention`` -> ``ops.flash_attention`` (hand-written CUDA
  flash-attention forward and backward kernels).

Entry points run on CUDA unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise
(``_device.resolve_device``).
"""
from ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
