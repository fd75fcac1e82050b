"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``, built for an
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``ray_tpu`` stays beside this one as the reference.
This package imports ``torch`` and never ``jax``, ``jaxlib``, ``flax``
or anything under ``ray_tpu``: what it needs from there it keeps as
its own copy.

Slices landed so far, each on one card:

- LLM serving: ``serve.llm`` ``LlamaDeployment`` -> ``serve.engine``
  ``LLMEngine`` (with ``serve.prefix_cache``) -> the paged branch of
  ``models.llama`` -> ``models.kv_cache`` (fp or int8 pages) ->
  ``ops.paged_attention`` (hand-written CUDA paged-decode kernels for
  fp and int8 pages); the engine's cross-replica KV pull
  (``serve.kv_migration`` over ``serve.fleet``) and hot weight swap;
  the engine pool (``serve.engine_pool``) with its prefill/decode
  roles, watchdog (``serve.watchdog``) and SLO autoscaler
  (``serve.pool_autoscaler`` over ``autoscaler.node_provider``); the
  staged weight rollout (``serve.weight_rollout``) and the batch tier
  (``serve.batch_tier``) over durable checkpoints (``air``);
- GPT-2 training: ``train.spmd`` ``make_train_step`` -> ``models.gpt2``
  -> ``ops.attention`` -> ``ops.flash_attention`` (hand-written CUDA
  flash-attention forward and backward kernels).

Entry points run on CUDA unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise
(``_device.resolve_device``).

``resolve_device`` is a lazy attribute (PEP 562), so that importing a
module of the package that needs no tensor (the fleet's directory, its
WAL and its replication) does not import ``torch``.
"""
import importlib

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        return importlib.import_module("ray_tpu_torch._device").resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
