"""Port of ``ray_tpu/serve/llm.py``: ``LlamaDeployment``, a Llama
replica behind one continuous-batching engine (serve/engine.py).

Wrap it with a serve deployment at the use site; here it is a plain
class whose ``__call__``/``stream``/``generate_batch`` are the request
entry points. The engine pool, fleet, autoscaler, watchdog, prefix
cache, speculative decoding and tensor parallelism of the reference
are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import (LlamaConfig, build_model,
                                        init_params, llama_tiny)


class LlamaDeployment:
    """Deployment-ready Llama wrapper: ``__init__`` builds the model on
    the device, the first request builds the engine.

    config: a ``LlamaConfig`` (default ``llama_tiny()``).
    params: a state dict for ``models.llama.Llama`` (e.g. from
        ``init_params`` or ``flax_state_dict``); None draws random
        weights from seed 0.
    max_new_tokens: completion budget per request.
    temperature: 0 = greedy.
    max_slots, page_size, n_pages: the engine's decode width and KV
        pool; ``n_pages=None`` is full residency — every slot can
        reach ``max_seq_len`` without preemption.
    decode_chunk: decode steps per dispatch while admission work is
        pending (default 8).
    prefill_chunk: prompt tokens per scheduling round (default 256).
    eos_id: token that ends a request early.
    device: ``None``/``"cuda"`` (the card; raises without one) or
        ``"cpu"``.
    """

    def __init__(self, config: Optional[LlamaConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 max_slots: int = 16, page_size: int = 64,
                 n_pages: Optional[int] = None,
                 decode_chunk: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 eos_id: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = config or llama_tiny()
        if params is None:
            params = init_params(self.cfg, seed=0, device=self.device)
        self.model = build_model(self.cfg, params, self.device)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        if n_pages is None:
            per_seq = -(-self.cfg.max_seq_len // page_size)
            n_pages = max_slots * per_seq + 1
        self._engine_opts = dict(
            max_slots=max_slots, page_size=page_size, n_pages=n_pages,
            chunk=decode_chunk or 8, prefill_chunk=prefill_chunk,
            eos_id=eos_id)
        self._engine = None
        self._engine_lock = threading.Lock()

    def engine(self):
        """The replica's engine, built and started at first use. Locked:
        two first requests racing here must not allocate two pools."""
        with self._engine_lock:
            if self._engine is None:
                from ray_tpu_torch.serve.engine import LLMEngine
                self._engine = LLMEngine(
                    self.model, temperature=self.temperature,
                    device=self.device, **self._engine_opts).start()
            return self._engine

    def shutdown(self) -> None:
        """Stop the engine (if built); in-flight requests fail typed."""
        with self._engine_lock:
            if self._engine is not None:
                self._engine.shutdown()

    def __call__(self, prompt_ids: List[int]) -> List[int]:
        """One request: token ids in, prompt + generated ids out."""
        h = self.engine().submit(list(prompt_ids),
                                 max_new_tokens=self.max_new_tokens)
        return list(prompt_ids) + h.result()

    def stream(self, prompt_ids: List[int]):
        """Streaming request: yields each generated token id as it is
        emitted. Closing the generator early cancels the request, so
        its slot and pages free at once."""
        h = self.engine().submit(list(prompt_ids),
                                 max_new_tokens=self.max_new_tokens)
        try:
            yield from h.stream()
        except GeneratorExit:
            h.cancel()
            raise

    def generate_batch(self, prompts: List[List[int]]) -> List[List[int]]:
        """Batched generation: every prompt is submitted at once and the
        engine batches them at token granularity (any mix of lengths).
        Returns the generated ids per prompt."""
        eng = self.engine()
        hs = [eng.submit(list(p), max_new_tokens=self.max_new_tokens)
              for p in prompts]
        return [h.result() for h in hs]
