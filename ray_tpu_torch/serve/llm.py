"""Port of ``ray_tpu/serve/llm.py``: ``LlamaDeployment``, a Llama
replica behind one continuous-batching engine (serve/engine.py), or,
with ``use_engine=False``, behind the static-cache ``generate`` and
``generate_stream`` loops of models/llama.py.

Wrap it with a serve deployment at the use site; here it is a plain
class whose ``__call__``/``stream``/``generate_batch`` are the request
entry points. The engine's int8 KV pool (``kv_dtype``) and prefix cache
(``prefix_cache``), speculative decoding (``spec_len``, ``spec_ngram``)
and the loop (``overlap``) pass through. The engine's KV pull and hot
weight swap are reached through ``engine()`` (``kv_fetcher``,
``submit(pull=...)``, ``swap_weights``). The engine pool, fleet,
autoscaler, watchdog and tensor parallelism of the reference are not
ported yet, nor the deployment's ``kv_pull_deadline_s`` and
``kv_pull_backoff_s``, which feed the engine pool (ROADMAP.md, queue 1,
item 6).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import (LlamaConfig, build_model, generate,
                                        generate_stream, init_params,
                                        llama_tiny)


class LlamaDeployment:
    """Deployment-ready Llama wrapper: ``__init__`` builds the model on
    the device, the first request builds the engine.

    config: a ``LlamaConfig`` (default ``llama_tiny()``).
    params: a state dict for ``models.llama.Llama`` (e.g. from
        ``init_params`` or ``flax_state_dict``); None draws random
        weights from seed 0.
    max_new_tokens: completion budget per request.
    temperature: 0 = greedy.
    stream_chunk: tokens per device read of ``stream`` without the
        engine, and the engine's default ``decode_chunk`` (default 8).
    use_engine: serve through the continuous-batching engine (default);
        False serves each call through ``generate``/``generate_stream``
        over a static KV cache, ``generate_batch`` one batch per prompt
        length.
    max_slots, page_size, n_pages: the engine's decode width and KV
        pool; ``n_pages=None`` is full residency — every slot can
        reach ``max_seq_len`` without preemption.
    decode_chunk: decode steps per dispatch while admission work is
        pending (default ``stream_chunk``).
    prefill_chunk: prompt tokens per scheduling round (default 256).
    eos_id: token that ends a request early.
    kv_dtype: the KV pool's storage, ``"fp"`` (default) or ``"int8"``
        (``RAY_TPU_KV_DTYPE`` overrides it when the engine is built).
    prefix_cache: share KV pages of identical page-aligned prompt
        prefixes across requests (default off).
    spec_len, spec_ngram: the engine's speculative decoding (up to
        ``spec_len`` prompt-lookup drafts per slot per round, suffix
        n-gram order ``spec_ngram``; 0 = off, the default; greedy only).
    overlap: the engine's overlapped loop; None (default) defers to the
        engine's default (on) and ``RAY_TPU_OVERLAP``.
    device: ``None``/``"cuda"`` (the card; raises without one) or
        ``"cpu"``.
    """

    def __init__(self, config: Optional[LlamaConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 stream_chunk: int = 8, use_engine: bool = True,
                 max_slots: int = 16, page_size: int = 64,
                 n_pages: Optional[int] = None,
                 decode_chunk: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False, spec_len: int = 0,
                 spec_ngram: int = 3, overlap: Optional[bool] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = config or llama_tiny()
        if params is None:
            params = init_params(self.cfg, seed=0, device=self.device)
        self.model = build_model(self.cfg, params, self.device)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.stream_chunk = stream_chunk
        self.use_engine = use_engine
        if n_pages is None:
            per_seq = -(-self.cfg.max_seq_len // page_size)
            n_pages = max_slots * per_seq + 1
        self._engine_opts = dict(
            max_slots=max_slots, page_size=page_size, n_pages=n_pages,
            chunk=decode_chunk or stream_chunk, prefill_chunk=prefill_chunk,
            eos_id=eos_id, kv_dtype=kv_dtype, prefix_cache=prefix_cache,
            spec_len=spec_len, spec_ngram=spec_ngram, overlap=overlap)
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
        if not self.use_engine:
            out = generate(self.model, [list(prompt_ids)],
                           self.max_new_tokens, self.temperature)
            return out[0].tolist()
        h = self.engine().submit(list(prompt_ids),
                                 max_new_tokens=self.max_new_tokens)
        return list(prompt_ids) + h.result()

    def stream(self, prompt_ids: List[int]):
        """Streaming request: yields each generated token id as it is
        emitted. Closing the generator early cancels the request, so
        its slot and pages free at once. Without the engine, tokens
        arrive in bursts of ``stream_chunk``, one device read each."""
        if not self.use_engine:
            for tok in generate_stream(self.model, [list(prompt_ids)],
                                       self.max_new_tokens,
                                       self.temperature,
                                       chunk_size=self.stream_chunk):
                yield int(tok[0])
            return
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
        Without the engine, prompts are bucketed by length and each
        bucket is one ``generate`` batch: the model masks only
        causally, so padding would change a completion. Returns the
        generated ids per prompt."""
        if not self.use_engine:
            return self._generate_buckets(prompts)
        eng = self.engine()
        hs = [eng.submit(list(p), max_new_tokens=self.max_new_tokens)
              for p in prompts]
        return [h.result() for h in hs]

    def _generate_buckets(self, prompts: List[List[int]]
                          ) -> List[List[int]]:
        buckets: Dict[int, List[int]] = {}
        for i, p in enumerate(prompts):
            buckets.setdefault(len(p), []).append(i)
        results: List[Optional[List[int]]] = [None] * len(prompts)
        for plen, idxs in buckets.items():
            batch = np.asarray([prompts[i] for i in idxs], np.int32)
            out = generate(self.model, batch, self.max_new_tokens,
                           self.temperature)
            for row, i in zip(out[:, plen:].tolist(), idxs):
                results[i] = row
        return results
