"""Port of ``ray_tpu/models/llama.py``: the Llama-family transformer in
PyTorch, with the reference's three attention branches and its
generation loops.

Same model as the flax reference: split-halves RoPE, fp32 RMSNorm,
grouped-query attention, SwiGLU, and logits tied to ``tok_embeddings``
computed in fp32 from ``cfg.dtype`` operands. Dense weights and the
embedding are stored in the dtype the model was built with and cast to
``cfg.dtype`` at each use, as flax's ``param_dtype`` does: a serving
model (``build_model``) stores them in ``cfg.dtype``, so the cast is a
no-op and the decode step launches nothing for it; a training model
(``build_train_model``) keeps fp32 masters (``cfg.param_dtype``).

``Llama.forward`` dispatches on the cache it is given:

- a list of ``PagedKVLayer`` (models/kv_cache.py) with per-slot
  ``[B]`` positions, fp or int8: ``T == 1`` decode goes to
  ``ops.paged_attention.paged_decode_attention`` (the CUDA kernel on
  the card, K1 for fp pages, K2 for int8 pages); ``T >= 1`` chunks
  (chunked prefill) gather the page window — for int8 dequantized in
  fp32 with the gathered per-page scales — and attend in plain torch
  with fp32 scores and softmax;
- a list of static ``(k, v)`` caches (``init_kv_caches``) with one
  scalar position: the chunk's K/V are written in place and attended
  in plain torch, as the reference's ``generate``/``generate_stream``
  decode;
- ``None``: the cache-free forward, positions ``arange(T)``, K/V
  repeated per head and attended through
  ``ops.attention.multi_head_attention`` (on the card the flash
  kernels K3, K4 and K5 when ``cfg.attention_impl`` picks flash), each
  block under ``torch.utils.checkpoint`` with ``cfg.remat``. Only this
  branch records autograd; the cache branches run under ``no_grad``.

``llama_sharding_rules`` waits for the mesh slice (ROADMAP.md queue 1,
item 12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.kv_cache import PagedKVLayer
from ray_tpu_torch.ops.attention import multi_head_attention
from ray_tpu_torch.ops.paged_attention import (paged_append,
                                               paged_decode_attention)

# decode steps of ``generate`` between two host reads of the eos flags
_EOS_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32          # < n_heads => grouped-query attention
    hidden_dim: int = 11008       # SwiGLU inner dim
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32   # what build_train_model stores
    remat: bool = False                # torch.utils.checkpoint per block
    attention_impl: str = "auto"       # of the cache-free forward

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def llama_tiny(**overrides) -> LlamaConfig:
    """Test-size config (GQA exercised: 4 q heads, 2 kv heads)."""
    d = dict(vocab_size=256, max_seq_len=128, dim=64, n_layers=2,
             n_heads=4, n_kv_heads=2, hidden_dim=128)
    d.update(overrides)
    return LlamaConfig(**d)


def tinyllama_1_1b(**overrides) -> LlamaConfig:
    """TinyLlama-1.1B widths (vocab 32000, dim 2048, 22 layers, 32 q
    heads over 4 kv heads — GQA group 8 — head_dim 64, SwiGLU 5632,
    rope theta 10000, eps 1e-5) at its published 2048-token context,
    bf16. Logits stay tied to ``tok_embeddings`` as everywhere in this
    repo."""
    d = dict(vocab_size=32000, max_seq_len=2048, dim=2048, n_layers=22,
             n_heads=32, n_kv_heads=4, hidden_dim=5632,
             rope_theta=10000.0, norm_eps=1e-5, dtype=torch.bfloat16)
    d.update(overrides)
    return LlamaConfig(**d)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, max_len: int, theta: float,
               device=None) -> torch.Tensor:
    """[max_len, head_dim/2] fp32 rotation angles."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [T] or [B, T]. Split halves (not
    interleaved pairs), in fp32, cast back to x.dtype. Positions past
    the table clamp to its last row, as XLA's gather does."""
    f = freqs[positions.long().clamp(0, freqs.shape[0] - 1)]
    if f.ndim == 2:
        f = f[None]                               # [1, T, D/2]
    cos = torch.cos(f)[..., None, :]              # [B|1, T, 1, D/2]
    sin = torch.sin(f)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """fp32 inside, output in the input's dtype; ``scale`` is fp32."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense(use_bias=False, dtype=cfg.dtype)``: the weight
    ``[out, in]`` (``nn.Linear``'s layout) stored in ``wdtype``, cast
    to ``cfg.dtype`` for the product (a no-op when they agree)."""

    def __init__(self, n_in: int, n_out: int, cfg: LlamaConfig, wdtype,
                 device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(n_out, n_in, dtype=wdtype,
                                               device=device))

    def forward(self, x):
        return F.linear(x, self.weight.to(self.dtype))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, wdtype, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = Dense(cfg.dim, cfg.n_heads * hd, cfg, wdtype, device)
        self.wk = Dense(cfg.dim, cfg.n_kv_heads * hd, cfg, wdtype, device)
        self.wv = Dense(cfg.dim, cfg.n_kv_heads * hd, cfg, wdtype, device)
        self.wo = Dense(cfg.n_heads * hd, cfg.dim, cfg, wdtype, device)

    def forward(self, x, freqs, positions, kv_cache=None, cache_len=None):
        """x [B, T, dim]. ``kv_cache``: a PagedKVLayer whose pages this
        call appends the chunk's K/V to (in place), ``cache_len`` [B]
        int32, the position of each row's first token; or a static
        ``(k, v)`` pair written in place at the int ``cache_len``; or
        None (cache-free, causal over the chunk)."""
        cfg = self.cfg
        B, T, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).view(B, T, cfg.n_heads, hd)
        k = self.wk(x).view(B, T, cfg.n_kv_heads, hd)
        v = self.wv(x).view(B, T, cfg.n_kv_heads, hd)
        q = apply_rope(q, freqs, positions)
        k = apply_rope(k, freqs, positions)

        if isinstance(kv_cache, PagedKVLayer):
            y = self._paged_attention(q, k, v, kv_cache, cache_len)
        elif kv_cache is not None:
            y = self._static_attention(q, k, v, kv_cache, cache_len)
        else:
            # head h reads kv head h // rep, as jnp.repeat gives
            rep = cfg.n_heads // cfg.n_kv_heads
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
            y = multi_head_attention(q, k, v, causal=True,
                                     impl=cfg.attention_impl)
        return self.wo(y.reshape(B, T, cfg.n_heads * hd))

    def _paged_attention(self, q, k, v, pc: PagedKVLayer, pos):
        # int8 pools: the append quantizes in place and updates the
        # per-page scales, which travel with the pages
        paged_append(pc.pages_k, pc.pages_v, pc.page_table, pos, k, v,
                     pc.scales_k, pc.scales_v)
        if q.shape[1] == 1:
            # decode: the paged-attention kernel, K1 or K2 (plain torch
            # on the CPU)
            return paged_decode_attention(q[:, 0].contiguous(), pc.pages_k,
                                          pc.pages_v, pc.page_table, pos,
                                          pc.scales_k, pc.scales_v)
        return self._chunk_attention(q, pc, pos)

    def _chunk_attention(self, q, pc: PagedKVLayer, pos):
        """T >= 1 chunk over each row's gathered page window, causal on
        absolute positions: query t of row b sits at pos[b] + t. Scores
        and softmax in fp32; the probabilities are cast to the window's
        dtype for the PV product, as in the reference — the pool's
        dtype, or fp32 for an int8 pool, whose gathered window is
        dequantized in fp32 (``q8 * (s * (1/127))``; only this window,
        never the pool, exists in fp); the result is returned in q's
        dtype, as the reference's ``wo`` takes it. Grouped-query without
        repeating K/V: q is [B, T, KH, rep, D]."""
        cfg = self.cfg
        B, T = q.shape[:2]
        hd, KH = cfg.head_dim, cfg.n_kv_heads
        pt = pc.page_table.long()
        L = pt.shape[1] * pc.page_size
        kg = pc.pages_k[:, pt]                       # [KH, B, MP, Pg, D]
        vg = pc.pages_v[:, pt]
        if pc.quantized:
            kg = kg.float() * (pc.scales_k[:, pt] * (1.0 / 127.0))[..., None]
            vg = vg.float() * (pc.scales_v[:, pt] * (1.0 / 127.0))[..., None]
        kg = kg.reshape(KH, B, L, hd)
        vg = vg.reshape(KH, B, L, hd)
        qg = q.reshape(B, T, KH, cfg.n_heads // KH, hd)
        scores = torch.einsum("btkrd,kbsd->bkrts", qg.float(),
                              kg.float()) / math.sqrt(hd)
        q_pos = pos.long()[:, None] + torch.arange(T, device=q.device)
        valid = (torch.arange(L, device=q.device)[None, None]
                 <= q_pos[:, :, None])                       # [B, T, L]
        scores = scores.masked_fill(~valid[:, None, None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bkrts,kbsd->btkrd", probs.to(vg.dtype),
                            vg).to(q.dtype)

    def _static_attention(self, q, k, v, cache, start: int):
        """The reference's static KV-cache branch: this chunk's K/V
        written at ``[:, start:start + T]`` of the ``(k, v)`` cache in
        place, then grouped-query attention over the cache in fp32
        scores and softmax, causal on absolute positions, the
        probabilities cast to the cache's dtype for the PV product.
        Only the first ``start + T`` positions are read: the reference
        masks the rest to -1e30, whose weights are exact zeros."""
        cfg = self.cfg
        ck, cv = cache
        B, T = q.shape[:2]
        end = start + T
        if end > ck.shape[1]:
            raise ValueError(f"static cache of {ck.shape[1]} positions "
                             f"cannot take positions {start}..{end - 1}")
        ck[:, start:end] = k
        cv[:, start:end] = v
        kc, vc = ck[:, :end], cv[:, :end]
        hd, KH = cfg.head_dim, cfg.n_kv_heads
        qg = q.reshape(B, T, KH, cfg.n_heads // KH, hd)
        scores = torch.einsum("btkrd,bskd->bkrts", qg.float(),
                              kc.float()) / math.sqrt(hd)
        q_pos = start + torch.arange(T, device=q.device)
        causal = torch.arange(end, device=q.device)[None] <= q_pos[:, None]
        scores = scores.masked_fill(~causal, -1e30)
        probs = torch.softmax(scores, dim=-1)
        y = torch.einsum("bkrts,bskd->btkrd", probs.to(vc.dtype), vc)
        return y.reshape(B, T, cfg.n_heads, hd)


class LlamaMLP(nn.Module):
    """SwiGLU: w2(silu(w1 x) * w3 x)."""

    def __init__(self, cfg: LlamaConfig, wdtype, device=None):
        super().__init__()
        self.w1 = Dense(cfg.dim, cfg.hidden_dim, cfg, wdtype, device)
        self.w3 = Dense(cfg.dim, cfg.hidden_dim, cfg, wdtype, device)
        self.w2 = Dense(cfg.hidden_dim, cfg.dim, cfg, wdtype, device)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def block_forward(block: "LlamaBlock", x, freqs, positions, kv_cache,
                  cache_len):
    """Pre-norm block body: attention residual + FFN residual (the
    FFN module is what varies across Llama-shaped families)."""
    x = x + block.attention(block.attention_norm(x), freqs, positions,
                            kv_cache, cache_len)
    return x + block.feed_forward(block.ffn_norm(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, wdtype, device=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attention = LlamaAttention(cfg, wdtype, device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.feed_forward = LlamaMLP(cfg, wdtype, device)

    def forward(self, x, freqs, positions, kv_cache=None, cache_len=None):
        return block_forward(self, x, freqs, positions, kv_cache,
                             cache_len)


def _tied_logits(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """fp32 logits x @ emb.T from cfg.dtype operands, without rounding
    the output to cfg.dtype: on the card a bf16 product with an fp32
    output (``torch.mm(..., out_dtype=)``), on the CPU the same
    products in fp32 (each bf16 product is exact in fp32)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ emb.t()
    elif x.device.type == "cuda":
        out = torch.mm(x2, emb.t(), out_dtype=torch.float32)
    else:
        out = x2.float() @ emb.float().t()
    return out.reshape(*x.shape[:-1], emb.shape[0])


class _TiedLogits(torch.autograd.Function):
    """``_tied_logits`` (fp32 logits from bf16 operands, never rounded
    to bf16) with its backward written out: the fp32 gradient rounded to
    the operands' dtype, then two bf16 GEMMs."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _tied_logits(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = (g2 @ w).reshape(x.shape)
        dw = g2.t() @ x.reshape(-1, x.shape[-1])
        return dx, dw


def tied_logits(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ emb.T`` with ``emb`` cast to ``x.dtype``;
    differentiable."""
    w = emb.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w.t()
    return _TiedLogits.apply(x, w)


def transformer_forward(model: "Llama", input_ids, kv_caches=None,
                        cache_len=None):
    """Decoder body shared by Llama-shaped families: embedding (gathered
    in its stored dtype, then cast to ``cfg.dtype``), RoPE table,
    positions (per slot for a paged cache, from the scalar ``cache_len``
    for a static one, ``arange(T)`` without a cache), layer loop, final
    norm, tied fp32 logits."""
    cfg = model.cfg
    T = input_ids.shape[1]
    x = model.tok_embeddings[input_ids.long()].to(cfg.dtype)
    freqs = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                       device=x.device)
    steps = torch.arange(T, device=x.device)
    if kv_caches is None:
        positions = steps
    elif cache_len is None:
        raise ValueError("a KV cache needs cache_len")
    elif isinstance(kv_caches[0], PagedKVLayer):
        # per-slot positions [B] + [T] -> [B, T]
        positions = cache_len.long()[:, None] + steps[None]
    else:
        cache_len = int(cache_len)
        positions = cache_len + steps
    for i, layer in enumerate(model.layers):
        if kv_caches is not None:
            x = layer(x, freqs, positions, kv_caches[i], cache_len)
        elif cfg.remat:
            x = checkpoint(layer, x, freqs, positions, use_reentrant=False)
        else:
            x = layer(x, freqs, positions)
    return tied_logits(model.norm(x), model.tok_embeddings)


class Llama(nn.Module):
    """``wdtype``: the dtype the Dense weights and the embedding are
    stored in, ``cfg.dtype`` by default (serving); ``build_train_model``
    passes ``cfg.param_dtype``. Norm scales are fp32 either way."""

    def __init__(self, cfg: LlamaConfig, device=None, wdtype=None):
        super().__init__()
        self.cfg = cfg
        wdtype = wdtype or cfg.dtype
        self.tok_embeddings = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.dim, dtype=wdtype, device=device))
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, wdtype, device) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, device)

    def forward(self, input_ids, kv_caches=None, cache_len=None
                ) -> torch.Tensor:
        """input_ids [B, T] -> fp32 logits [B, T, vocab]. ``kv_caches``:
        one PagedKVLayer per layer with ``cache_len`` [B] int32 per-slot
        positions, or one static ``(k, v)`` pair per layer
        (``init_kv_caches``) with an int ``cache_len``, both appended to
        in place and run without autograd; or None, the cache-free
        forward, which records autograd for training."""
        if kv_caches is None:
            return transformer_forward(self, input_ids)
        with torch.no_grad():
            return transformer_forward(self, input_ids, kv_caches,
                                       cache_len)


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int,
                   device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One zeroed static ``(k, v)`` pair per layer, each ``[batch,
    max_len, n_kv_heads, head_dim]`` in ``cfg.dtype``, on ``device`` (the
    card by default, ``"cpu"`` when asked)."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.n_layers)]


def _decode_setup(model: Llama, prompt_ids, max_new_tokens: int,
                  temperature: float, generator):
    """The prompt as int32 [B, T0] on the model's device, and the
    generator that samples at temperature > 0: the caller's, or one
    seeded 0 (the reference's default key), so a call repeats itself.
    Token ids outside the vocabulary are refused: on the card the
    embedding gather would fault on them."""
    device = model.tok_embeddings.device
    prompt = torch.as_tensor(prompt_ids)
    if prompt.ndim != 2 or prompt.shape[1] == 0:
        raise ValueError(f"prompt_ids must be [B, T] with T >= 1; got "
                         f"{tuple(prompt.shape)}")
    if int(prompt.min()) < 0 or int(prompt.max()) >= model.cfg.vocab_size:
        raise ValueError(f"prompt token ids must lie in [0, "
                         f"{model.cfg.vocab_size})")
    prompt = prompt.to(device, torch.int32)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return prompt, generator


def generate(model: Llama, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """Autoregressive decode over a static KV cache: one prefill
    forward, then single-token steps. Returns int32 ``[B, T0 +
    max_new_tokens]`` on the model's device: the prompt, then the
    generated tokens.

    As the reference's loop: generation stops only once EVERY row has
    drawn ``eos_id`` (rows that drew it keep generating until then), and
    the positions after that step stay 0; the per-row flags see only
    sampled tokens, so ``eos_id=0`` is a token like any other. The host
    reads the flags once per ``_EOS_CHECK_EVERY`` steps (never without
    ``eos_id``) and zeroes whatever was generated past the step at which
    the last row finished, so the result is the reference's. At
    temperature > 0 the tokens are drawn with ``generator`` (its device
    is the model's): only their distribution can match JAX's."""
    cfg = model.cfg
    prompt, generator = _decode_setup(model, prompt_ids, max_new_tokens,
                                      temperature, generator)
    B, T0 = prompt.shape
    caches = init_kv_caches(cfg, B, T0 + max_new_tokens, prompt.device)
    tokens = torch.zeros((B, T0 + max_new_tokens), dtype=torch.int32,
                         device=prompt.device)
    tokens[:, :T0] = prompt
    cur = _pick_token(model(prompt, caches, 0)[:, -1], temperature,
                      generator)
    tokens[:, T0] = cur
    done = None if eos_id is None else cur == eos_id
    # flags[j]: every row has drawn eos by step base + j (not yet read)
    flags = [] if done is None else [done.all()]
    base = 0
    for i in range(1, max_new_tokens):
        logits = model(cur[:, None], caches, T0 + i - 1)
        cur = _pick_token(logits[:, -1], temperature, generator)
        tokens[:, T0 + i] = cur
        if done is None:
            continue
        done = done | (cur == eos_id)
        flags.append(done.all())
        if len(flags) == _EOS_CHECK_EVERY:
            if _stop_at(tokens, T0 + base, flags):
                return tokens
            base, flags = i + 1, []
    if flags:
        _stop_at(tokens, T0 + base, flags)
    return tokens


def _stop_at(tokens: torch.Tensor, at: int, flags) -> bool:
    """One host read of ``flags`` (done-for-every-row after the steps
    that wrote ``tokens[:, at]``, ``tokens[:, at + 1]``, ...): if one is
    set, zero the tokens after the first such step and return True."""
    hit = torch.stack(flags).nonzero()
    if hit.numel() == 0:
        return False
    tokens[:, at + int(hit[0, 0]) + 1:] = 0
    return True


def generate_stream(model: Llama, prompt_ids, max_new_tokens: int,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    eos_id: Optional[int] = None, chunk_size: int = 8):
    """Incremental decode for streaming serving: a prefill, then chunks
    of ``chunk_size`` single-token steps over a static KV cache of ``T0
    + 1 + n_chunks * chunk_size`` positions. Yields each batch row's
    next token as a numpy int32 array of shape [B]: the first after the
    prefill, the rest in bursts of up to ``chunk_size``, read back from
    the device once per chunk. Stops after ``max_new_tokens`` tokens, or
    once every row has drawn ``eos_id``, as the reference does."""
    cfg = model.cfg
    prompt, generator = _decode_setup(model, prompt_ids, max_new_tokens,
                                      temperature, generator)
    B, T0 = prompt.shape
    K = max(1, min(chunk_size, max_new_tokens))
    n_chunks = (max_new_tokens - 1 + K - 1) // K
    caches = init_kv_caches(cfg, B, T0 + 1 + n_chunks * K, prompt.device)
    tok = _pick_token(model(prompt, caches, 0)[:, -1], temperature,
                      generator)
    first = tok.cpu().numpy()
    done = np.zeros((B,), bool)
    if eos_id is not None:
        done |= first == eos_id
    yield first
    emitted = 1
    for _ in range(n_chunks):
        if emitted >= max_new_tokens or (eos_id is not None and done.all()):
            return
        # the chunk's first step consumes the last emitted token, which
        # sits at position T0 + emitted - 1
        start = T0 + emitted - 1
        toks = []
        for i in range(K):
            tok = _pick_token(model(tok[:, None], caches, start + i)[:, -1],
                              temperature, generator)
            toks.append(tok)
        out = torch.stack(toks).cpu().numpy()        # one read per chunk
        for row in out:
            if emitted >= max_new_tokens:
                return
            if eos_id is not None:
                done |= row == eos_id
            yield row
            emitted += 1
            if eos_id is not None and done.all():
                return


def _pick_token(logits_last: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Greedy (first maximum on ties, like jnp.argmax) at temperature
    0, else a sample from softmax(logits / temperature). int32 [B]."""
    if temperature <= 0.0:
        return torch.argmax(logits_last, dim=-1).to(torch.int32)
    probs = torch.softmax(logits_last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def llama_param_count(cfg: LlamaConfig) -> int:
    per_layer = (cfg.dim * cfg.n_heads * cfg.head_dim +
                 2 * cfg.dim * cfg.n_kv_heads * cfg.head_dim +
                 cfg.n_heads * cfg.head_dim * cfg.dim +
                 3 * cfg.dim * cfg.hidden_dim + 2 * cfg.dim)
    return (cfg.vocab_size * cfg.dim + cfg.n_layers * per_layer +
            cfg.dim)


def llama_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token: 6N (forward 2N + backward 4N) plus the
    attention-score term 12·L·H·hd·T that 6N misses (PaLM appendix B):
    the denominator of MFU."""
    return (6.0 * llama_param_count(cfg) +
            12.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq_len)


def llama_tp_validate(cfg: LlamaConfig, tp: int) -> None:
    """Check that ``cfg`` divides evenly over a ``tp``-way tensor split
    (heads, kv heads, hidden_dim, vocab); raises ValueError naming the
    first dimension that does not."""
    if tp <= 0:
        raise ValueError(f"tp must be >= 1, got {tp}")
    for what, n in (("n_heads", cfg.n_heads),
                    ("n_kv_heads", cfg.n_kv_heads),
                    ("hidden_dim", cfg.hidden_dim),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(
                f"tensor parallelism tp={tp} does not divide "
                f"{what}={n} for this Llama config")


# --------------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------------

_DENSE = {"attention": ("wq", "wk", "wv", "wo"),
          "feed_forward": ("w1", "w2", "w3")}
_NORMS = ("attention_norm", "ffn_norm")


def flax_state_dict(tree) -> Dict[str, torch.Tensor]:
    """The flax param tree of ``ray_tpu.models.llama.Llama`` (numpy
    arrays; with or without the outer ``{"params": ...}``) as this
    module's fp32 state dict, which ``build_model`` (weights cast to
    ``cfg.dtype``) and ``build_train_model`` (fp32 masters) both take.
    Flax Dense kernels are [in, out]; ``Dense.weight`` is [out, in], so
    they are transposed."""
    p = tree["params"] if "params" in tree else tree
    n_layers = sum(1 for key in p if key.startswith("layers_"))
    sd = {"tok_embeddings": np.asarray(p["tok_embeddings"]),
          "norm.scale": np.asarray(p["norm"]["scale"])}
    for i in range(n_layers):
        layer = p[f"layers_{i}"]
        for mod, names in _DENSE.items():
            for name in names:
                sd[f"layers.{i}.{mod}.{name}.weight"] = np.asarray(
                    layer[mod][name]["kernel"]).T
        for norm in _NORMS:
            sd[f"layers.{i}.{norm}.scale"] = np.asarray(
                layer[norm]["scale"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def load_flax_params(model: Llama, tree) -> Llama:
    """Copy a flax Llama param tree (numpy arrays) into ``model``,
    casting to each parameter's dtype. Returns the model."""
    model.load_state_dict(flax_state_dict(tree))
    return model


def init_params(cfg: LlamaConfig, seed: int, device=None
                ) -> Dict[str, torch.Tensor]:
    """Random weights at the flax init scales, drawn with a
    ``torch.Generator`` seeded by ``seed`` on ``device`` (the card by
    default; ``"cpu"`` when asked): Dense kernels lecun-normal
    (truncated normal at 2 sigma, std sqrt(1/fan_in)/0.8796),
    ``tok_embeddings`` normal(0.02), norm scales 1. Returns a state
    dict in ``cfg.dtype`` (norm scales fp32) for
    ``Llama.load_state_dict``. The numbers differ from ``jax.random``'s
    for the same seed, and from one device to another."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = {k: tuple(v.shape)
              for k, v in Llama(cfg, device="meta").state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name.endswith(".scale"):
            sd[name] = torch.ones(shape, dtype=torch.float32,
                                  device=device)
            continue
        w = torch.empty(shape, dtype=torch.float32, device=device)
        if name == "tok_embeddings":
            w.normal_(0.0, 0.02, generator=gen)
        else:
            std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        sd[name] = w.to(cfg.dtype)
    return sd


def _build(cfg: LlamaConfig, state_dict, device, wdtype, copy: bool
           ) -> Llama:
    device = resolve_device(device)
    model = Llama(cfg, device="meta", wdtype=wdtype)
    target = {k: v.dtype for k, v in model.state_dict().items()}
    model.load_state_dict(
        {k: state_dict[k].to(device=device, dtype=target[k], copy=copy)
         for k in target}, assign=True)
    return model


def build_model(cfg: LlamaConfig, state_dict: Dict[str, torch.Tensor],
                device=None) -> Llama:
    """A Llama for serving on ``device`` (the card by default, ``"cpu"``
    when asked; raises ``NoCudaError`` without a card) holding
    ``state_dict``'s weights (cast to cfg.dtype, norm scales fp32),
    built without a throwaway init."""
    return _build(cfg, state_dict, device, cfg.dtype, copy=False).eval()


def build_train_model(cfg: LlamaConfig,
                      state_dict: Dict[str, torch.Tensor],
                      device=None) -> Llama:
    """A Llama for training on ``device``: copies of ``state_dict``'s
    weights as trainable leaves, the Dense weights and the embedding in
    ``cfg.param_dtype`` (fp32 masters, cast to ``cfg.dtype`` at each use
    as flax does), norm scales fp32. For fp32 draws from
    ``init_params``, pass it the config with ``dtype=cfg.param_dtype``."""
    return _build(cfg, state_dict, device, cfg.param_dtype, copy=True)
