"""Port of ``ray_tpu/models/llama.py``: the Llama-family transformer in
PyTorch, paged-KV branch only.

Same model as the flax reference: split-halves RoPE with per-slot
positions, fp32 RMSNorm, grouped-query attention that never repeats
K/V, SwiGLU, and logits tied to ``tok_embeddings`` computed in fp32
from ``cfg.dtype`` operands. Weights live in ``cfg.dtype`` (the flax
params are fp32 and cast at each use; both give the same products).

Attention runs against the paged pool (models/kv_cache.py) only:
``T == 1`` decode goes to ``ops.paged_attention.paged_decode_attention``
(the CUDA kernel on the card), ``T >= 1`` chunks (chunked prefill)
gather the page window and attend in plain torch with fp32 scores and
softmax. The static-cache and cache-free branches and
``generate``/``generate_stream`` are not ported yet (ROADMAP.md, queue
1 item "Llama: static-cache and cache-free branches").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.kv_cache import PagedKVLayer
from ray_tpu_torch.ops.paged_attention import (paged_append,
                                               paged_decode_attention)

_NOT_PORTED = ("not ported yet: only the paged-KV branch exists in "
               "ray_tpu_torch (ROADMAP.md, queue 1: 'Llama: "
               "static-cache and cache-free branches')")


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


def _linear(n_in: int, n_out: int, cfg: LlamaConfig, device):
    return nn.Linear(n_in, n_out, bias=False, dtype=cfg.dtype,
                     device=device)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = _linear(cfg.dim, cfg.n_heads * hd, cfg, device)
        self.wk = _linear(cfg.dim, cfg.n_kv_heads * hd, cfg, device)
        self.wv = _linear(cfg.dim, cfg.n_kv_heads * hd, cfg, device)
        self.wo = _linear(cfg.n_heads * hd, cfg.dim, cfg, device)

    def forward(self, x, freqs, positions, kv_cache, cache_len):
        """x [B, T, dim]; kv_cache a PagedKVLayer whose pages this call
        appends the chunk's K/V to (in place); cache_len [B] int32, the
        position of each row's first token."""
        if not isinstance(kv_cache, PagedKVLayer):
            raise NotImplementedError(
                f"LlamaAttention without a paged KV cache is {_NOT_PORTED}")
        cfg = self.cfg
        B, T, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).view(B, T, cfg.n_heads, hd)
        k = self.wk(x).view(B, T, cfg.n_kv_heads, hd)
        v = self.wv(x).view(B, T, cfg.n_kv_heads, hd)
        q = apply_rope(q, freqs, positions)
        k = apply_rope(k, freqs, positions)

        pc = kv_cache
        pos = cache_len
        paged_append(pc.pages_k, pc.pages_v, pc.page_table, pos, k, v)
        if T == 1:
            # decode: the paged-attention kernel (plain torch on the CPU)
            y = paged_decode_attention(q[:, 0].contiguous(), pc.pages_k,
                                       pc.pages_v, pc.page_table, pos)
        else:
            y = self._chunk_attention(q, pc, pos)
        return self.wo(y.reshape(B, T, cfg.n_heads * hd))

    def _chunk_attention(self, q, pc: PagedKVLayer, pos):
        """T >= 1 chunk over each row's gathered page window, causal on
        absolute positions: query t of row b sits at pos[b] + t. Scores
        and softmax in fp32; the probabilities are cast to the pool's
        dtype for the PV product, as in the reference. Grouped-query
        without repeating K/V: q is [B, T, KH, rep, D]."""
        cfg = self.cfg
        B, T = q.shape[:2]
        hd, KH = cfg.head_dim, cfg.n_kv_heads
        pt = pc.page_table.long()
        L = pt.shape[1] * pc.page_size
        kg = pc.pages_k[:, pt].reshape(KH, B, L, hd)
        vg = pc.pages_v[:, pt].reshape(KH, B, L, hd)
        qg = q.reshape(B, T, KH, cfg.n_heads // KH, hd)
        scores = torch.einsum("btkrd,kbsd->bkrts", qg.float(),
                              kg.float()) / math.sqrt(hd)
        q_pos = pos.long()[:, None] + torch.arange(T, device=q.device)
        valid = (torch.arange(L, device=q.device)[None, None]
                 <= q_pos[:, :, None])                       # [B, T, L]
        scores = scores.masked_fill(~valid[:, None, None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bkrts,kbsd->btkrd", probs.to(vg.dtype), vg)


class LlamaMLP(nn.Module):
    """SwiGLU: w2(silu(w1 x) * w3 x)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.w1 = _linear(cfg.dim, cfg.hidden_dim, cfg, device)
        self.w3 = _linear(cfg.dim, cfg.hidden_dim, cfg, device)
        self.w2 = _linear(cfg.hidden_dim, cfg.dim, cfg, device)

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
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attention = LlamaAttention(cfg, device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.feed_forward = LlamaMLP(cfg, device)

    def forward(self, x, freqs, positions, kv_cache, cache_len):
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


def transformer_forward(model: "Llama", input_ids, kv_caches, cache_len):
    """Decoder body shared by Llama-shaped families: embedding, RoPE
    table, per-slot positions, layer loop, final norm, tied fp32
    logits."""
    cfg = model.cfg
    if kv_caches is None or cache_len is None:
        raise NotImplementedError(f"Llama without a paged KV cache is "
                                  f"{_NOT_PORTED}")
    T = input_ids.shape[1]
    x = model.tok_embeddings[input_ids.long()]
    freqs = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                       device=x.device)
    # per-slot positions [B] + [T] -> [B, T]
    positions = cache_len.long()[:, None] + torch.arange(
        T, device=x.device)[None]
    for layer, cache in zip(model.layers, kv_caches):
        x = layer(x, freqs, positions, cache, cache_len)
    return _tied_logits(model.norm(x), model.tok_embeddings)


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embeddings = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.dim, dtype=cfg.dtype, device=device))
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, device) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, device)

    @torch.no_grad()
    def forward(self, input_ids, kv_caches: List[PagedKVLayer],
                cache_len: torch.Tensor) -> torch.Tensor:
        """input_ids [B, T]; kv_caches one PagedKVLayer per layer
        (appended to in place); cache_len [B] int32 per-slot positions.
        Returns fp32 logits [B, T, vocab]."""
        return transformer_forward(self, input_ids, kv_caches, cache_len)


def generate(*args, **kwargs):
    """Static-cache generation loop of the reference."""
    raise NotImplementedError(f"generate is {_NOT_PORTED}")


def generate_stream(*args, **kwargs):
    """Chunked static-cache streaming loop of the reference."""
    raise NotImplementedError(f"generate_stream is {_NOT_PORTED}")


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


# --------------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------------

_DENSE = {"attention": ("wq", "wk", "wv", "wo"),
          "feed_forward": ("w1", "w2", "w3")}
_NORMS = ("attention_norm", "ffn_norm")


def flax_state_dict(tree) -> Dict[str, torch.Tensor]:
    """The flax param tree of ``ray_tpu.models.llama.Llama`` (numpy
    arrays; with or without the outer ``{"params": ...}``) as this
    module's state dict. Flax Dense kernels are [in, out];
    ``Linear.weight`` is [out, in], so they are transposed."""
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


def build_model(cfg: LlamaConfig, state_dict: Dict[str, torch.Tensor],
                device) -> Llama:
    """A Llama on ``device`` holding ``state_dict``'s weights (cast to
    cfg.dtype, norm scales fp32), built without a throwaway init."""
    model = Llama(cfg, device="meta")
    target = {k: (v.dtype, v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(
        {k: state_dict[k].to(device=device, dtype=target[k][0])
         for k in target}, assign=True)
    return model.eval()
