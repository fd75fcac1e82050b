"""Port of ``ray_tpu/models/gpt2.py``: GPT-2 in PyTorch, for training.

Same model as the flax reference, rounding at the same places:

- params are fp32 (``param_dtype``) and cast to ``cfg.dtype`` at each
  use, as flax does (no ``torch.autocast``, which would pick its own
  fp32 ops); Dense weights are ``[out, in]`` like ``nn.Linear`` (flax
  kernels are ``[in, out]``: ``load_flax_params`` transposes them);
- the embedding is ``wte[ids]`` and ``wpe[:T]`` each cast to
  ``cfg.dtype`` and summed there;
- LayerNorm runs in fp32 on the ``cfg.dtype`` input, eps 1e-6 (flax's
  default; torch's is 1e-5), and its output is cast back for the
  matmuls;
- gelu is the tanh approximation (flax's ``nn.gelu`` default);
- attention goes through ``ops.attention.multi_head_attention`` with
  ``cfg.attention_impl``; q, k and v are the column views of the fused
  ``c_attn`` output (row stride 3C), which the flash kernels read in
  place;
- logits are tied to ``wte`` and computed in fp32 from ``cfg.dtype``
  operands.

``gpt2_sharding_rules`` waits for the mesh slice (ROADMAP.md queue 1,
item 14).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import _tied_logits
from ray_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304          # padded to a multiple of 128
    n_ctx: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False              # torch.utils.checkpoint per block
    attention_impl: str = "auto"     # auto | dense | dense_fp32 | flash

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def gpt2_124m(**overrides) -> GPT2Config:
    return GPT2Config(**overrides)


def gpt2_tiny(**overrides) -> GPT2Config:
    """Test-size config."""
    d = dict(vocab_size=256, n_ctx=64, n_embd=64, n_layer=2, n_head=4)
    d.update(overrides)
    return GPT2Config(**d)


class Dense(nn.Module):
    """flax ``nn.Dense`` with ``dtype``/``param_dtype``: fp32 params,
    inputs, weight and bias cast to ``dtype`` for the product."""

    def __init__(self, n_in: int, n_out: int, cfg: GPT2Config, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            n_out, n_in, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            n_out, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 output, eps 1e-6."""

    def __init__(self, n: int, cfg: GPT2Config, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(
            n, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            n, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale.float(),
                            self.bias.float(), eps=1e-6)


def _dropout(x, cfg: GPT2Config, deterministic: bool):
    if cfg.dropout > 0 and not deterministic:
        return F.dropout(x, cfg.dropout, training=True)
    return x


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.c_attn = Dense(cfg.n_embd, 3 * cfg.n_embd, cfg, device)
        self.c_proj = Dense(cfg.n_embd, cfg.n_embd, cfg, device)

    def forward(self, x, deterministic: bool = True):
        cfg = self.cfg
        B, T, C = x.shape
        # strided [B, T, H, D] views of the fused projection, no copy
        q, k, v = (t.view(B, T, cfg.n_head, cfg.head_dim)
                   for t in self.c_attn(x).split(C, dim=-1))
        y = multi_head_attention(q, k, v, causal=True,
                                 impl=cfg.attention_impl)
        y = self.c_proj(y.reshape(B, T, C))
        return _dropout(y, cfg, deterministic)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.c_fc = Dense(cfg.n_embd, 4 * cfg.n_embd, cfg, device)
        self.c_proj = Dense(4 * cfg.n_embd, cfg.n_embd, cfg, device)

    def forward(self, x, deterministic: bool = True):
        h = F.gelu(self.c_fc(x), approximate="tanh")
        return _dropout(self.c_proj(h), self.cfg, deterministic)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.ln_1 = LayerNorm(cfg.n_embd, cfg, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, deterministic: bool = True):
        x = x + self.attn(self.ln_1(x).to(self.dtype), deterministic)
        return x + self.mlp(self.ln_2(x).to(self.dtype), deterministic)


class _TiedLogits(torch.autograd.Function):
    """``llama._tied_logits`` (fp32 logits from bf16 operands, never
    rounded to bf16) with its backward written out: the fp32 gradient
    rounded to the operands' dtype, then two bf16 GEMMs."""

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


def tied_logits(x: torch.Tensor, wte: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ wte.T`` with ``wte`` cast to ``x.dtype``."""
    w = wte.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w.t()
    return _TiedLogits.apply(x, w)


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.n_embd, dtype=cfg.param_dtype, device=device))
        self.wpe = nn.Parameter(torch.empty(
            cfg.n_ctx, cfg.n_embd, dtype=cfg.param_dtype, device=device))
        self.h = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, cfg, device)

    def forward(self, input_ids, deterministic: bool = True,
                return_features: bool = False) -> torch.Tensor:
        """input_ids [B, T] -> fp32 logits [B, T, vocab], or with
        ``return_features`` the final hidden states [B, T, C] in
        ``cfg.dtype`` (the fused loss fetches the tied ``wte`` itself)."""
        cfg = self.cfg
        T = input_ids.shape[1]
        x = (F.embedding(input_ids.long(), self.wte).to(cfg.dtype)
             + self.wpe[:T].to(cfg.dtype))
        for block in self.h:
            if cfg.remat:
                x = checkpoint(block, x, deterministic, use_reentrant=False)
            else:
                x = block(x, deterministic)
        x = self.ln_f(x).to(cfg.dtype)
        if return_features:
            return x
        return tied_logits(x, self.wte)


# --------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------

def cross_entropy_loss(logits, targets, ignore_index: int = -100):
    """Mean token cross-entropy in fp32."""
    mask = targets != ignore_index
    tgt = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, tgt[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1)


def linear_cross_entropy(features, wte, targets, ignore_index: int = -100):
    """Tied-embedding projection + cross-entropy as logsumexp minus the
    gold logit, from fp32 logits that are not rounded to bf16."""
    mask = targets != ignore_index
    tgt = torch.where(mask, targets, 0).long()
    logits = tied_logits(features, wte)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / mask.sum().clamp(min=1)


def _chunk_loss(xx, tt, wte, ignore_index: int):
    logits = tied_logits(xx, wte)
    mask = tt != ignore_index
    tt = torch.where(mask, tt, 0).long()
    ll = torch.log_softmax(logits, dim=-1).gather(-1, tt[..., None])[..., 0]
    return -(ll * mask).sum(), mask.sum()


def fused_linear_cross_entropy(features, wte, targets, chunk: int = 128,
                               ignore_index: int = -100):
    """Projection + softmax cross-entropy over sequence chunks, each
    under ``torch.utils.checkpoint``: the [B, T, vocab] fp32 logits are
    never held whole, and the backward recomputes one chunk at a time.

    features: [B, T, C], wte: [V, C], targets: [B, T] int."""
    T = features.shape[1]
    n_chunks = max(1, T // chunk)
    if T % n_chunks:
        raise ValueError(f"seq {T} not divisible into {n_chunks} chunks")
    step = T // n_chunks
    loss_sum, count = 0.0, 0
    for i in range(n_chunks):
        sl = slice(i * step, (i + 1) * step)
        ls, cnt = checkpoint(_chunk_loss, features[:, sl], targets[:, sl],
                             wte, ignore_index, use_reentrant=False)
        loss_sum, count = loss_sum + ls, count + cnt
    return loss_sum / count.clamp(min=1)


# --------------------------------------------------------------------
# Sizes
# --------------------------------------------------------------------

def count_params(params) -> int:
    """Parameter count of a module or of a state dict."""
    tensors = (params.parameters() if isinstance(params, nn.Module)
               else params.values())
    return sum(t.numel() for t in tensors)


def flops_per_token(cfg: GPT2Config, seq_len: Optional[int] = None) -> float:
    """Approximate training FLOPs/token (fwd+bwd ≈ 6N + attention)."""
    T = seq_len or cfg.n_ctx
    n_params = (cfg.vocab_size * cfg.n_embd + cfg.n_ctx * cfg.n_embd +
                cfg.n_layer * (12 * cfg.n_embd ** 2) + 2 * cfg.n_embd)
    attn = 12 * cfg.n_layer * cfg.n_embd * T
    return 6.0 * n_params + attn


# --------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------

_DENSE = {"attn": ("c_attn", "c_proj"), "mlp": ("c_fc", "c_proj")}
_NORMS = ("ln_1", "ln_2")


def flax_state_dict(tree) -> Dict[str, torch.Tensor]:
    """The flax param tree of ``ray_tpu.models.gpt2.GPT2`` (numpy arrays;
    with or without the outer ``{"params": ...}``) as this module's
    fp32 state dict. Dense kernels [in, out] become weights [out, in]."""
    p = tree["params"] if "params" in tree else tree
    n_layer = sum(1 for key in p if key.startswith("h_"))
    sd = {"wte": p["wte"], "wpe": p["wpe"],
          "ln_f.scale": p["ln_f"]["scale"], "ln_f.bias": p["ln_f"]["bias"]}
    for i in range(n_layer):
        layer = p[f"h_{i}"]
        for mod, names in _DENSE.items():
            for name in names:
                d = layer[mod][name]
                sd[f"h.{i}.{mod}.{name}.weight"] = np.asarray(d["kernel"]).T
                sd[f"h.{i}.{mod}.{name}.bias"] = d["bias"]
        for norm in _NORMS:
            sd[f"h.{i}.{norm}.scale"] = layer[norm]["scale"]
            sd[f"h.{i}.{norm}.bias"] = layer[norm]["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def load_flax_params(model: GPT2, tree) -> GPT2:
    """Copy a flax GPT-2 param tree (numpy arrays) into ``model``.
    Returns the model."""
    model.load_state_dict(flax_state_dict(tree))
    return model


def init_params(cfg: GPT2Config, seed: int, device=None
                ) -> Dict[str, torch.Tensor]:
    """Random weights at flax's init scales, drawn with a
    ``torch.Generator`` seeded by ``seed`` on ``device`` (the card by
    default; ``"cpu"`` when asked): Dense kernels lecun-normal
    (truncated normal at 2 sigma, std sqrt(1/fan_in)/0.8796), biases 0,
    LayerNorm scales 1 and biases 0, ``wte`` normal(0.02), ``wpe``
    normal(0.01). A state dict in ``cfg.param_dtype``. The numbers
    differ from ``jax.random``'s for the same seed, and from one device
    to another."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = {}
    for name, t in GPT2(cfg, device="meta").state_dict().items():
        w = torch.empty(t.shape, dtype=cfg.param_dtype, device=device)
        if name in ("wte", "wpe"):
            w.normal_(0.0, 0.02 if name == "wte" else 0.01, generator=gen)
        elif name.endswith(".weight"):
            std = math.sqrt(1.0 / t.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        elif name.endswith(".scale"):
            w.fill_(1.0)
        else:
            w.zero_()
        sd[name] = w
    return sd


def build_model(cfg: GPT2Config, state_dict: Dict[str, torch.Tensor],
                device=None) -> GPT2:
    """A GPT2 on ``device`` (the card by default, ``"cpu"`` when asked)
    holding ``state_dict``'s weights in ``cfg.param_dtype``, built
    without a throwaway init; its parameters are trainable leaves."""
    device = resolve_device(device)
    model = GPT2(cfg, device="meta")
    model.load_state_dict(
        {k: state_dict[k].to(device=device, dtype=cfg.param_dtype,
                             copy=True)
         for k in model.state_dict()}, assign=True)
    return model
