"""Port of ``ray_tpu/ops/attention.py``: attention with pluggable
implementations, [B, T, H, D] layout.

impl:
- ``"dense"``: einsum attention, the counterpart of ``xla_attention``
  with its ``precision="default"`` rule (scores in the input dtype,
  only the softmax in fp32);
- ``"dense_fp32"``: the same with fp32 scores (``precision="highest"``);
- ``"flash"``: ``ops.flash_attention`` (CUDA kernels on the card, their
  plain versions on the CPU);
- ``"auto"``: flash on a CUDA tensor when the shapes are ones flash
  takes (T and the kv length multiples of 128, equal lengths under
  causal, head_dim <= 128) and there is no bias; dense otherwise. The
  reference's thresholds on batch and length are TPU measurements and
  are not inherited, and nothing here catches a kernel's error to fall
  back to dense.

``"ring"`` (sequence-parallel) is not ported yet (ROADMAP.md queue 1,
item 14).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import flash_attention, unsupported

_NEG_INF = -1e30


def dense_attention(q, k, v, causal: bool = True,
                    bias: Optional[torch.Tensor] = None,
                    precision: str = "default") -> torch.Tensor:
    """Reference attention, [B, T, H, D] layout.

    precision="default": scores in the input dtype (bf16 for a bf16
    model; the scale is rounded to that dtype too) and only the softmax
    in fp32, whose probabilities are cast back to the input dtype for
    the product with v. "highest": fp32 scores throughout."""
    Tq, Tk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if precision == "highest":
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores * scale
    elif precision == "default":
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        scores = scores * torch.tensor(scale, dtype=scores.dtype).item()
    else:
        raise ValueError(f"unknown precision {precision!r}")
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    if causal:
        mask = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def multi_head_attention(q, k, v, causal: bool = True, impl: str = "auto",
                         bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    if impl == "auto":
        impl = ("flash" if bias is None and q.device.type == "cuda"
                and unsupported(q, k, causal) is None else "dense")
    if impl == "flash":
        if bias is not None:
            raise ValueError("impl='flash' takes no attention bias")
        return flash_attention(q, k, v, causal=causal)
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, bias=bias)
    if impl == "dense_fp32":
        return dense_attention(q, k, v, causal=causal, bias=bias,
                               precision="highest")
    if impl == "ring":
        raise NotImplementedError(
            "impl='ring' (sequence-parallel ring attention) is not ported "
            "yet (ROADMAP.md queue 1, item 14)")
    raise ValueError(f"unknown attention impl {impl!r}")


def padding_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] 1/0 mask -> additive [B, 1, 1, T] fp32 bias (0 keep, -1e30
    drop) broadcast over heads and query positions."""
    keep = attention_mask[:, None, None, :] > 0
    return torch.where(keep, 0.0, _NEG_INF).to(torch.float32)
