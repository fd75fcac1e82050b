"""Where the time of the port's train step goes, on one NVIDIA GPU.

    python3 tools/torch_train_profile.py [--model {gpt2,llama-1.1b}]
        [--steps 5] [--seed 0] [--out profile.json]

Runs from the root of a checkout of the repo (it imports
``ray_tpu_torch``; no JAX). ``--model`` takes ``bench.py``'s names. The
step is the one ``chip_smoke.py`` times: for ``gpt2`` (default, phase
7) GPT-2-124M at batch 24 x T 1024, for ``llama-1.1b`` (phase 7b)
TinyLlama-1.1B widths with remat at batch 8 x T 1024 and the mean
cross-entropy of the fp32 logits; both bf16 compute on fp32 params,
random weights from ``--seed``, ``RandomState(0)`` token ids,
``adamw(3e-4, weight_decay=0.1)``, flash attention through the port's
CUDA kernels. Under
``torch.profiler`` it reports, beside the card's name and power limit:
wall time per step (without the profiler), device-busy time per step
(sum of kernel times), the idle share, kernel launches per step, the
kernels that take the most device time, and the device time per step
of the flash kernels (K3, K4, K5 and the delta pass each, and
together), matrix products, and everything else.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_decode_profile import _card, _profile  # noqa: E402

from ray_tpu_torch.models import gpt2  # noqa: E402
from ray_tpu_torch.models import llama  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_tpu_torch.train import spmd  # noqa: E402

# the flash kernels as the profiler names them: csrc/flash_attention.cu
# (scalar, fp32) and csrc/flash_attention_sm90.cu (bf16, with the delta
# pass that K4 and K5 share)
_FLASH = {"k3_ms": ("::fwd_kernel<", "::fwd_sm90<"),
          "k4_ms": ("::bwd_dq_kernel<", "::dq_sm90<"),
          "k5_ms": ("::bwd_dkv_kernel<", "::dkv_sm90<"),
          "delta_ms": ("::delta_kernel<",)}
_GEMM = ("gemm", "xmma", "cutlass", "nvjet", "cublas")


def _gpt2_loss(model, b):
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    return gpt2.linear_cross_entropy(model(x, return_features=True),
                                     model.wte, y)


def _llama_loss(model, b):
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    logits = model(x)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())


def _setup(name: str, seed: int):
    """(description, model, loss, batch size, sequence length, vocab
    size) of ``bench.py``'s ``--model name`` on the card."""
    if name == "llama-1.1b":
        cfg = llama.tinyllama_1_1b(max_seq_len=1024, remat=True)
        sd = llama.init_params(
            dataclasses.replace(cfg, dtype=cfg.param_dtype), seed, "cuda")
        return ("TinyLlama-1.1B (remat)",
                llama.build_train_model(cfg, sd, "cuda"), _llama_loss,
                8, 1024, cfg.vocab_size)
    cfg = gpt2.gpt2_124m()
    return ("GPT-2-124M",
            gpt2.build_model(cfg, gpt2.init_params(cfg, seed, "cuda"),
                             "cuda"), _gpt2_loss, 24, 1024, cfg.vocab_size)


def _groups(top_all) -> dict:
    out = dict.fromkeys(("flash_kernels_ms", *_FLASH, "matmul_ms",
                         "other_ms"), 0.0)
    for name, ms in top_all:
        kernel = next((key for key, names in _FLASH.items()
                       if any(k in name for k in names)), None)
        if kernel:
            out[kernel] += ms
            out["flash_kernels_ms"] += ms
        elif any(k in name.lower() for k in _GEMM):
            out["matmul_ms"] += ms
        else:
            out["other_ms"] += ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("gpt2", "llama-1.1b"),
                    default="gpt2")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device is visible",
              file=sys.stderr)
        return 2
    card = _card()
    fa.load_kernel()
    fa.load_kernel(sm90=True)
    what, model, loss, B, T, vocab = _setup(args.model, args.seed)
    opt = spmd.adamw(3e-4, weight_decay=0.1)
    state = spmd.TrainState.create(model, opt)
    step = spmd.make_train_step(loss, opt)
    batch = spmd.put_batch({"ids": np.random.RandomState(0).randint(
        0, vocab, size=(B, T + 1), dtype=np.int32)}, "cuda")

    def train_step():
        step(state, batch)

    res = {"card": card, "torch": torch.__version__, "model": args.model,
           "batch": B, "seq": T}
    prof = _profile(train_step, args.steps, top=None)
    res["train_step"] = {k: v for k, v in prof.items()
                         if k != "top_kernels_ms"}
    res["train_step"]["top_kernels_ms"] = prof["top_kernels_ms"][:12]
    res["train_step"].update(_groups(prof["top_kernels_ms"]))
    res["train_step"]["tokens_per_s"] = B * T / (prof["wall_ms"] / 1e3)
    print(f"{what} train step, batch {B} x T {T}, on {card}: "
          f"{json.dumps(res['train_step'], indent=1)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
