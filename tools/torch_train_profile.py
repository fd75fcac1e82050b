"""Where the time of the port's GPT-2 train step goes, on one NVIDIA GPU.

    python3 tools/torch_train_profile.py [--steps 5] [--seed 0]
        [--out profile.json]

Runs from the root of a checkout of the repo (it imports
``ray_tpu_torch``; no JAX). The step is the one ``chip_smoke.py``
phase 7 times: GPT-2-124M (bf16 compute on fp32 params, random weights
from ``--seed``) at batch 24 x T 1024 of ``RandomState(0)`` token ids,
AdamW, flash attention through the port's CUDA kernels. Under
``torch.profiler`` it reports, beside the card's name and power limit:
wall time per step (without the profiler), device-busy time per step
(sum of kernel times), the idle share, kernel launches per step, the
kernels that take the most device time, and the device time per step
of three groups: the flash kernels (K3, K4, K5), matrix products, and
everything else.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_decode_profile import _card, _profile  # noqa: E402

from ray_tpu_torch.models import gpt2  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_tpu_torch.train import spmd  # noqa: E402

# the kernels of csrc/flash_attention.cu, as the profiler names them
_FLASH = ("::fwd_kernel<", "::bwd_dq_kernel<", "::bwd_dkv_kernel<")
_GEMM = ("gemm", "xmma", "cutlass", "nvjet", "cublas")


def _loss(model, b):
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    return gpt2.linear_cross_entropy(model(x, return_features=True),
                                     model.wte, y)


def _groups(top_all) -> dict:
    out = {"flash_kernels_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    for name, ms in top_all:
        if any(k in name for k in _FLASH):
            out["flash_kernels_ms"] += ms
        elif any(k in name.lower() for k in _GEMM):
            out["matmul_ms"] += ms
        else:
            out["other_ms"] += ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    cfg = gpt2.gpt2_124m()
    B, T = 24, 1024
    model = gpt2.build_model(cfg, gpt2.init_params(cfg, args.seed, "cuda"),
                             "cuda")
    opt = spmd.adamw(3e-4, weight_decay=0.1)
    state = spmd.TrainState.create(model, opt)
    step = spmd.make_train_step(_loss, opt)
    batch = spmd.put_batch({"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T + 1), dtype=np.int32)}, "cuda")

    def train_step():
        step(state, batch)

    res = {"card": card, "torch": torch.__version__, "batch": B, "seq": T}
    prof = _profile(train_step, args.steps, top=None)
    res["train_step"] = {k: v for k, v in prof.items()
                         if k != "top_kernels_ms"}
    res["train_step"]["top_kernels_ms"] = prof["top_kernels_ms"][:12]
    res["train_step"].update(_groups(prof["top_kernels_ms"]))
    res["train_step"]["tokens_per_s"] = B * T / (prof["wall_ms"] / 1e3)
    print(f"GPT-2-124M train step, batch {B} x T {T}, on {card}: "
          f"{json.dumps(res['train_step'], indent=1)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
