"""Where the time of the port's serving step goes, on one NVIDIA GPU.

    python3 tools/torch_decode_profile.py [--steps 20] [--seed 0]
        [--split-keys 64,128,256] [--out profile.json]

Runs from the root of a checkout of the repo (it imports
``ray_tpu_torch``; no JAX). Three measurements, each printed with the
card's name and power limit:

1. K1 (``paged_decode_attention``) at the TinyLlama-1.1B decode shape
   (16 slots, 32 q / 4 kv heads, head_dim 64, 64-token pages, bf16,
   positions drawn over the 2048-token window) for each split size in
   ``--split-keys``: median time over 50 launches, CUDA events, L2
   flushed before each.
2. One decode step of TinyLlama-1.1B at 16 slots (the engine's decode
   body: a single-token forward over the paged pool plus the greedy
   pick), ``--steps`` times under ``torch.profiler``: wall time per
   step, device-busy time per step (sum of kernel times), the idle
   share, kernel launches per step and the kernels that take the most
   device time.
3. The same for one chunked-prefill call (4 rows x 256 tokens).

Random weights from ``--seed``; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models.kv_cache import (init_kv_pool,  # noqa: E402
                                           kv_layer_view)
from ray_tpu_torch.ops import paged_attention as pa  # noqa: E402


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def k1_split_sweep(splits, seed: int) -> dict:
    g = np.random.default_rng(seed)
    B, H, KH, D, Pg, mp = 16, 32, 4, 64, 64, 32
    n_pages = B * mp + 1
    dev = torch.device("cuda")
    pk = torch.from_numpy(g.standard_normal((KH, n_pages, Pg, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    pv = torch.from_numpy(g.standard_normal((KH, n_pages, Pg, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    pt = torch.from_numpy((g.permutation(n_pages - 1)[:B * mp] + 1).reshape(
        B, mp).astype(np.int32)).to(dev)
    pos = torch.from_numpy(g.integers(0, mp * Pg, B).astype(np.int32)).to(dev)
    q = torch.from_numpy(g.standard_normal((B, H, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    ref = pa.paged_decode_attention_reference(q, pk, pv, pt, pos)
    out = {}
    for split in splits:
        err = (pa._launch_kernel(q, pk, pv, pt, pos, split).float()
               - ref.float()).abs().max().item()
        # all launches queued behind their flushes, one sync at the
        # end: the events time the device, not the host's launch
        events = []
        for _ in range(50):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            pa._launch_kernel(q, pk, pv, pt, pos, split)
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for s, e in events]
        out[split] = {"ms": sorted(times)[len(times) // 2],
                      "max_abs_err": err}
    return out


def _wall_s(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return time.monotonic() - t0


def _profile(fn, n: int, top: Optional[int] = 12) -> dict:
    """Per call of ``fn`` over ``n`` calls: wall time without the
    profiler, then the device's kernel time under ``torch.profiler``
    (which slows the host, so the idle share is taken against the
    unprofiled wall time); the ``top`` kernels by device time (all of
    them for ``None``)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    wall = _wall_s(fn, n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_profiled = _wall_s(fn, n)
    # device events, less the device-side spans of user annotations
    # (e.g. ``Optimizer.step``), which overlap the kernels they cover
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall / n * 1e3,
            "wall_ms_profiled": wall_profiled / n * 1e3,
            "device_busy_ms": busy_us / n / 1e3,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "kernel_launches": len(kernels) / n,
            "top_kernels_ms": [(name[:90], us / n / 1e3)
                               for name, us in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--split-keys", default="64,128,256")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device is visible",
              file=sys.stderr)
        return 2
    card = _card()
    res = {"card": card, "torch": torch.__version__}
    res["k1_split_ms"] = k1_split_sweep(
        [int(s) for s in args.split_keys.split(",")], args.seed)
    print(f"K1 by split size on {card}: {res['k1_split_ms']}")

    cfg = tl.tinyllama_1_1b()
    model = tl.build_model(cfg, tl.init_params(cfg, args.seed, "cuda"),
                           "cuda")
    g = np.random.default_rng(args.seed)
    S, mp, Pg = 16, 32, 64
    pool = init_kv_pool(cfg, S * mp + 1, Pg, device="cuda")
    pt = torch.arange(1, S * mp + 1, dtype=torch.int32,
                      device="cuda").reshape(S, mp)
    kv = [kv_layer_view(layer, pt) for layer in pool]
    pos = torch.from_numpy(g.integers(16, 1600, S).astype(np.int32)).cuda()
    cur = torch.zeros(S, dtype=torch.int32, device="cuda")

    def decode():
        tl._pick_token(model(cur[:, None], kv, pos)[:, -1], 0.0)

    res["decode_step"] = _profile(decode, args.steps)
    print(f"decode step, 16 slots, on {card}: "
          f"{json.dumps(res['decode_step'], indent=1)}")

    ids = torch.from_numpy(g.integers(0, cfg.vocab_size, (4, 256)).astype(
        np.int32)).cuda()
    pt4 = pt[:4]
    kv4 = [kv_layer_view(layer, pt4) for layer in pool]
    start = torch.zeros(4, dtype=torch.int32, device="cuda")

    def prefill():
        model(ids, kv4, start)

    res["prefill_4x256"] = _profile(prefill, max(3, args.steps // 4))
    print(f"prefill 4 x 256 tokens on {card}: "
          f"{json.dumps(res['prefill_4x256'], indent=1)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
