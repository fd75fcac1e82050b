"""Where a paged-decode kernel's time goes, block by block, on one
NVIDIA GPU.

    python3 tools/torch_decode_stamps.py [--split-keys 256,128,64]
        [--seed 2] [--out stamps.json]

Runs from the root of a checkout of the repo (it imports
``ray_tpu_torch``; no JAX). It copies the decode kernels' sources
(``ray_tpu_torch/ops/csrc/paged_decode_attention*``) into
``build/decode_stamps/src`` with a ``%globaltimer`` stamp taken by
thread 0 of every block at each phase boundary of the tensor-core split
pass and of its merge tail, builds that copy (the port's own build is
not touched), and runs bf16 K1 and bf16-q K2 at the TinyLlama-1.1B
decode shape (16 slots, 32 q / 4 kv heads, head_dim 64, 64-token pages,
positions drawn over the 2048-token window) for each split size, with
L2 flushed before each launch (``dirty``: zeroed, as chip_smoke.py
times the kernels) and not flushed (``none``). For the last launch it
prints, over the blocks with visible keys, the nanoseconds of each
phase: page ids and position (ids), K rows landed (and widened, for
int8), V rows landed, PV and the warps' merge (epilogue), the partial's
stores, the ticket, and the merging block's statistics and partials;
the span from the first block's start to the last block's end; and the
median CUDA-event time of 30 launches (the stamps cost a few
instructions per block, so the events read a little above the
kernel's own time). Random inputs from ``--seed``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import paged_attention as pa  # noqa: E402

SPIN_CYCLES = 4_000_000   # ~2 ms at the H100's 1.6-2 GHz SM clock
OUT = ROOT / "build" / "decode_stamps"
N_STAMPS, MAX_BLOCKS = 10, 8192

_DEFS = r'''
#ifndef RTT_STAMP_DEFS
#define RTT_STAMP_DEFS
__device__ unsigned long long g_stamps[%d][%d];
__device__ __forceinline__ void rtt_stamp(int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    g_stamps[i][blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                          blockIdx.z)] = t;
  }
}
#endif
''' % (N_STAMPS, MAX_BLOCKS)

_ENTRIES = '''
extern "C" int stamps_read(void* host) {
  return cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
extern "C" int stamps_clear() {
  static unsigned long long zero[%d][%d];
  return cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
}
''' % (N_STAMPS, MAX_BLOCKS)

# (file, anchor, stamp placed before the anchor): 0 block start, 1 past
# the exit test, 2 K landed, 3 V landed, 4 warps merged, 5 partial
# stored, 6 merging block chosen, 9 its statistics done, 7 merged, 8 a
# lone split's output written
_STAMPS = (
    ("paged_decode_attention_sm90.cuh", "  unsigned char* k_s = smem;\n", 0),
    ("paged_decode_attention_sm90.cuh",
     "  // 2. The warp's K rows as commit group 0", 1),
    ("paged_decode_attention_sm90.cuh", "  float sc[KW / 8][2];\n", 2),
    ("paged_decode_attention_sm90.cuh", "  float o[D / 8][2];\n", 3),
    ("paged_decode_attention_sm90.cuh",
     "  const bool alone = vis.splits == 1;", 4),
    ("paged_decode_attention.cuh",
     "  // The block's partial stores come before the ticket", 5),
    ("paged_decode_attention.cuh", "\n  // Round c0 of the partials", 6),
    ("paged_decode_attention.cuh", "\n  // 2. out = sum_s", 9),
)


def instrument() -> Path:
    """The stamped copy of the decode kernels' sources."""
    src = OUT / "src"
    src.mkdir(parents=True, exist_ok=True)
    texts = {p.name: p.read_text()
             for p in _build.CSRC.glob("paged_decode_attention*")}
    h = "paged_decode_attention.cuh"
    texts[h] = texts[h].replace("namespace {\n", "namespace {\n" + _DEFS, 1)
    for name, anchor, i in _STAMPS:
        if texts[name].count(anchor) != 1:
            raise RuntimeError(f"no single anchor {anchor!r} in {name}")
        texts[name] = texts[name].replace(anchor,
                                          f"  rtt_stamp({i});\n" + anchor)
    # a lone split's output written; the merge's output written
    for name, old, new in (
            ("paged_decode_attention_sm90.cuh", "  if (alone) return;\n",
             "  if (alone) {\n    rtt_stamp(8);\n    return;\n  }\n"),
            (h, "from_float<T>(o[j] / row_l[i / D]);\n  }\n",
             "from_float<T>(o[j] / row_l[i / D]);\n  }\n  rtt_stamp(7);\n")):
        if texts[name].count(old) != 1:
            raise RuntimeError(f"no single {old!r} in {name}")
        texts[name] = texts[name].replace(old, new)
    for name, text in texts.items():
        (src / name).write_text(text + (_ENTRIES if name.endswith(".cu")
                                        else ""))
    return src


def _pct(a) -> dict:
    a = np.asarray(a, np.float64)
    if a.size == 0:
        return {}
    return {"min": float(a.min()), "median": float(np.median(a)),
            "p90": float(np.percentile(a, 90)), "max": float(a.max()),
            "n": int(a.size)}


def _inputs(seed: int, int8: bool):
    g = np.random.default_rng(seed)
    B, H, KH, D, Pg, mp = 16, 32, 4, 64, 64, 32
    n_pages = B * mp + 1
    shape = (KH, n_pages, Pg, D)
    dev = torch.device("cuda")
    if int8:
        pk, pv = (torch.from_numpy(g.integers(-127, 128, shape).astype(
            np.int8)).to(dev) for _ in range(2))
        scales = [torch.from_numpy(g.uniform(0.1, 2.0, (KH, n_pages, 1))
                                   .astype(np.float32)).to(dev)
                  for _ in range(2)]
    else:
        pk, pv = (torch.from_numpy(g.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(2))
        scales = [None, None]
    pt = torch.from_numpy((g.permutation(n_pages - 1)[:B * mp] + 1)
                          .reshape(B, mp).astype(np.int32)).to(dev)
    pos = torch.from_numpy(g.integers(0, mp * Pg, B).astype(np.int32)).to(
        dev)
    q = torch.from_numpy(g.standard_normal((B, H, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    return q, pk, pv, pt, pos, scales


def stamps(lib, args, split: int, flush_kind: str, flush) -> dict:
    """Phase times (ns) over the live blocks of one launch, after 30
    launches timed with CUDA events."""
    q, pk, pv, pt, pos, (sk, sv) = args

    def launch():
        pa._launch_kernel(q, pk, pv, pt, pos, split, sk, sv)

    def before():
        if flush_kind == "dirty":
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)

    launch()
    times = []
    for it in range(30):
        if it == 29:
            torch.cuda.synchronize()
            lib.stamps_clear()
        before()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        launch()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    t = np.zeros((N_STAMPS, MAX_BLOCKS), np.uint64)
    lib.stamps_read(t.ctypes.data_as(ctypes.c_void_p))
    t = t.astype(np.int64)
    started, live, merged = t[0] > 0, t[1] > 0, t[6] > 0
    t0 = t[0][started].min()
    end = np.maximum(np.maximum(t[7], t[8]), t[5])
    part = live & (t[5] > 0)
    alone = live & (t[8] > 0)
    return {
        "event_us": _pct(times), "blocks": int(started.sum()),
        "live_blocks": int(live.sum()),
        "span_ns": int(end.max() - t0),
        "start_offset_ns": _pct(t[0][live] - t0),
        "ids_ns": _pct(t[1][live] - t[0][live]),
        "k_landed_ns": _pct(t[2][live] - t[1][live]),
        "v_landed_ns": _pct(t[3][live] - t[2][live]),
        "epilogue_ns": _pct(t[4][live] - t[3][live]),
        "partial_ns": _pct(t[5][part] - t[4][part]),
        "alone_ns": _pct(t[8][alone] - t[4][alone]),
        "ticket_ns": _pct(t[6][merged] - t[5][merged]),
        "merge_stats_ns": _pct(t[9][merged] - t[6][merged]),
        "merge_partials_ns": _pct(t[7][merged] - t[9][merged]),
        "block_end_ns": _pct(end[live] - t0),
        "merging_block_end_ns": _pct(t[7][merged] - t0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split-keys", default="256,128,64")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_stamps: no CUDA device is visible",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.CSRC = instrument()
    _build.BUILD_DIR = OUT / "lib"
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    res = {"card": card, "runs": []}
    for int8, name in ((False, "K1 bf16"), (True, "K2 bf16 q, int8 pages")):
        lib = pa.load_kernel(int8=int8)
        lib.stamps_read.argtypes = [ctypes.c_void_p]
        inputs = _inputs(args.seed, int8)
        for split in (int(s) for s in args.split_keys.split(",")):
            for flush_kind in ("dirty", "none"):
                r = stamps(lib, inputs, split, flush_kind, flush)
                r.update(kernel=name, split=split, flush=flush_kind)
                res["runs"].append(r)
                print(f"{name}, {split}-key splits, L2 {flush_kind}, on "
                      f"{card}:")
                for key, v in r.items():
                    if isinstance(v, dict) and v:
                        print(f"  {key:20s} median {v['median']:9.0f}  min "
                              f"{v['min']:9.0f}  p90 {v['p90']:9.0f}  max "
                              f"{v['max']:9.0f}  (n {v['n']})")
                print(f"  span {r['span_ns']} ns over {r['live_blocks']} "
                      f"live of {r['blocks']} blocks")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
