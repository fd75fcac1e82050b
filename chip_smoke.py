"""End-to-end proof that the PyTorch/CUDA port (``ray_tpu_torch``)
builds, serves and trains on one NVIDIA GPU (written for an H100,
sm_90a).

    python3 chip_smoke.py [--seed N] [--out results.json]

Run from the root of a checkout; it needs one CUDA device, ``nvcc``
and nothing else of the repo than ``ray_tpu_torch``. Phases, each of
which raises on failure:

1. Device report: name, count, and ``nvidia-smi``'s name and power
   limit. Builds the port's CUDA sources with nvcc, one process per
   source, all started together.
2. Every kernel against its plain PyTorch version on the card: K1
   (``paged_decode_attention``) in fp32 over head_dim 64/128 and GQA
   groups 1/4/8 (tolerance 1e-4), with pos 0, a full window and
   null-page slots; in fp32 at the TinyLlama-1.1B decode shape with
   positions on each side of the split-K boundaries (1e-4); then at
   that shape in bf16 (4e-3 + one bf16 ulp, 2^-7, of the value: both
   round an fp32 result to bf16 once). Times the
   kernel, the plain version and one library call (SDPA over the
   pre-gathered window, a yardstick the port never calls) with CUDA
   events, L2 flushed before each launch, and computes the kernel's
   bound from this run's inputs.
3. Engine on the card against the engine on the CPU: one reduced fp32
   model with the same weights on both, 4 prompts on and off page
   boundaries, 16 greedy tokens each — the streams must be identical.
4. The main path at full width: ``LlamaDeployment`` with the
   TinyLlama-1.1B config (bf16, random weights from ``--seed``),
   16 slots, 64-token pages. After one warm-up request it answers 16
   requests (prompts of 16-1536 tokens, 64 new tokens each; 4 through
   ``stream``, 12 through ``generate_batch``) and checks every request
   got 64 tokens, that K1 was launched once per layer on every decode
   step, and, teacher-forced through the T > 1 gather path, that each
   generated token of 2 requests is the top logit or within 0.05 of
   it, both in bf16 and with the same bf16 weights evaluated in fp32.
   Prints output tok/s, TTFT p50, time
   per output token p50 (the streamed requests) and ms per decode step
   beside the card's name and power limit.
5. The flash-attention kernels against their plain versions on the
   card, each on the same inputs as its plain version: K3 (forward),
   K4 (dQ) and K5 (dK, dV) in fp32 at T 128/256/512 (one and several
   kv tiles), head_dim 16 (zero-padded to 64, as ``flash_attention``
   pads it), 64 and 128, causal and not (1e-4 abs and rel); at the
   GPT-2-124M shape (B 24, T 1024, H 12, D 64, causal) in fp32 (1e-4)
   and bf16 (output 4e-3 + 2^-7·|ref|, gradients 1e-2 + 2^-6·|ref|).
   Times each kernel, its plain version and the library yardstick
   (SDPA forward, backward and forward+backward, never called by the
   port) with CUDA events, L2 flushed before each launch, and computes
   each kernel's bound from this run's inputs.
6. The train step on the card against the train step on the CPU: a
   reduced fp32 GPT-2 (2 layers, C 128, H 4, vocab 1024, T 128, batch
   4) with flash attention, the same weights and batch on both sides,
   3 AdamW steps: losses and grad norms within 1e-4 relative.
7. The training main path at full width: GPT-2-124M (vocab 50304, 12
   layers, C 768, H 12, T 1024), bf16 compute on fp32 params, random
   weights from ``--seed``, batch 24 of ``RandomState(0)`` token ids,
   ``adamw(3e-4, weight_decay=0.1)``, as ``bench.py`` drives the JAX
   package: 1 warm-up step, then 10 timed steps on the fixed batch.
   Checks that K3, K4 and K5 were each launched 12 x 11 times, that
   every loss is finite and the last below the first, and that step
   1's loss and grad norm agree with the same step computed on the
   card with dense fp32-score attention (1e-2 and 2 %). Prints train
   tokens/s, ms per step, MFU (against 989 TFLOP/s bf16) and peak
   device memory beside the card's name and power limit.
8. The ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line.

Exits non-zero, printing no result, when no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core peak, same source
K1_FP32_TOL = 1e-4
K1_BF16_ATOL, K1_BF16_RTOL = 4e-3, 2.0 ** -7
SDPA_TOL = 2e-2                    # the yardstick rounds P to bf16
LOGIT_SLACK = 0.05
FLASH_FP32_TOL = 1e-4
FLASH_BF16_O = (4e-3, 2.0 ** -7)   # one rounding of an fp32 result
FLASH_BF16_GRAD = (1e-2, 2.0 ** -6)  # P and dS also rounded to bf16
TRAIN_RTOL = 1e-4


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``iters`` runs, CUDA events,
    with L2 (50 MB) evicted before each run: in a real decode step
    every layer's pages are cold."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    fn()
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def _decode_case(seed, B, H, KH, D, Pg, max_pages, n_pages, dtype,
                 positions=None, null_rows=()):
    g = np.random.default_rng(seed)
    pk = g.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    pv = g.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    pt = (g.permutation(n_pages - 1)[:B * max_pages] + 1).reshape(
        B, max_pages).astype(np.int32)
    for b in null_rows:
        pt[b] = 0
    if positions is None:
        positions = g.integers(0, max_pages * Pg, size=B)
    q = g.standard_normal((B, H, D)).astype(np.float32)
    dev = torch.device("cuda")
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(pk).to(dev, dtype),
            torch.from_numpy(pv).to(dev, dtype),
            torch.from_numpy(pt).to(dev),
            torch.from_numpy(np.asarray(positions, np.int32)).to(dev))


def _max_err(out, ref, atol, rtol=None) -> float:
    rtol = atol if rtol is None else rtol
    err = (out.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"kernel disagrees with its plain version: max abs err "
            f"{err.max().item()} at tolerance {atol} + {rtol} * |ref|")
    return err.max().item()


def phase_kernels(pa, seed: int) -> dict:
    """K1 against its plain version (fp32 cases, then the TinyLlama
    decode shape in bf16), with times and the bound."""
    for rep in (1, 4, 8):
        for D in (64, 128):
            args = _decode_case(seed + rep * 10 + D, 3, 2 * rep, 2, D, 16,
                                4, 40, torch.float32)
            _max_err(pa.paged_decode_attention(*args),
                     pa.paged_decode_attention_reference(*args),
                     K1_FP32_TOL)
    args = _decode_case(seed, 4, 8, 2, 64, 8, 3, 32, torch.float32,
                        positions=[0, 3 * 8 - 1, 5, 12], null_rows=(2,))
    _max_err(pa.paged_decode_attention(*args),
             pa.paged_decode_attention_reference(*args), K1_FP32_TOL)
    print("phase 2: K1 fp32 cases (rep 1/4/8, D 64/128, pos 0, full "
          f"window, null page) agree within {K1_FP32_TOL}")

    B, H, KH, D, Pg, max_pages = 16, 32, 4, 64, 64, 32
    # the main-path shape in fp32: windows that end on each side of the
    # split-K boundaries (pa._SPLIT_KEYS keys per split) and of a page
    split = pa._SPLIT_KEYS
    edges = [0, split - 2, split - 1, split, split + 1, 2 * split - 1,
             2 * split, Pg - 1, Pg, 7 * split - 1, 7 * split,
             max_pages * Pg - 1]
    rng = np.random.default_rng(seed + 1)
    positions = edges + rng.integers(0, max_pages * Pg,
                                     B - len(edges)).tolist()
    args = _decode_case(seed + 1, B, H, KH, D, Pg, max_pages,
                        B * max_pages + 1, torch.float32,
                        positions=positions)
    err32 = _max_err(pa.paged_decode_attention(*args),
                     pa.paged_decode_attention_reference(*args),
                     K1_FP32_TOL)
    print(f"phase 2: K1 fp32 at B={B} H={H} KH={KH} D={D} Pg={Pg} "
          f"max_pages={max_pages}, positions {sorted(positions)}: max abs "
          f"err {err32} (tol {K1_FP32_TOL})")

    q, pk, pv, pt, pos = _decode_case(seed, B, H, KH, D, Pg, max_pages,
                                      B * max_pages + 1, torch.bfloat16)
    out = pa.paged_decode_attention(q, pk, pv, pt, pos)
    ref = pa.paged_decode_attention_reference(q, pk, pv, pt, pos)
    err = _max_err(out, ref, K1_BF16_ATOL, K1_BF16_RTOL)

    # library yardstick: SDPA over the window gathered beforehand
    L = max_pages * Pg
    kg = pk[:, pt.long()].reshape(KH, B, L, D).transpose(0, 1)
    vg = pv[:, pt.long()].reshape(KH, B, L, D).transpose(0, 1)
    kg, vg = kg.contiguous(), vg.contiguous()
    mask = (torch.arange(L, device=q.device)[None]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True)

    torch.testing.assert_close(sdpa()[:, :, 0].float(), ref.float(),
                               rtol=SDPA_TOL, atol=SDPA_TOL)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=q.device)
    ms = _time_ms(lambda: pa.paged_decode_attention(q, pk, pv, pt, pos),
                  50, flush)
    plain_ms = _time_ms(
        lambda: pa.paged_decode_attention_reference(q, pk, pv, pt, pos),
        20, flush)
    library_ms = _time_ms(sdpa, 50, flush)

    # least work: each visible key and value read once, q read once,
    # out written once, the page-table entries walked, the positions
    keys = int((pos.long() + 1).clamp(max=L).sum().item())
    pages = int(((pos.long() // Pg) + 1).clamp(max=max_pages).sum().item())
    nbytes = (2 * keys * KH * D * 2 + 2 * B * H * D * 2 + 4 * pages
              + 4 * B)
    flops = 4 * keys * (H // KH) * KH * D        # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    print(f"phase 2: K1 bf16 B={B} H={H} KH={KH} D={D} Pg={Pg} "
          f"max_pages={max_pages}: max abs err {err} (tol {K1_BF16_ATOL}"
          f" + {K1_BF16_RTOL} * |ref|); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on the "
          f"gathered window {library_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f}"
          f" ms ({nbytes} bytes at 3.35 TB/s)")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/paged_decode_attention.cu",
            "replaces": "ray_tpu/ops/paged_attention.py:291",
            "launches": None, "max_abs_err": err,
            "max_abs_err_fp32": err32, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": {
                "B": B, "H": H, "KH": KH, "D": D, "page_size": Pg,
                "max_pages": max_pages, "keys": keys, "bytes": nbytes,
                "dtype": "bfloat16"}}


def _serve(model, prompts, n, device):
    from ray_tpu_torch.serve.engine import LLMEngine
    eng = LLMEngine(model, max_slots=4, page_size=16, n_pages=64,
                    chunk=4, device=device)
    hs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    while eng.step():
        pass
    if eng.alloc.occupancy():
        raise AssertionError(f"engine on {device} leaked pages")
    return [h.result() for h in hs]


def phase_engine_parity(tl, seed: int) -> None:
    """The same fp32 weights through the engine on the card (K1) and on
    the CPU (plain version): identical greedy streams."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tl.LlamaConfig(vocab_size=32000, max_seq_len=256, dim=512,
                         n_layers=2, n_heads=8, n_kv_heads=2,
                         hidden_dim=1024, dtype=torch.float32)
    sd = tl.init_params(cfg, seed=seed, device="cpu")
    g = np.random.default_rng(seed)
    prompts = [g.integers(0, cfg.vocab_size, n).tolist()
               for n in (1, 16, 17, 45)]
    cpu = _serve(tl.build_model(cfg, sd, "cpu"), prompts, 16, "cpu")
    gpu = _serve(tl.build_model(cfg, sd, "cuda"), prompts, 16, "cuda")
    if cpu != gpu:
        raise AssertionError(f"card and CPU streams differ:\n{gpu}\n{cpu}")
    print("phase 3: engine on the card == engine on the CPU (fp32, dim "
          "512, 8 q / 2 kv heads, 2 layers; prompts of 1/16/17/45 "
          "tokens, 16 greedy tokens each)")


def _teacher_forced_gaps(model, prompt, completion) -> list:
    """(top logit - logit of the generated token) at each completion
    position, from one T > 1 forward (gather path, no kernel) of
    ``model`` over prompt + completion in a fresh pool."""
    from ray_tpu_torch.models.kv_cache import init_kv_pool, kv_layer_view
    ids = prompt + completion[:-1]
    Pg = 64
    n = -(-len(ids) // Pg)
    pool = init_kv_pool(model.cfg, n + 1, Pg, device="cuda")
    pt = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")[None]
    logits = model(torch.tensor([ids], device="cuda"),
                   [kv_layer_view(layer, pt) for layer in pool],
                   torch.zeros(1, dtype=torch.int32, device="cuda"))[0]
    rows = logits[len(prompt) - 1:]
    tok = torch.tensor(completion, device="cuda")
    gap = rows.max(dim=-1).values - rows[torch.arange(len(completion)),
                                         tok]
    return gap.tolist()


def phase_main_path(tl, pa, seed: int, smi: str) -> dict:
    from ray_tpu_torch.models.kv_cache import kv_layer_view
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = tl.tinyllama_1_1b()
    n_new, n_req, n_stream = 64, 16, 4
    t0 = time.monotonic()
    params = tl.init_params(cfg, seed=seed, device="cuda")
    dep = LlamaDeployment(cfg, params, max_new_tokens=n_new, max_slots=16,
                          page_size=64, device="cuda")
    del params
    g = np.random.default_rng(seed)
    warm = dep(g.integers(0, cfg.vocab_size, 100).tolist())
    if len(warm) != 100 + n_new:
        raise AssertionError("warm-up request came back short")
    eng = dep.engine()
    torch.cuda.synchronize()
    t_setup = time.monotonic() - t0
    eng.reset_latency_stats()
    lengths = g.integers(16, 1537, size=n_req)
    prompts = [g.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lengths]

    streamed = [None] * n_stream
    stamps = [[] for _ in range(n_stream)]

    def stream(i):
        toks = []
        for t in dep.stream(prompts[i]):
            stamps[i].append(time.monotonic())
            toks.append(t)
        streamed[i] = toks

    pa.paged_decode_attention.launches = 0
    steps0 = eng.stats["decode_steps"]
    t1 = time.monotonic()
    threads = [threading.Thread(target=stream, args=(i,))
               for i in range(n_stream)]
    for t in threads:
        t.start()
    batch = dep.generate_batch(prompts[n_stream:])
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t1
    launches = pa.paged_decode_attention.launches
    steps = eng.stats["decode_steps"] - steps0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a streaming request did not finish")
    outs = streamed + batch
    if any(o is None or len(o) != n_new for o in outs):
        raise AssertionError(
            f"requests came back short: {[len(o or []) for o in outs]}")
    if steps <= 0 or launches != cfg.n_layers * steps:
        raise AssertionError(
            f"K1 launches {launches} != {cfg.n_layers} layers x {steps} "
            f"decode steps")

    # Teacher-forced check of 2 requests, at the same limit twice: the
    # same forward in bf16 (two bf16 paths, each with its own rounding),
    # and the same bf16 weights evaluated in fp32 (exact upcast), whose
    # gap measures the engine's own bf16 rounding.
    checked = (0, n_stream)
    gaps_bf16 = [g for i in checked
                 for g in _teacher_forced_gaps(dep.model, prompts[i],
                                               outs[i])]
    ref32 = tl.build_model(
        dataclasses.replace(cfg, dtype=torch.float32),
        {k: v.float() for k, v in dep.model.state_dict().items()}, "cuda")
    gaps = [g for i in checked
            for g in _teacher_forced_gaps(ref32, prompts[i], outs[i])]
    del ref32
    for kind, gs in (("bf16", gaps_bf16), ("fp32", gaps)):
        if max(gs) > LOGIT_SLACK:
            raise AssertionError(
                f"teacher-forced check: a generated token sits {max(gs)}"
                f" below the top {kind} logit (allowed {LOGIT_SLACK})")

    # ms per decode step at 16 slots: the engine's decode body (one
    # single-token forward + greedy pick) on the served pool, paced by
    # the host as in the engine, after the main path's counts are read
    pool_pages = eng.pages
    pt = torch.arange(1, 16 * 32 + 1, dtype=torch.int32,
                      device="cuda").reshape(16, 32)
    kv = [kv_layer_view(layer, pt) for layer in pool_pages]
    pos = torch.tensor((lengths + n_new - 1).tolist(), dtype=torch.int32,
                       device="cuda")
    cur = torch.zeros(16, dtype=torch.int32, device="cuda")
    for _ in range(3):
        cur = tl._pick_token(dep.model(cur[:, None], kv, pos)[:, -1], 0.0)
    torch.cuda.synchronize()
    n_steps = 20
    ts = time.monotonic()
    for _ in range(n_steps):
        cur = tl._pick_token(dep.model(cur[:, None], kv, pos)[:, -1], 0.0)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - ts) / n_steps * 1e3

    ttfts = sorted(eng.ttfts_s)
    # time per output token of each streamed request (first to last
    # token): tokens reach a stream in bursts, one per readback
    tpots = sorted((s[-1] - s[0]) / (len(s) - 1) for s in stamps)
    res = {
        "card": smi, "model": "tinyllama_1_1b bf16 (random weights, "
        f"seed {seed})", "requests": n_req, "new_tokens": n_new,
        "prompt_tokens": int(lengths.sum()), "wall_s": wall,
        "output_tok_s": n_req * n_new / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "tpot_p50_s": tpots[len(tpots) // 2],
        "decode_step_ms_16_slots": step_ms,
        "decode_steps": steps, "k1_launches": launches,
        "teacher_forced_max_gap_fp32": max(gaps),
        "teacher_forced_not_top_fp32": sum(g > 0 for g in gaps),
        "teacher_forced_max_gap_bf16": max(gaps_bf16),
        "teacher_forced_not_top_bf16": sum(g > 0 for g in gaps_bf16),
        "teacher_forced_positions": len(gaps), "setup_s": t_setup,
        "stats": dict(eng.stats)}
    print(f"phase 4: TinyLlama-1.1B bf16 via LlamaDeployment, {n_req} "
          f"requests x {n_new} tokens (prompts {int(lengths.min())}-"
          f"{int(lengths.max())}) on {smi}: output {res['output_tok_s']:.1f}"
          f" tok/s, TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms, time per "
          f"output token p50 {res['tpot_p50_s'] * 1e3:.2f} ms (streams), "
          f"decode step (16 slots) "
          f"{step_ms:.2f} ms; K1 launched {launches} times = "
          f"{cfg.n_layers} layers x {steps} decode steps; teacher-forced "
          f"over {len(gaps)} tokens: max gap to the top logit "
          f"{max(gaps):.4f} in fp32 ({res['teacher_forced_not_top_fp32']}"
          f" not top), {max(gaps_bf16):.4f} in bf16 "
          f"({res['teacher_forced_not_top_bf16']} not top)")
    dep.shutdown()
    return res


# --------------------------------------------------------------------
# Training: flash attention (K3, K4, K5) and the GPT-2 train step
# --------------------------------------------------------------------

def _flash_inputs(seed, B, T, H, D, dtype, pad_to=None):
    g = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        x = torch.from_numpy(g.standard_normal((B, T, H, D)).astype(
            np.float32)).to("cuda", dtype)
        if pad_to:
            x = torch.nn.functional.pad(x, (0, pad_to - D))
        out.append(x)
    return out


def _flash_errors(fa, q, k, v, do, causal, scale, limits):
    """Each of K3, K4, K5 against its plain version on the same inputs
    (the backward kernels get the plain forward's o and lse); raises
    past ``limits`` = {"o": (atol, rtol), "grad": (atol, rtol)}."""
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    ro, rlse = fa.flash_fwd_reference(q, k, v, causal, scale)
    dq = fa.flash_bwd_dq(q, k, v, ro, do, rlse, causal, scale)
    rdq = fa.flash_bwd_dq_reference(q, k, v, ro, do, rlse, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, ro, do, rlse, causal, scale)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, ro, do, rlse, causal,
                                          scale)
    torch.cuda.synchronize()
    refs = {"o": ro, "dq": rdq, "dk": rdk, "dv": rdv}
    if not all(bool(r.abs().max() > 0) for r in refs.values()):
        raise AssertionError("a plain version gave all zeros")
    return {"o": _max_err(o, ro, *limits["o"]),
            "lse": _max_err(lse, rlse, FLASH_FP32_TOL),
            "dq": _max_err(dq, rdq, *limits["grad"]),
            "dk": _max_err(dk, rdk, *limits["grad"]),
            "dv": _max_err(dv, rdv, *limits["grad"]),
            "max_abs_ref": max(r.abs().max().item() for r in refs.values())}


def phase_flash_kernels(fa, seed: int) -> list:
    """K3, K4, K5 against their plain versions (fp32 small cases, then
    the GPT-2-124M shape in fp32 and bf16), with times and bounds."""
    fp32 = {"o": (FLASH_FP32_TOL,), "grad": (FLASH_FP32_TOL,)}
    worst = 0.0
    for T in (128, 256, 512):
        for D in (16, 64, 128):
            for causal in (True, False):
                pad = 64 if D == 16 else None
                q, k, v, do = _flash_inputs(seed + T + D, 2, T, 3, D,
                                            torch.float32, pad)
                errs = _flash_errors(fa, q, k, v, do, causal, D ** -0.5,
                                     fp32)
                errs.pop("max_abs_ref")
                worst = max(worst, *errs.values())
    print(f"phase 5: K3/K4/K5 fp32 at T 128/256/512, D 16 (padded to 64)/"
          f"64/128, causal and not: max abs err {worst} (tol "
          f"{FLASH_FP32_TOL})")

    B, T, H, D = 24, 1024, 12, 64
    scale = D ** -0.5
    args = _flash_inputs(seed + 1, B, T, H, D, torch.float32)
    err32 = _flash_errors(fa, *args, True, scale, fp32)
    print(f"phase 5: K3/K4/K5 fp32 at B={B} T={T} H={H} D={D} causal: "
          f"max abs err {err32} (tol {FLASH_FP32_TOL})")
    del args
    q, k, v, do = _flash_inputs(seed, B, T, H, D, torch.bfloat16)
    err16 = _flash_errors(fa, q, k, v, do, True, scale,
                          {"o": FLASH_BF16_O, "grad": FLASH_BF16_GRAD})
    print(f"phase 5: K3/K4/K5 bf16 at the same shape: max abs err {err16} "
          f"(tol o {FLASH_BF16_O[0]} + {FLASH_BF16_O[1]} * |ref|, grads "
          f"{FLASH_BF16_GRAD[0]} + {FLASH_BF16_GRAD[1]} * |ref|)")

    ro, rlse = fa.flash_fwd_reference(q, k, v, True, scale)
    # library yardstick, on its own [B, H, T, D] layout
    sq, sk, sv, sdo = (t.transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    torch.testing.assert_close(sdpa(sq, sk, sv, is_causal=True).transpose(
        1, 2).float(), ro.float(), rtol=SDPA_TOL, atol=SDPA_TOL)
    gq, gk, gv = (t.clone().requires_grad_() for t in (sq, sk, sv))
    out = sdpa(gq, gk, gv, is_causal=True)

    def sdpa_fwd_bwd():
        o = sdpa(gq, gk, gv, is_causal=True)
        torch.autograd.grad(o, (gq, gk, gv), sdo)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    ms = {
        "fwd": _time_ms(lambda: fa.flash_fwd(q, k, v, True, scale), 20,
                        flush),
        "dq": _time_ms(lambda: fa.flash_bwd_dq(q, k, v, ro, do, rlse, True,
                                               scale), 20, flush),
        "dkv": _time_ms(lambda: fa.flash_bwd_dkv(q, k, v, ro, do, rlse,
                                                 True, scale), 20, flush)}
    plain = {
        "fwd": _time_ms(lambda: fa.flash_fwd_reference(q, k, v, True,
                                                       scale), 5, flush),
        "dq": _time_ms(lambda: fa.flash_bwd_dq_reference(
            q, k, v, ro, do, rlse, True, scale), 5, flush),
        "dkv": _time_ms(lambda: fa.flash_bwd_dkv_reference(
            q, k, v, ro, do, rlse, True, scale), 5, flush)}
    lib = {"fwd": _time_ms(lambda: sdpa(sq, sk, sv, is_causal=True), 20,
                           flush),
           "bwd": _time_ms(lambda: torch.autograd.grad(
               out, (gq, gk, gv), sdo, retain_graph=True), 20, flush),
           "fwd_bwd": _time_ms(sdpa_fwd_bwd, 20, flush)}

    # least work: every input read once, every output written once;
    # flops over the visible (query, key) pairs of this causal run
    x = q.numel() * q.element_size()
    lse_bytes = rlse.numel() * 4
    pairs = B * H * T * (T + 1) // 2
    spec = {"fwd": (4 * x + lse_bytes, 4 * pairs * D),
            "dq": (6 * x + lse_bytes, 6 * pairs * D),
            "dkv": (7 * x + lse_bytes, 8 * pairs * D)}
    rows = []
    for key, name, body, lib_ms, errs in (
            ("fwd", "flash_fwd", 91, lib["fwd"], ("o",)),
            ("dq", "flash_bwd_dq", 204, lib["bwd"], ("dq",)),
            ("dkv", "flash_bwd_dkv", 259, lib["bwd"], ("dk", "dv"))):
        nbytes, flops = spec[key]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{body}",
            "launches": None,
            "max_abs_err": max(err16[e] for e in errs),
            "max_abs_err_fp32": max(err32[e] for e in errs),
            "ms": ms[key], "plain_ms": plain[key],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "shape": {"B": B, "T": T, "H": H, "D": D, "causal": True,
                      "bytes": nbytes, "flops": flops,
                      "dtype": "bfloat16"}})
        print(f"phase 5: {name} bf16: kernel {ms[key]:.4f} ms, plain "
              f"{plain[key]:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
              f"({nbytes} bytes, {flops} flops)")
    print(f"phase 5: SDPA (is_causal) yardstick: forward {lib['fwd']:.4f}"
          f" ms, backward {lib['bwd']:.4f} ms, forward+backward "
          f"{lib['fwd_bwd']:.4f} ms")
    return rows


def _gpt2_loss(model, b):
    from ray_tpu_torch.models.gpt2 import linear_cross_entropy
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    return linear_cross_entropy(model(x, return_features=True), model.wte,
                                y)


def _trainer(cfg, sd, batch, device, lr):
    from ray_tpu_torch.models.gpt2 import build_model
    from ray_tpu_torch.train import spmd
    opt = spmd.adamw(lr, weight_decay=0.1)
    state = spmd.TrainState.create(build_model(cfg, sd, device), opt)
    return state, spmd.make_train_step(_gpt2_loss, opt), spmd.put_batch(
        batch, device)


def phase_train_parity(seed: int) -> None:
    """The same fp32 GPT-2 and batch trained 3 steps on the card
    (kernels) and on the CPU (plain versions)."""
    from ray_tpu_torch.models.gpt2 import gpt2_124m, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_124m(n_layer=2, n_embd=128, n_head=4, vocab_size=1024,
                    n_ctx=128, dtype=torch.float32, attention_impl="flash")
    sd = init_params(cfg, seed, device="cpu")
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(4, 129)).astype(np.int32)}
    runs = {}
    for device in ("cpu", "cuda"):
        state, step, b = _trainer(cfg, sd, batch, device, 3e-4)
        runs[device] = []
        for _ in range(3):
            state, m = step(state, b)
            runs[device].append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=TRAIN_RTOL)
    print(f"phase 6: GPT-2 fp32 train step (2 layers, C 128, H 4, vocab "
          f"1024, T 128, batch 4), 3 AdamW steps: (loss, grad norm) card "
          f"{runs['cuda']} == CPU {runs['cpu']} within {TRAIN_RTOL} rel")


def phase_train_main_path(fa, seed: int, smi: str) -> dict:
    """GPT-2-124M at batch 24, T 1024: 1 warm-up + 10 timed steps."""
    from ray_tpu_torch.models.gpt2 import (flops_per_token, gpt2_124m,
                                           init_params)
    cfg = gpt2_124m()
    B, T, n_steps = 24, 1024, 10
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T + 1), dtype=np.int32)}
    t0 = time.monotonic()
    sd = init_params(cfg, seed, device="cuda")

    # step 1 with dense fp32-score attention: what the kernels' step 1
    # is held to
    state, step, b = _trainer(
        dataclasses.replace(cfg, attention_impl="dense_fp32"), sd, batch,
        "cuda", 3e-4)
    state, m = step(state, b)
    ref_loss, ref_norm = m["loss"].item(), m["grad_norm"].item()
    del state, step, m
    torch.cuda.empty_cache()

    state, step, b = _trainer(cfg, sd, batch, "cuda", 3e-4)
    del sd
    torch.cuda.synchronize()
    t_setup = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kern in kernels:
        kern.launches = 0
    state, m = step(state, b)                    # warm-up: step 1
    losses = [m["loss"]]
    first_norm = m["grad_norm"].item()
    ts = time.monotonic()
    for _ in range(n_steps):
        state, m = step(state, b)
        losses.append(m["loss"])
    last = m["loss"].item()                      # waits for the device
    dt = time.monotonic() - ts
    launches = [kern.launches for kern in kernels]
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    want = cfg.n_layer * (n_steps + 1)
    if launches != [want] * 3:
        raise AssertionError(f"K3/K4/K5 launches {launches} != "
                             f"{cfg.n_layer} layers x {n_steps + 1} steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if abs(losses[0] - ref_loss) > 1e-2 or \
            abs(first_norm - ref_norm) > 0.02 * ref_norm:
        raise AssertionError(
            f"step 1 (loss {losses[0]}, grad norm {first_norm}) vs dense "
            f"fp32 attention (loss {ref_loss}, grad norm {ref_norm})")
    tok_s = B * T * n_steps / dt
    res = {"card": smi, "model": f"gpt2_124m bf16 on fp32 params (random "
           f"weights, seed {seed})", "batch": B, "seq": T,
           "timed_steps": n_steps, "train_tok_s": tok_s,
           "step_ms": dt / n_steps * 1e3,
           "mfu": tok_s * flops_per_token(cfg, T) / BF16_FLOPS,
           "peak_mem_gb": peak / 1e9, "losses": losses,
           "step1_loss": losses[0], "step1_loss_dense_fp32": ref_loss,
           "step1_grad_norm": first_norm,
           "step1_grad_norm_dense_fp32": ref_norm,
           "launches": dict(zip(("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv"), launches)),
           "setup_s": t_setup}
    print(f"phase 7: GPT-2-124M train, batch {B} x T {T}, bf16 on fp32 "
          f"params, on {smi}: {tok_s:.1f} tokens/s, {res['step_ms']:.2f} "
          f"ms/step, MFU {res['mfu']:.4f} (989 TFLOP/s bf16), peak memory "
          f"{res['peak_mem_gb']:.2f} GB; loss {losses[0]:.4f} -> "
          f"{last:.4f} over {n_steps + 1} steps; step 1 vs dense fp32 "
          f"attention: loss {losses[0]:.5f} / {ref_loss:.5f}, grad norm "
          f"{first_norm:.5f} / {ref_norm:.5f}; K3/K4/K5 launched "
          f"{launches} = {cfg.n_layer} layers x {n_steps + 1} steps")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every result to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    t0 = time.monotonic()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _nvidia_smi()
    print(f"phase 1: {name} x {count}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    print(smi)
    tb = time.monotonic()
    _build.compile_all([pa._SOURCE, fa._SOURCE])
    pa.load_kernel()
    fa.load_kernel()
    print(f"phase 1: built {pa._SOURCE} and {fa._SOURCE} for sm_90a in "
          f"{time.monotonic() - tb:.1f} s")

    k1 = phase_kernels(pa, args.seed)
    print(f"phase 2 done at {time.monotonic() - t0:.1f} s")
    phase_engine_parity(tl, args.seed)
    print(f"phase 3 done at {time.monotonic() - t0:.1f} s")
    main_path = phase_main_path(tl, pa, args.seed, smi)
    k1["launches"] = main_path["k1_launches"]
    print(f"phase 4 done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    flash = phase_flash_kernels(fa, args.seed)
    print(f"phase 5 done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    phase_train_parity(args.seed)
    print(f"phase 6 done at {time.monotonic() - t0:.1f} s")
    train = phase_train_main_path(fa, args.seed, smi)
    for row in flash:
        row["launches"] = train["launches"][row["name"]]
    kernels = {"kernels": [k1] + flash}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kernels": kernels["kernels"],
                       "main_path": main_path, "train_main_path": train,
                       "total_s": time.monotonic() - t0}, f, indent=1)
    print(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
