"""ray_tpu_torch.serve (LLMEngine, LlamaDeployment) on the CPU, held
against ray_tpu.models.llama.generate.

Both packages run ``llama_tiny(dtype=float32)`` with the flax params
from ``PRNGKey(0)`` (carried over by ``load_flax_params``). Greedy
streams must be IDENTICAL to JAX ``generate`` — no tolerance: fp32
logits agree to ~1e-6 and argmax ties are broken the same way (first
maximum). The scenarios follow tests/test_llm_engine.py; after every
test each engine it built must have returned every page.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.kv_cache import (BlockAllocator, init_kv_pool,
                                           kv_layer_store, kv_layer_view,
                                           kv_pool_page_bytes)
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve.engine import LLMEngine
from ray_tpu_torch.serve.errors import (EngineOverloaded, EngineShutdown,
                                        RequestCancelled, RequestError)
from ray_tpu_torch.serve.llm import LlamaDeployment
from ray_tpu_torch.serve.scheduler import PrefillGrant, SlotView, plan_step

_REF_TOKENS = 28      # greedy is prefix-consistent: one JAX generate per
                      # prompt serves every shorter budget


@pytest.fixture(scope="module")
def tiny():
    """(torch model, torch state dict, reference(prompt, n))."""
    cfg = jl.llama_tiny(dtype=jnp.float32)
    jmodel = jl.Llama(cfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    model = tl.build_model(tl.llama_tiny(dtype=torch.float32), sd, "cpu")
    cache = {}

    def reference(prompt, n):
        key = tuple(prompt)
        if key not in cache:
            out = jl.generate(jmodel, params,
                              jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=_REF_TOKENS,
                              temperature=0.0)
            cache[key] = np.asarray(out)[0, len(prompt):].tolist()
        assert n <= _REF_TOKENS
        return cache[key][:n]

    return model, sd, reference


@pytest.fixture(autouse=True)
def _no_page_leaks(monkeypatch):
    """After every scenario, each engine built must have its allocator
    back at zero occupancy (leaked page ids are named)."""
    created = []
    orig = LLMEngine.__init__

    def record(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        created.append(self)

    monkeypatch.setattr(LLMEngine, "__init__", record)
    yield
    for eng in created:
        assert eng.alloc.occupancy() == 0, (
            f"engine leaked pages: {sorted(eng.alloc.leak_report())[:16]}")


def _engine(model, **kw):
    return LLMEngine(model, device="cpu", **kw)


def _run(eng):
    while eng.step():
        pass


# ---------------------------------------------------------------- allocator


def test_allocator_basics():
    a = BlockAllocator(8)          # 7 usable, page 0 reserved
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert a.n_free == 4
    assert a.alloc(5) is None      # all-or-nothing
    assert a.n_free == 4
    a.free(got)
    assert a.n_free == 7
    with pytest.raises(ValueError):
        a.free(got)                # double free detected
    with pytest.raises(ValueError):
        a.free([0])                # null page is never freeable


def test_allocator_free_validation_is_atomic():
    a = BlockAllocator(8)
    got = a.alloc(4)
    with pytest.raises(ValueError):
        a.free([got[0], got[0]])   # same page twice in one call
    with pytest.raises(ValueError):
        a.free([got[1], 99])       # out-of-range id
    with pytest.raises(ValueError):
        a.free([got[2], 2.5])      # non-int id
    assert a.n_free == 3           # nothing accepted from rejected calls
    a.free(got)
    assert a.n_free == 7
    with pytest.raises(ValueError):
        a.alloc(-1)


def test_allocator_bytes_view():
    a = BlockAllocator(5, page_bytes=100)
    a.alloc(2)
    assert (a.occupancy(), a.bytes_in_use(), a.bytes_total()) == \
        (2, 200, 500)
    a.free(a.leak_report())
    assert BlockAllocator(5).bytes_in_use() is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_pool_layout_and_bytes_match_jax(dtype):
    from ray_tpu.models import kv_cache as jkv
    jcfg = jl.llama_tiny(dtype=getattr(jnp, dtype))
    tcfg = tl.llama_tiny(dtype=getattr(torch, dtype))
    assert kv_pool_page_bytes(tcfg, 16) == jkv.kv_pool_page_bytes(jcfg, 16)
    jpool = jkv.init_kv_pool(jcfg, 8, 16)
    tpool = init_kv_pool(tcfg, 8, 16, device="cpu")
    assert [tuple(t.shape) for layer in tpool for t in layer] == \
        [tuple(a.shape) for layer in jpool for a in layer]
    assert all(t.dtype == tcfg.dtype and not t.any()
               for layer in tpool for t in layer)
    view = kv_layer_view(tpool[0], torch.zeros(2, 3, dtype=torch.int32))
    assert view.page_size == 16
    store = kv_layer_store(view)
    assert store[0] is tpool[0][0] and store[1] is tpool[0][1]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_kv_pool(tcfg, 8, 16, kv_dtype="int8")
    with pytest.raises(ValueError):
        kv_pool_page_bytes(tcfg, 16, kv_dtype="int4")


# ------------------------------------------------------------------ parity


def test_paged_decode_matches_generate(tiny):
    model, _, ref = tiny
    eng = _engine(model, max_slots=2, page_size=8, n_pages=32, chunk=4)
    prompt = [5, 9, 2, 7, 11]
    h = eng.submit(prompt, max_new_tokens=12)
    _run(eng)
    assert h.result() == ref(prompt, 12)


def test_parity_across_prompt_lengths(tiny):
    """Prompt lengths off and on page boundaries, decoded together."""
    model, _, ref = tiny
    eng = _engine(model, max_slots=4, page_size=8, n_pages=64, chunk=4)
    prompts = [[3], [1, 2, 3, 4, 5, 6, 7, 8],      # exactly one page
               [4, 4, 4, 4, 4, 4, 4, 4, 4],        # one page + 1
               list(range(1, 14))]
    hs = [eng.submit(p, max_new_tokens=9) for p in prompts]
    _run(eng)
    assert [h.result() for h in hs] == [ref(p, 9) for p in prompts]


def test_chunked_prefill_over_several_rounds(tiny):
    """A prompt longer than prefill_chunk prefills over several rounds
    (chunks starting mid-page), interleaved with another slot's
    decode."""
    model, _, ref = tiny
    eng = _engine(model, max_slots=2, page_size=8, n_pages=32, chunk=2,
                  prefill_chunk=6)
    long_p, short_p = list(range(1, 14)), [3]
    h1 = eng.submit(short_p, max_new_tokens=16)
    h2 = eng.submit(long_p, max_new_tokens=8)
    _run(eng)
    assert h1.result() == ref(short_p, 16)
    assert h2.result() == ref(long_p, 8)
    assert eng.stats["prefills"] >= 3


# ------------------------------------------------- continuous batching


def test_join_leave_mid_decode(tiny):
    model, _, ref = tiny
    eng = _engine(model, max_slots=2, page_size=8, n_pages=64, chunk=2)
    p1, p2 = [5, 6, 7], [9, 8, 7, 6]
    h1 = eng.submit(p1, max_new_tokens=16)
    for _ in range(3):             # decode a few chunks solo
        eng.step()
    h2 = eng.submit(p2, max_new_tokens=8)   # joins mid-flight
    _run(eng)
    assert h1.result() == ref(p1, 16)
    assert h2.result() == ref(p2, 8)
    assert eng.stats["admitted"] == 2
    assert eng.stats["completed"] == 2


def test_slot_reuse_after_completion(tiny):
    model, _, ref = tiny
    eng = _engine(model, max_slots=2, page_size=8, n_pages=32, chunk=4)
    prompts = [[i + 1, i + 2] for i in range(6)]
    hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    _run(eng)
    assert [h.result() for h in hs] == [ref(p, 6) for p in prompts]
    assert eng.alloc.n_free == eng.alloc.n_pages - 1


def test_eos_frees_slot_early(tiny):
    model, _, ref = tiny
    prompt = [5, 9, 2]
    want = ref(prompt, 16)
    eos = want[3]                  # force an early stop on a real token
    eng = _engine(model, max_slots=2, page_size=8, n_pages=32, chunk=4,
                  eos_id=eos)
    h = eng.submit(prompt, max_new_tokens=16)
    _run(eng)
    assert h.result() == want[:want.index(eos) + 1]


def test_run_ahead_dispatch_coalescing(tiny):
    """With a full batch and no eos the engine runs ahead to the next
    completion instead of dispatching every ``chunk`` steps."""
    model, _, ref = tiny
    eng = _engine(model, max_slots=2, page_size=8, n_pages=32, chunk=4)
    p1, p2 = [3, 1, 4, 1, 5], [2, 7, 1, 8]
    h1 = eng.submit(p1, max_new_tokens=24)
    h2 = eng.submit(p2, max_new_tokens=24)
    _run(eng)
    assert h1.result() == ref(p1, 24)
    assert h2.result() == ref(p2, 24)
    assert eng.stats["chunks"] <= 4, dict(eng.stats)
    assert eng.stats["decode_steps"] >= 23


# ---------------------------------------------------------- preemption


def test_preemption_under_memory_pressure(tiny):
    """Pool too small for both requests at full length: the younger
    slot is evicted and recomputed after the elder completes — both
    streams still exact."""
    model, _, ref = tiny
    # each request needs ceil((4+28)/8)=4 pages; 6 usable
    eng = _engine(model, max_slots=2, page_size=8, n_pages=7, chunk=4)
    p1, p2 = [1, 2, 3, 4], [9, 8, 7, 6]
    h1 = eng.submit(p1, max_new_tokens=28)
    h2 = eng.submit(p2, max_new_tokens=28)
    _run(eng)
    assert h1.result() == ref(p1, 28)
    assert h2.result() == ref(p2, 28)
    assert eng.stats["preemptions"] >= 1


# ------------------------------------------------------------ lifecycle


def test_oversized_request_rejected(tiny):
    model, _, _ = tiny
    eng = _engine(model, max_slots=1, page_size=8, n_pages=4, chunk=2)
    with pytest.raises(RequestError):
        eng.submit([1] * 20, max_new_tokens=20)   # needs 5 > 3 pages
    with pytest.raises(RequestError):
        eng.submit([], max_new_tokens=4)
    with pytest.raises(RequestError):
        eng.submit([1], max_new_tokens=0)
    with pytest.raises(RequestError):
        eng.submit([1, 256], max_new_tokens=2)    # outside the vocab
    big = _engine(model, max_slots=1, page_size=8, n_pages=64, chunk=2)
    with pytest.raises(RequestError, match="max_seq_len"):
        big.submit([1] * 100, max_new_tokens=40)  # 140 > 128


def test_cancel_queued_and_decoding(tiny):
    model, _, ref = tiny
    # an eos that never comes bounds run-ahead, so h1 is still decoding
    # after two rounds
    eos = min(set(range(256)) - set(ref([5, 6, 7], 20) + ref([1, 2], 4)))
    eng = _engine(model, max_slots=1, page_size=8, n_pages=32, chunk=2,
                  eos_id=eos)
    h1 = eng.submit([5, 6, 7], max_new_tokens=20)
    h2 = eng.submit([1, 2], max_new_tokens=4)
    h3 = eng.submit([3, 4], max_new_tokens=4)
    eng.step()
    eng.step()
    assert h3.cancel()                       # still queued
    assert h1.cancel()                       # mid-decode
    assert not h1.cancel()                   # already closed
    _run(eng)
    for h in (h1, h3):
        with pytest.raises(RequestCancelled):
            h.result()
    assert h2.result() == ref([1, 2], 4)
    assert eng.stats["cancelled"] == 2


def test_max_queued_sheds(tiny):
    model, _, _ = tiny
    eng = _engine(model, max_slots=1, page_size=8, n_pages=32,
                  max_queued=1)
    h = eng.submit([1], max_new_tokens=2)
    with pytest.raises(EngineOverloaded):
        eng.submit([2], max_new_tokens=2)
    assert eng.load_report()["shed_total"] == 1
    _run(eng)
    assert len(h.result()) == 2


def test_shutdown_fails_queued_and_refuses_new(tiny):
    model, _, _ = tiny
    eng = _engine(model, max_slots=1, page_size=8, n_pages=32)
    h = eng.submit([1, 2], max_new_tokens=4)
    eng.shutdown()
    with pytest.raises(EngineShutdown):
        h.result()
    with pytest.raises(EngineShutdown):
        eng.submit([1], max_new_tokens=1)


def test_background_thread_streaming(tiny):
    model, _, ref = tiny
    eng = _engine(model, max_slots=4, page_size=8, n_pages=64,
                  chunk=2).start()
    prompts = [[i + 2, i + 5] for i in range(8)]
    results = [None] * len(prompts)

    def run(i):
        results[i] = list(eng.submit(prompts[i],
                                     max_new_tokens=8).stream())

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert eng.wait_idle(timeout_s=10)
    eng.drain()
    assert eng.draining
    eng.shutdown()
    assert results == [ref(p, 8) for p in prompts]


def test_load_report_fields(tiny):
    model, _, _ = tiny
    eng = _engine(model, max_slots=2, page_size=8, n_pages=16)
    eng.submit([1, 2, 3], max_new_tokens=5)
    rep = eng.load_report()
    assert rep["queue_depth"] == 1 and rep["free_slots"] == 2
    assert rep["outstanding_tokens"] == 8 and rep["has_work"]
    assert rep["kv_bytes_total"] == 16 * eng.page_bytes
    assert rep["device"] == "cpu"
    _run(eng)
    rep = eng.load_report()
    assert not rep["has_work"] and rep["kv_bytes_in_use"] == 0
    assert rep["ttft_ewma_s"] is not None


def test_engine_refuses_weights_on_another_device(tiny):
    _, sd, _ = tiny
    meta = tl.Llama(tl.llama_tiny(dtype=torch.float32), device="meta")
    with pytest.raises(ValueError, match="weights are on"):
        LLMEngine(meta, device="cpu")


def test_planner_interleaves_prefill_and_decode():
    slots = [SlotView(sid=0, admit_seq=0, prompt_remaining=0, owed=9,
                      seeded=True),
             SlotView(sid=1, admit_seq=1, prompt_remaining=40, owed=0,
                      seeded=False),
             SlotView(sid=2, admit_seq=2, prompt_remaining=10, owed=0,
                      seeded=False)]
    plan = plan_step(slots, total_slots=3, prefill_budget=32,
                     decode_chunk=4, max_run_ahead=64, prefill_batch=4,
                     eos_bounded=False)
    assert plan.prefill == (PrefillGrant(1, 32),)
    assert plan.decode_steps == 4          # quick cadence: work pending
    full = [SlotView(sid=i, admit_seq=i, prompt_remaining=0, owed=o,
                     seeded=True) for i, o in enumerate((30, 12))]
    plan = plan_step(full, total_slots=2, prefill_budget=32,
                     decode_chunk=4, max_run_ahead=64, prefill_batch=4,
                     eos_bounded=False)
    assert plan.decode_steps == 12         # run ahead to completion
    plan = plan_step(full, total_slots=2, prefill_budget=32,
                     decode_chunk=4, max_run_ahead=64, prefill_batch=4,
                     eos_bounded=True)
    assert plan.decode_steps == 8          # eos bounds run-ahead


# ----------------------------------------------------------- deployment


def test_deployment_entry_points(tiny):
    model, sd, ref = tiny
    dep = LlamaDeployment(tl.llama_tiny(dtype=torch.float32), params=sd,
                          max_new_tokens=6, max_slots=4, page_size=8,
                          device="cpu")
    try:
        p1, p2, p3 = [5, 9, 2, 7, 11], [3], [1, 2, 3, 4, 5, 6, 7, 8]
        assert dep(p1) == p1 + ref(p1, 6)
        assert list(dep.stream(p2)) == ref(p2, 6)
        assert dep.generate_batch([p3, p1]) == [ref(p3, 6), ref(p1, 6)]
        eng = dep.engine()
        assert eng is dep.engine()          # built once
        # full residency: every slot can reach max_seq_len
        assert eng.alloc.n_pages == 4 * (128 // 8) + 1
        # closing a stream early cancels the request
        gen = dep.stream(p3)
        next(gen)
        gen.close()
        assert eng.wait_idle(timeout_s=10)
    finally:
        dep.shutdown()


def test_readback_on_cpu_is_immediate():
    buf = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    rb = teng._Readback(buf)
    assert rb.ready()
    assert rb.get().tolist() == [[0, 1, 2], [3, 4, 5]]


def test_sampling_is_seeded_and_in_vocab(tiny):
    """temperature > 0 samples from softmax(logits / T) with the
    engine's own torch.Generator: the same seed gives the same stream,
    and a greedy run differs from it."""
    model, _, ref = tiny
    streams = []
    for seed in (7, 7, 8):
        eng = _engine(model, max_slots=2, page_size=8, n_pages=32,
                      chunk=4, temperature=1.0, seed=seed)
        hs = [eng.submit(p, max_new_tokens=12) for p in ([5, 9], [1])]
        _run(eng)
        streams.append([h.result() for h in hs])
    assert streams[0] == streams[1]
    assert all(0 <= t < 256 for s in streams for r in s for t in r)
    assert streams[0] != [ref([5, 9], 12), ref([1], 12)]
