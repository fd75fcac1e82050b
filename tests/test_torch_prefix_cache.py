"""The port's prefix KV cache (ray_tpu_torch.serve.prefix_cache and the
engine's use of it) against the JAX package's, on the CPU.

Tree cases (tests/test_prefix_cache.py): the same operation sequence
runs through both packages' ``PrefixCache`` over their own
``BlockAllocator`` and must give the same results (pages, token counts,
refcounts, evictions, stats, digests); each case also asserts the
reference test's own properties.

Engine cases: each scenario runs on the JAX engine (``overlap=False``)
and on the port's engine with the same ``llama_tiny`` fp32 weights (the
flax params of PRNGKey(0)). Greedy streams must be IDENTICAL, and so
must ``cache_hit_tokens``, ``cache_hit_admissions`` and the prefill
tokens; the port's engine must end balanced (every usable page free or
cached) with the tree's invariants intact. Three more cases run the
int8 pool: a hit replays the identical quantized pages, eviction
cycles them leak-free, and a copy-on-write page carries its source's
scale column.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import kv_cache as jkv
from ray_tpu.models import llama as jl
from ray_tpu.serve import engine as jeng
from ray_tpu.serve import prefix_cache as jpc
from ray_tpu.serve.faults import check_quiesced
from ray_tpu_torch.models import kv_cache as tkv
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import prefix_cache as tpc

_PKGS = {"jax": (jpc, jkv), "torch": (tpc, tkv)}


# ------------------------------------------------------- tree cases


def _roundtrip(pc_mod, kv_mod):
    alloc = kv_mod.BlockAllocator(16)
    pc = pc_mod.PrefixCache(alloc, page_size=4)
    toks = list(range(1, 11))              # 10 tokens: 2 full pages
    pages = alloc.alloc(2)
    pc.insert(toks, pages, n_shared=0)
    assert pc.cached_pages == 2
    got, n = pc.match(toks)
    assert got == pages and n == 8         # page-granular, not 10
    got2, n2 = pc.match(toks[:6])
    assert got2 == pages[:1] and n2 == 4
    got3, n3 = pc.match(toks[:4] + [99, 99, 99, 99])
    assert got3 == pages[:1] and n3 == 4
    refs = [pc.ref_of(p) for p in pages]
    assert refs == [3, 1]
    pc.release(got + got2 + got3)
    assert [pc.ref_of(p) for p in pages] == [0, 0]
    pc.check_invariants()
    return [got, n, got2, n2, got3, n3, refs]


def _refcount_blocks_eviction(pc_mod, kv_mod):
    alloc = kv_mod.BlockAllocator(16)
    pc = pc_mod.PrefixCache(alloc, page_size=4)
    pages = alloc.alloc(2)
    pc.insert(list(range(8)), pages, n_shared=0)
    held, _ = pc.match(list(range(8)))
    out = [pc.evict(10)]
    assert out[0] == 0 and pc.cached_pages == 2   # everything referenced
    pc.release(held)
    out.append(pc.evict(10))
    assert out[1] == 2 and pc.cached_pages == 0 and alloc.n_free == 15
    pc.check_invariants()
    return out


def _lru_leaf_first(pc_mod, kv_mod):
    alloc = kv_mod.BlockAllocator(16)
    pc = pc_mod.PrefixCache(alloc, page_size=2)
    root_a_a2 = alloc.alloc(3)             # root -> a -> a2, root -> b
    pc.insert([1, 2, 3, 4, 5, 6], root_a_a2, n_shared=0)
    held, n = pc.match([1, 2, 9, 9])
    assert held == root_a_a2[:1] and n == 2
    b = alloc.alloc(1)
    pc.insert([1, 2, 9, 9], held + b, n_shared=1)
    assert pc.ref_of(root_a_a2[0]) == 0    # insert released the ref
    order = []
    for n_evict in (1, 1, 2):              # a2, then a, then b and root
        before = set(pc._nodes)
        assert pc.evict(n_evict) == n_evict
        order.append(sorted(before - set(pc._nodes)))
    assert order[:2] == [[root_a_a2[2]], [root_a_a2[1]]]
    assert pc.cached_pages == 0 and alloc.n_free == 15
    pc.check_invariants()
    return order


def _insert_dedupes(pc_mod, kv_mod):
    alloc = kv_mod.BlockAllocator(16)
    pc = pc_mod.PrefixCache(alloc, page_size=4)
    first, dup = alloc.alloc(1), alloc.alloc(1)
    pc.insert([1, 2, 3, 4], first, n_shared=0)
    free_before = alloc.n_free
    pc.insert([1, 2, 3, 4], dup, n_shared=0)
    assert pc.cached_pages == 1
    assert pc._nodes[first[0]].chunk == (1, 2, 3, 4)
    assert alloc.n_free == free_before + 1     # the duplicate went back
    pc.check_invariants()
    return [sorted(pc._nodes), alloc.n_free]


def _release_errors(pc_mod, kv_mod):
    alloc = kv_mod.BlockAllocator(16)
    pc = pc_mod.PrefixCache(alloc, page_size=4)
    pages = alloc.alloc(1)
    pc.insert([1, 2, 3, 4], pages, n_shared=0)
    msgs = []
    for bad in ([pages[0]], [13]):         # underflow; not cache-held
        with pytest.raises(RuntimeError) as ei:
            pc.release(bad)
        msgs.append(str(ei.value))
    held, _ = pc.match([1, 2, 3, 4])
    pc.release(held)                       # balanced: fine
    pc.check_invariants()
    return msgs


def _account_and_stats(pc_mod, kv_mod):
    pc = pc_mod.PrefixCache(kv_mod.BlockAllocator(16), page_size=4)
    pc.account(24, 8)
    s = pc.stats()
    assert s["hit_tokens"] == 24 and s["miss_tokens"] == 8
    assert s["hit_rate"] == 0.75
    return s


def _digest_chains(pc_mod, kv_mod):
    """Three disjoint chains (4, 2 and 1 pages deep): the capped
    advertisement is prefix-closed, longest first, backfilled."""
    alloc = kv_mod.BlockAllocator(32)
    pc = pc_mod.PrefixCache(alloc, page_size=4)
    chains = ([1] * 4 + [2] * 4 + [3] * 4 + [4] * 4, [5] * 4 + [6] * 4,
              [7] * 4)
    for toks in chains:
        pc.insert(toks, alloc.alloc(len(toks) // 4), n_shared=0)
    hA, hB, hC = (frozenset(pc_mod.path_hashes(t, 4)) for t in chains)
    assert pc.digest() == hA | hB | hC
    assert pc.digest(7) == hA | hB | hC
    assert pc.digest(4) == hA              # deepest path wins
    assert pc.digest(5) == hA | hC         # C backfills, B does not fit
    assert pc.digest(6) == hA | hB
    assert pc.digest(0) == frozenset()
    for limit in range(8):
        d = pc.digest(limit)
        assert len(d) <= limit
        for toks in chains:
            hs = pc_mod.path_hashes(toks, 4)
            for i, h in enumerate(hs):
                if h in d:
                    assert set(hs[:i]) <= d, (limit, i)
    return [sorted(pc.digest(limit)) for limit in range(8)]


def _digest_hotter_chain(pc_mod, kv_mod):
    alloc = kv_mod.BlockAllocator(16)
    pc = pc_mod.PrefixCache(alloc, page_size=4)
    D = [11] * 4 + [12] * 4
    E = [13] * 4 + [14] * 4
    pc.insert(D, alloc.alloc(2), n_shared=0)
    pc.insert(E, alloc.alloc(2), n_shared=0)
    out = [pc.digest(2)]
    assert out[0] == frozenset(pc_mod.path_hashes(E, 4))   # newer: hotter
    got, _ = pc.match(D)
    pc.release(got)
    out.append(pc.digest(2))
    assert out[1] == frozenset(pc_mod.path_hashes(D, 4))
    return out


@pytest.mark.parametrize("case", [
    _roundtrip, _refcount_blocks_eviction, _lru_leaf_first,
    _insert_dedupes, _release_errors, _account_and_stats, _digest_chains,
    _digest_hotter_chain], ids=lambda f: f.__name__.strip("_"))
def test_tree_case_matches_reference(case):
    assert case(*_PKGS["torch"]) == case(*_PKGS["jax"])


# ------------------------------------------------------ engine cases


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, flax params, torch model) of llama_tiny fp32."""
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tl.build_model(
        tl.llama_tiny(dtype=torch.float32), sd, "cpu")


def _makers(tiny):
    """Engine constructors of both packages with the same knobs."""
    jmodel, params, tmodel = tiny
    return {"jax": lambda **kw: jeng.LLMEngine(jmodel, params,
                                               overlap=False, **kw),
            "torch": lambda **kw: teng.LLMEngine(tmodel, device="cpu",
                                                 **kw)}


def _drain(eng):
    while eng.step():
        pass


def _balanced(eng):
    """Every usable page is free or cached, and no slot holds one."""
    check_quiesced(eng)
    eng.prefix_cache.check_invariants()
    return (eng.alloc.n_free + eng.prefix_cache.cached_pages
            == eng.alloc.n_pages - 1)


def _record(eng, streams):
    return {"streams": streams,
            "hit_tokens": eng.stats.get("cache_hit_tokens", 0),
            "hit_admissions": eng.stats.get("cache_hit_admissions", 0),
            "prefill_tokens": eng.stats.get("prefill_tokens", 0)}


def _hit_equals_cold(make):
    eng = make(max_slots=2, page_size=8, n_pages=32, chunk=4,
               prefix_cache=True)
    prefix = list(range(1, 25))            # 3 full pages
    h1 = eng.submit(prefix + [30, 31], max_new_tokens=10)
    _drain(eng)
    assert eng.stats.get("cache_hit_tokens", 0) == 0   # cold
    h2 = eng.submit(prefix + [40, 41, 42], max_new_tokens=10)
    _drain(eng)
    assert eng.stats["cache_hit_tokens"] == 24
    assert eng.stats["cache_hit_admissions"] == 1
    assert _balanced(eng)
    cold = make(max_slots=2, page_size=8, n_pages=32, chunk=4)
    h3 = cold.submit(prefix + [40, 41, 42], max_new_tokens=10)
    _drain(cold)
    assert h2.result() == h3.result()      # hit == cold, exactly
    return _record(eng, [h1.result(), h2.result()])


def _boundary_copy(make):
    eng = make(max_slots=2, page_size=8, n_pages=32, chunk=4,
               prefix_cache=True)
    p = list(range(1, 17))                 # exactly 2 pages
    h1 = eng.submit(p, max_new_tokens=8)
    _drain(eng)
    h2 = eng.submit(p, max_new_tokens=8)   # 100% cached
    _drain(eng)
    assert h1.result() == h2.result()
    # matched both pages but paid one token back for the re-prefill
    assert eng.stats["cache_hit_tokens"] == 15
    assert _balanced(eng)
    return _record(eng, [h1.result(), h2.result()])


def _hit_skips_prefill(make):
    eng = make(max_slots=2, page_size=8, n_pages=64, chunk=4,
               prefill_chunk=8, prefix_cache=True)
    prefix = list(range(1, 33))            # 4 pages: 4 chunks cold
    h1 = eng.submit(prefix + [50], max_new_tokens=4)
    _drain(eng)
    cold_tokens = eng.stats["prefill_tokens"]
    h2 = eng.submit(prefix + [60, 61], max_new_tokens=4)
    _drain(eng)
    assert eng.stats["prefill_tokens"] - cold_tokens == 2  # suffix only
    return _record(eng, [h1.result(), h2.result()])


def _churn(make):
    eng = make(max_slots=2, page_size=8, n_pages=32, chunk=4,
               prefix_cache=True)
    prefix = list(range(1, 17))
    streams = []
    for i in range(6):
        h = eng.submit(prefix + [100 + i, 200 + i], max_new_tokens=4)
        _drain(eng)
        streams.append(h.result())
        assert _balanced(eng)
        assert eng.prefix_cache.evictable_pages() \
            == eng.prefix_cache.cached_pages     # no refs leak
    assert eng.stats["cache_hit_tokens"] == 5 * 16
    return _record(eng, streams)


def _eviction_under_pressure(make):
    # 7 usable pages; each retired request caches its 2 prompt pages
    eng = make(max_slots=1, page_size=8, n_pages=8, chunk=4,
               prefix_cache=True)
    streams = []
    for i in range(3):
        h = eng.submit([10 * (i + 1) + j for j in range(16)],
                       max_new_tokens=4)
        _drain(eng)
        streams.append(h.result())
        assert _balanced(eng)
    assert eng.prefix_cache.cached_pages >= 4
    assert eng.alloc.n_free < 3            # the free list alone is short
    h = eng.submit([77 + j for j in range(17)], max_new_tokens=4)
    _drain(eng)
    streams.append(h.result())
    assert eng.prefix_cache.stats()["evictions"] > 0
    assert _balanced(eng)
    return {**_record(eng, streams),
            "evictions": eng.prefix_cache.evictions}


def _preemption_keeps_shared_pages(make):
    """A cache-hit slot preempted MID-PREFILL keeps its shared pages in
    the tree (refs back to 0, never on the free list)."""
    eng = make(max_slots=2, page_size=8, n_pages=64, chunk=2,
               prefill_chunk=8, prefix_cache=True)
    prefix = list(range(1, 17))            # 2 pages
    h0 = eng.submit(prefix + [90], max_new_tokens=4)
    _drain(eng)
    shared = list(eng.prefix_cache._nodes)[:2]
    long_tail = prefix + list(range(200, 224))
    h = eng.submit(long_tail, max_new_tokens=4)
    eng.step()                             # admit + first chunk
    with eng._lock:
        ixs = [i for i, s in enumerate(eng.slots)
               if s is not None and s.shared > 0]
        assert ixs, "expected a mid-prefill cache-hit slot"
        slot = eng.slots[ixs[0]]
        assert 0 < slot.prefilled < len(long_tail)
        held = slot.pages[:slot.shared]
        assert all(eng.prefix_cache.ref_of(p) == 1 for p in held)
        eng._preempt_locked(ixs[0])
        assert all(p in eng.prefix_cache._nodes for p in held)
        assert all(eng.prefix_cache.ref_of(p) == 0 for p in held)
        assert all(p not in eng.alloc._free_set for p in held)
    assert eng.stats["preemptions"] == 1
    _drain(eng)                            # re-admits, re-matches
    assert _balanced(eng)
    assert set(shared) <= set(eng.prefix_cache._nodes)
    return _record(eng, [h0.result(), h.result()])


def _cache_off_by_default(make):
    eng = make(max_slots=2, page_size=8, n_pages=32, chunk=4)
    assert eng.prefix_cache is None and eng.prefix_stats() is None
    h = eng.submit([1, 2, 3], max_new_tokens=4)
    _drain(eng)
    assert eng.alloc.n_free == eng.alloc.n_pages - 1
    assert eng.load_report()["prefix_digest"] == frozenset()
    return _record(eng, [h.result()])


def _load_report_bounds_digest(make):
    eng = make(max_slots=2, page_size=8, n_pages=32, chunk=4,
               prefix_cache=True, prefix_digest_max=2)
    prompt = list(range(1, 41))
    h = eng.submit(prompt, max_new_tokens=2)
    _drain(eng)
    assert eng.prefix_cache.cached_pages > 2
    digest = eng.load_report()["prefix_digest"]
    # the bounded digest is the prompt's LEADING pages
    assert digest == frozenset(tpc.path_hashes(prompt, 8)[:2])
    st = eng.prefix_stats()
    return {**_record(eng, [h.result()]), "digest": sorted(digest),
            "stats": st}


def _int8_prefix_hit_replays(make):
    # a hit reuses the quantized bytes and scale columns the first
    # request wrote, so the replay is token-identical
    rng = np.random.RandomState(7)
    prompt = rng.randint(1, 255, size=24).tolist()
    eng = make(max_slots=4, page_size=8, n_pages=64, chunk=4,
               prefill_chunk=16, eos_id=-1, kv_dtype="int8",
               prefix_cache=True)
    streams = []
    for _ in range(2):
        h = eng.submit(prompt, max_new_tokens=12)
        _drain(eng)
        streams.append(h.result())
    assert eng.prefix_stats()["hit_tokens"] > 0
    assert streams[0] == streams[1]
    assert _balanced(eng)
    return _record(eng, streams)


def _int8_eviction_leak_free(make):
    # 11 usable pages; each request transiently needs 4 and retires 2
    # into the cache, so request 5 must evict
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 255, size=20).tolist() for _ in range(6)]
    eng = make(max_slots=2, page_size=8, n_pages=12, chunk=4,
               prefill_chunk=16, eos_id=-1, kv_dtype="int8",
               prefix_cache=True)
    streams = []
    for p in prompts + prompts[:1]:
        h = eng.submit(p, max_new_tokens=12)
        _drain(eng)
        streams.append(h.result())
    assert eng.prefix_stats()["evictions"] > 0
    # prompt 0 again after its pages were evicted: the same write
    # history, so the same tokens
    assert streams[-1] == streams[0]
    assert _balanced(eng)
    return {**_record(eng, streams),
            "evictions": eng.prefix_stats()["evictions"]}


_SCENARIOS = [_hit_equals_cold, _boundary_copy, _hit_skips_prefill,
              _churn, _eviction_under_pressure,
              _preemption_keeps_shared_pages, _cache_off_by_default,
              _load_report_bounds_digest, _int8_prefix_hit_replays,
              _int8_eviction_leak_free]


@pytest.mark.parametrize("scenario", _SCENARIOS,
                         ids=lambda f: f.__name__.strip("_"))
def test_engine_case_matches_jax_engine(tiny, scenario):
    makers = _makers(tiny)
    port = scenario(makers["torch"])
    assert port == scenario(makers["jax"])


def test_cow_check_rejects_shared_page_writes(tiny):
    eng = _makers(tiny)["torch"](max_slots=1, page_size=8, n_pages=16,
                                 chunk=2, prefix_cache=True)
    slot = teng._Slot(req=types.SimpleNamespace(rid=7), pages=[1, 2, 3],
                      pos=16, cur=None, admit_seq=0,
                      prompt=list(range(20)), prefilled=16, shared=2)
    eng._check_cow_locked(slot, 16)            # the frontier: legal
    for bad in (15, 0):                        # inside shared pages
        with pytest.raises(RuntimeError, match="COW violation"):
            eng._check_cow_locked(slot, bad)


def test_int8_cow_copy_carries_the_scale_column(tiny):
    """A fully cached prompt's boundary page is copied into a private
    page with every tensor of the layer: the int8 bytes AND both scale
    columns, so the copy dequantizes exactly as its source."""
    eng = _makers(tiny)["torch"](max_slots=2, page_size=8, n_pages=32,
                                 chunk=4, kv_dtype="int8",
                                 prefix_cache=True)
    p = list(range(1, 17))                 # exactly 2 pages
    first = eng.submit(p, max_new_tokens=6)
    _drain(eng)
    src, _ = eng.prefix_cache.match(p)
    eng.prefix_cache.release(src)
    h = eng.submit(p, max_new_tokens=6)
    with eng._lock:
        eng._admit_locked()
        slot = next(s for s in eng.slots if s is not None)
        assert slot.shared == 1 and slot.prefilled == 15
        dst = slot.pages[slot.shared]
        assert dst != src[1]
        for layer in eng.pages:
            assert len(layer) == 4
            for t in layer:                # pages_k, pages_v, sk, sv
                assert torch.equal(t[:, dst], t[:, src[1]])
            assert layer[2][:, dst].abs().min() > 0   # real scales
    _drain(eng)
    assert h.result() == first.result()
    assert _balanced(eng)
