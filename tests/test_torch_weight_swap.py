"""The port's hot weight swap (``LLMEngine.swap_weights`` and its
generation fence) against the JAX engine's, on the CPU.

Engine-level cases of tests/test_weight_rollout.py: a preempt-mode swap
mid-request is token-identical and fenced, the fence is strictly
monotonic, a drain-mode swap waits for idle, ``weights_tag``, and
shutdown releases a pending drain swap. Each runs in both packages
(``llama_tiny`` fp32, the flax params of PRNGKey(0), the JAX engine
with ``overlap=False``) and the records — streams, fence values, swap
events, stats — must be EQUAL. Where the reference's case races a
scheduler thread against the swap, these drive ``step()`` by hand, so
the flip lands at a known round. Added: a swap to other weights (the
flax params of PRNGKey(1)), held to the JAX engine after the same swap;
a pull in flight at a swap (its old-weight payload is dropped); and a
donor transfer open across a swap — the port's fence detaches the
pinned pages, which leave the pool with their last pin, where the
reference's would keep them matchable (ROADMAP.md, queue 3).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import engine as jeng
from ray_tpu.serve import kv_migration as jkm
from ray_tpu.serve.errors import EngineShutdown as JEngineShutdown
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import kv_migration as tkm
from ray_tpu_torch.serve.errors import EngineShutdown
from ray_tpu_torch.serve.prefix_cache import path_hashes

_SHUTDOWN = {"jax": JEngineShutdown, "torch": EngineShutdown}
_KM = {"jax": jkm, "torch": tkm}


@pytest.fixture(scope="module")
def tiny():
    """Per package: (make engine, weights of PRNGKey(0), of PRNGKey(1)),
    the torch weights as state dicts of the same flax params."""
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = [jmodel.init(jax.random.PRNGKey(k), jnp.zeros((1, 8),
                                                           jnp.int32))
              for k in (0, 1)]
    sds = [tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, p))
           for p in params]
    cfg = tl.llama_tiny(dtype=torch.float32)
    tmodel = tl.build_model(cfg, sds[0], "cpu")
    knobs = dict(max_slots=2, page_size=8, n_pages=64, chunk=4,
                 temperature=0.0, seed=0, prefix_cache=True,
                 overlap=False)

    def make_jax(weights=params[0], **kw):
        return jeng.LLMEngine(jmodel, weights, **{**knobs, **kw})

    def make_torch(weights=None, **kw):
        model = tmodel if weights is None else tl.build_model(cfg, weights,
                                                              "cpu")
        return teng.LLMEngine(model, device="cpu", **{**knobs, **kw})

    return {"jax": (make_jax, params[0], params[1]),
            "torch": (make_torch, sds[0], sds[1])}


def _drain(eng):
    while eng.step():
        pass


def _run(eng, prompt, n):
    h = eng.submit(list(prompt), max_new_tokens=n)
    _drain(eng)
    return h.result()


def _swap_events(eng):
    return [(e[2], e[5]) for e in eng.events.snapshot()
            if e[2].startswith("weight_swap")]


def _preempt_swap(make, w0, w1, same):
    """A preempt-mode swap while a request occupies a slot, after the
    cache was warmed: the straddling request recomputes through the
    preemption path; the fence advances; the cache is fenced."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    eng = make()
    warm = _run(eng, prompt, 4)
    assert eng.prefix_cache.cached_pages > 0
    h = eng.submit(list(prompt), max_new_tokens=12)
    eng.step()                       # prefill + one 4-step decode chunk
    with eng._lock:
        # whether that chunk was read back yet depends on readiness,
        # which differs between the packages; settle it so both flip at
        # one frontier (the flip's own drain would deliver it too, under
        # the old weights)
        eng._drain_fetches_locked()
        assert any(s is not None for s in eng.slots)
    before = list(h._req.generated)
    gen = eng.swap_weights(w0 if same else w1, weights_id="v2")
    _drain(eng)
    got = h.result()
    rpt = eng.load_report()
    ev = _swap_events(eng)
    assert gen == 1 and eng.weight_generation == 1
    assert eng.weights_id == "v2" and eng.stats["weight_swaps"] == 1
    assert (rpt["weight_generation"], rpt["weights_id"]) == (1, "v2")
    assert ev[0][0] == "weight_swap"
    assert ev[0][1]["preempted"] >= 1
    assert ev[0][1]["prefix_pages_evicted"] >= 1
    eng.shutdown()
    return {"warm": warm, "before": before, "got": got, "gen": gen,
            "events": ev, "preemptions": eng.stats["preemptions"]}


@pytest.mark.parametrize("same", [True, False],
                         ids=["same_tensors", "other_weights"])
def test_preempt_swap_matches_reference(tiny, same):
    recs = {pkg: _preempt_swap(*tiny[pkg], same) for pkg in tiny}
    assert recs["torch"] == recs["jax"]
    make, w0, w1 = tiny["torch"]
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    rec = recs["torch"]
    if same:
        # the same tensors under a new id: token-identical to no swap
        assert rec["got"] == _run(make(), prompt, 12)
    else:
        # the first tokens came from the old weights; the rest are the
        # new weights' recompute over prompt + those tokens
        k = len(rec["before"])
        assert rec["got"][:k] == rec["before"]
        assert rec["got"][k:] == _run(make(w1), prompt + rec["before"],
                                      12 - k)


def _flip_heartbeat(make, w0, _w1):
    """A preempt-mode flip on the caller's thread stamps the heartbeat,
    as a round does. The heartbeat is first aged by an hour, as an
    engine whose scheduler has been idle that long would have it; the
    stamp is then held against a clock reading taken just before the
    swap, whatever the time between them."""
    eng = make()
    _run(eng, [3, 1, 4, 1, 5, 9, 2, 6], 4)
    eng._hb -= 3600.0
    before = time.monotonic()
    eng.swap_weights(w0, weights_id="v2", mode="preempt")
    age = eng.load_report()["heartbeat_age_s"]
    after = time.monotonic()
    eng.shutdown()
    # the report's own clock reading lies in [before, after], so a
    # heartbeat stamped at or after `before` is at most this old
    return age <= after - before


def test_preempt_flip_refreshes_the_heartbeat(tiny):
    assert {pkg: _flip_heartbeat(*tiny[pkg]) for pkg in tiny} == \
        {"jax": True, "torch": True}


def _fence_monotonic(make, w0, _w1):
    eng = make()
    out = [eng.swap_weights(w0, weights_id="a")]
    for bad in (1, 0):
        with pytest.raises(ValueError) as ei:
            eng.swap_weights(w0, generation=bad, weights_id="b")
        out.append(str(ei.value))
    with pytest.raises(ValueError):
        eng.swap_weights(w0, mode="sideways")
    # rollback shape: the OLD payload under a NEW generation
    out += [eng.swap_weights(w0, weights_id="a"), eng.weights_id,
            eng.swap_weights(w0, generation=7), eng.weights_id]
    eng.shutdown()
    return out


def test_fence_is_strictly_monotonic(tiny):
    out = _fence_monotonic(*tiny["torch"])
    assert out == _fence_monotonic(*tiny["jax"])
    assert out[0] == 1 and out[3:] == [2, "a", 7, "g7"]


def _drain_swap(make, w0, w1):
    """Drain mode, driven round by round: admission pauses while the
    swap is pending, the request in flight finishes on the OLD weights,
    the flip lands once the engine settled, and later requests run on
    the new ones."""
    eng = make()
    h = eng.submit([5, 3, 8, 13, 2], max_new_tokens=10)
    eng.step()                                  # admitted, prefilling
    assert eng.swap_weights(w1, weights_id="v2", mode="drain",
                            wait=False) == 1
    queued = eng.submit([7, 7, 7], max_new_tokens=6)
    with pytest.raises(RuntimeError):
        eng.swap_weights(w1, mode="drain", wait=False)
    rounds_before_flip = 0
    while not h.done:
        assert eng.weight_generation == 0 and not queued.done
        with eng._lock:
            assert eng.slots.count(None) >= 1   # the queued one waits
        eng.step()
        rounds_before_flip += 1
    _drain(eng)
    assert rounds_before_flip >= 1
    out = {"inflight": h.result(), "queued": queued.result(),
           "gen": eng.weight_generation, "wid": eng.weights_id,
           "events": _swap_events(eng)}
    eng.shutdown()
    return out


def test_drain_swap_matches_reference(tiny):
    rec = _drain_swap(*tiny["torch"])
    assert rec == _drain_swap(*tiny["jax"])
    make, _w0, w1 = tiny["torch"]
    assert rec["inflight"] == _run(make(), [5, 3, 8, 13, 2], 10)
    assert rec["queued"] == _run(make(w1), [7, 7, 7], 6)
    assert [k for k, _ in rec["events"]] == ["weight_swap_pending",
                                             "weight_swap"]
    assert rec["events"][1][1]["mode"] == "drain"


def _drain_swap_threaded(make, w0, _w1):
    """The reference's case as it runs it: a thread waits in a drain
    swap while the scheduler thread finishes the request."""
    eng = make().start()
    try:
        h = eng.submit([5, 3, 8, 13, 2], max_new_tokens=10)
        done = {}
        t = threading.Thread(target=lambda: done.update(
            gen=eng.swap_weights(w0, weights_id="v2", mode="drain",
                                 timeout_s=60)), daemon=True)
        t.start()
        got = h.result()
        t.join(60)
        assert not t.is_alive()
        return got, done.get("gen"), eng.weights_id, [
            k for k, _ in _swap_events(eng)]
    finally:
        eng.shutdown()


def test_drain_swap_waits_for_idle(tiny):
    rec = _drain_swap_threaded(*tiny["torch"])
    assert rec == _drain_swap_threaded(*tiny["jax"])
    assert rec[1:] == (1, "v2", ["weight_swap_pending", "weight_swap"])


def _weights_tag(make, w0, _w1):
    eng = make()
    h = eng.submit([1, 2, 3], max_new_tokens=2)
    _drain(eng)
    tags = [h.weights_tag]
    eng.swap_weights(w0, weights_id="abc")
    h2 = eng.submit([1, 2, 3], max_new_tokens=2)
    _drain(eng)
    tags += [h2.weights_tag, h.weights_tag]
    eng.shutdown()
    return tags


def test_engine_handle_weights_tag(tiny):
    tags = _weights_tag(*tiny["torch"])
    assert tags == _weights_tag(*tiny["jax"])
    assert tags == ["0:g0", "1:abc", "1:abc"]


def _shutdown_releases(pkg, make, w0):
    eng = make()
    h = eng.submit([7, 7, 7, 7], max_new_tokens=64)
    eng.step()                                   # a slot is occupied
    err = {}

    def swapper():
        try:
            eng.swap_weights(w0, weights_id="v2", mode="drain",
                             timeout_s=60)
        except BaseException as e:  # noqa: BLE001 - recorded, asserted
            err["e"] = e

    t = threading.Thread(target=swapper, daemon=True)
    t.start()
    while eng._pending_swap is None:
        t.join(0.01)
    eng.shutdown()
    t.join(30)
    assert not t.is_alive()
    assert isinstance(err.get("e"), _SHUTDOWN[pkg])
    with pytest.raises(_SHUTDOWN[pkg]):
        h.result()
    return type(err["e"]).__name__, str(err["e"]), eng.weight_generation


def test_shutdown_releases_pending_drain_swap(tiny):
    assert (_shutdown_releases("torch", *tiny["torch"][:2])
            == _shutdown_releases("jax", *tiny["jax"][:2]))


def test_swap_metrics_keep_the_reference_names(tiny):
    from ray_tpu.util import metrics as jmetrics
    from ray_tpu_torch.util import metrics as tmetrics
    make, w0, _w1 = tiny["torch"]
    eng = make()
    eng.replica_tag = "r7"
    eng.swap_weights(w0, generation=3)
    eng.shutdown()
    names = {"serve_weight_swap_total", "serve_weight_generation"}
    assert names <= set(tmetrics.registry())
    jeng._metrics()
    jeng._weight_generation_gauge()
    assert names <= set(jmetrics.registry())
    assert 'serve_weight_generation{replica="r7"} 3.0' in \
        tmetrics.prometheus_text()


# ---------------------------------------------- the fence and KV pull

PREFIX = list(range(1, 33))                     # 4 pages of 8
PROMPT = PREFIX + [40, 41]


def _pull_in_flight(pkg, make, w0, w1):
    """A preempt swap on the requester while its pull is in flight: the
    swap preempts the pulling slot too, the payload (old-weight KV)
    arrives after the flip and is dropped, and the request recomputes
    on the new weights."""
    km = _KM[pkg]
    donor_eng = make()
    _run(donor_eng, PREFIX + [7, 7], 4)
    donor = km.KVDonor(donor_eng)
    req = make()
    gate, fetched = threading.Event(), threading.Event()

    def fetcher(pull):
        gate.wait(30)
        out = km.pull_prefix(km.loopback_call(donor), pull["hashes"],
                             stats=req.kv_migration_stats)
        fetched.set()
        return out

    req.kv_fetcher = fetcher
    h = req.submit(PROMPT, max_new_tokens=6,
                   pull={"hashes": path_hashes(PREFIX, 8)})
    req.step()
    with req._lock:
        assert any(s is not None and s.pulling for s in req.slots)
    req.swap_weights(w1, weights_id="v2")
    gate.set()
    assert fetched.wait(30)
    # the pull thread finishes under the engine lock after its fetcher
    # returns: let it drop the payload before the engine admits again
    for t in threading.enumerate():
        if t.name.startswith("kv-pull-"):
            t.join(30)
            assert not t.is_alive()
    _drain(req)
    got = h.result()
    rec = {"got": got, "stats": dict(req.kv_migration_stats),
           "landed": req.stats.get("kv_pull_landed", 0),
           "pulled_pages_landed": req.stats.get("kv_pulled_pages", 0),
           "fallbacks": req.stats.get("kv_pull_fallbacks", 0),
           "pull_events": [e[2] for e in req.events.snapshot()
                           if e[2].startswith("pull_")],
           "open_transfers": donor.open_transfers()}
    req.shutdown()
    donor_eng.shutdown()
    return rec


def test_pull_in_flight_at_a_swap(tiny):
    rec = _pull_in_flight("torch", *tiny["torch"])
    assert rec == _pull_in_flight("jax", *tiny["jax"])
    make, _w0, w1 = tiny["torch"]
    assert rec["got"] == _run(make(w1), PROMPT, 6)
    assert rec["stats"]["pulled_pages"] == 4       # it crossed the wire
    assert rec["landed"] == rec["pulled_pages_landed"] == 0
    assert rec["fallbacks"] == 0 and rec["pull_events"] == ["pull_start"]
    assert rec["open_transfers"] == 0


def test_donor_transfer_open_across_a_swap_is_fenced(tiny):
    """The port's fence holds where the reference's leaks: pages pinned
    by an open donor transfer at the flip are no longer matchable,
    their export is refused, and they leave the pool when the transfer
    ends; a local request over that prefix then misses and runs on the
    new weights only."""
    make, _w0, w1 = tiny["torch"]
    eng = make(n_pages=32)
    _run(eng, PREFIX + [7, 7], 4)
    donor = tkm.KVDonor(eng)
    begin = donor.begin(path_hashes(PREFIX, 8))
    assert begin["n_pages"] == 4
    eng.swap_weights(w1, weights_id="v2")
    pc = eng.prefix_cache
    assert pc.cached_pages == 0
    assert eng.kv_pin_prefix(path_hashes(PREFIX, 8)) == []
    with pytest.raises(tkm.KVPullAborted, match="earlier weight"):
        donor.chunk(begin["xfer_id"], 0)
    assert eng.alloc.occupancy() == 4              # still pinned
    pc.check_invariants()
    assert donor.end(begin["xfer_id"]) == {"released": True}
    assert pc.cached_pages == 0 and eng.alloc.occupancy() == 0
    pc.check_invariants()
    hits0 = eng.stats.get("cache_hit_tokens", 0)
    got = _run(eng, PROMPT, 6)
    assert eng.stats.get("cache_hit_tokens", 0) == hits0
    assert got == _run(make(w1), PROMPT, 6)
    assert eng.alloc.occupancy() == pc.cached_pages
    eng.shutdown()
