"""The port's disaggregated prefill/decode pool
(``ray_tpu_torch/serve/engine_pool.py`` roles) against the JAX
package's, on the CPU.

- The scripted-fake cases of tests/test_disagg.py (construction
  contracts, the two-leg split with its push hint, the decode-in-place
  fallback, the batch lane and session stickiness kept off prefill
  replicas, two per-role autoscalers over ``RolePoolView``s of one
  pool) run through both packages' ``EnginePool`` with the same seed
  and, for the autoscalers, one fake clock. Each side's fake engine
  raises its own package's typed errors. Each case returns a record —
  what each fake was sent (prompt, budget, pull hint), ``route_stats``,
  ``pool_stats()`` and the pool's events (kind and data) — and the two
  records must be equal.
- The two real-engine cases (``llama_tiny`` fp32 with the flax params
  of PRNGKey(0)): a prefill + decode pool of port engines streams JAX
  ``generate``'s tokens through the handoff (the decode leg pulls the
  prompt's 3 full pages) and again through the decode-dead fallback.
- The deployment's role knobs against the JAX ``LlamaDeployment``: the
  same ``ValueError`` for each bad combination. Its ``fleet=`` case
  waits for the fleet (ROADMAP.md, queue 1, item 9).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import engine_pool as jpool
from ray_tpu.serve import errors as jerr
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import pool_autoscaler as jscale
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import engine_pool as tpool
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import faults as tfaults
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import pool_autoscaler as tscale
from ray_tpu_torch.serve.scheduler import (LANE_BATCH, ROLE_DECODE,
                                           ROLE_PREFILL, ROLE_UNIFIED)

_SIDES = {
    "jax": types.SimpleNamespace(pool=jpool, errors=jerr, scale=jscale),
    "torch": types.SimpleNamespace(pool=tpool, errors=terr, scale=tscale),
}


@pytest.fixture(autouse=True)
def _no_page_leaks(monkeypatch):
    """Every port engine built in a case ends with allocator occupancy
    == prefix-cache residency."""
    created = []
    orig = teng.LLMEngine.__init__

    def record(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        created.append(self)

    monkeypatch.setattr(teng.LLMEngine, "__init__", record)
    yield
    for eng in created:
        cached = (eng.prefix_cache.cached_pages
                  if eng.prefix_cache is not None else 0)
        assert eng.alloc.occupancy() == cached


# ------------------------------------------------------- fake engines


class FakeHandle:
    def __init__(self, tokens):
        self._tokens = list(tokens)

    def stream(self):
        yield from self._tokens

    def cancel(self):
        return True


class FakeEngine:
    """The pool-facing engine surface, scripted; takes the whole
    disaggregated submit signature (``pull=``, ``priority=``) and keeps
    every call."""

    def __init__(self, errors, idx, *, outstanding=0, page_size=16,
                 report_extra=None):
        self.errors = errors
        self.idx = idx
        self.Pg = page_size
        self._stopped = False
        self._draining = False
        self.outstanding = outstanding
        self.report_extra = dict(report_extra or {})
        self.submits = []
        self.script = []
        self.started = False

    def start(self):
        self.started = True
        return self

    def submit(self, prompt, max_new_tokens=64, deadline_s=None, **kw):
        if self._stopped:
            raise self.errors.EngineShutdown("engine stopped")
        self.submits.append((list(prompt), max_new_tokens, kw))
        out = self.script.pop(0) if self.script else [1, 2]
        return FakeHandle(out)

    def shutdown(self):
        self._stopped = True

    def drain(self):
        self._draining = True

    def wait_idle(self, timeout_s=30.0):
        return True

    def is_idle(self):
        return True

    def load_report(self):
        rpt = {"free_slots": 4, "free_pages": 100, "queue_depth": 0,
               "outstanding_tokens": self.outstanding,
               "max_queued": None, "shed_retry_after_s": 1.0,
               "draining": self._draining, "stopped": self._stopped,
               "prefix_digest": frozenset()}
        rpt.update(self.report_extra)
        return rpt

    def prefix_stats(self):
        return None

    def spec_stats(self):
        return None

    def lifecycle_stats(self):
        return {"max_queued": None, "max_retries": 2,
                "retry_backoff_s": 0.02, "shed": 0}


def _record(pool, fakes, extra=None):
    rec = {"submits": [f.submits for f in fakes],
           "route_stats": dict(pool.route_stats),
           "pool_stats": pool.pool_stats(),
           "events": [(e[2], e[4], e[5]) for e in pool.events.snapshot()]}
    rec.update(extra or {})
    return rec


def _both(case):
    rec = {pkg: case(side) for pkg, side in _SIDES.items()}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def _disagg_pool(s, fakes, n=None, **kw):
    kw.setdefault("share_prefixes", True)
    kw.setdefault("roles", [ROLE_PREFILL, ROLE_DECODE])
    return s.pool.EnginePool(lambda i: fakes[i], n or len(fakes), **kw)


def _roles_must_name_every_replica(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    with pytest.raises(ValueError, match="every replica") as ei:
        s.pool.EnginePool(lambda i: fakes[i], 2, share_prefixes=True,
                          roles=[ROLE_PREFILL])
    return {"msg": str(ei.value)}


def _unknown_role_rejected_at_construction(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    with pytest.raises(ValueError, match="unknown replica role") as ei:
        s.pool.EnginePool(lambda i: fakes[i], 2, share_prefixes=True,
                          roles=[ROLE_PREFILL, "decoder"])
    return {"msg": str(ei.value)}


def _disaggregated_pool_requires_share_prefixes(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    with pytest.raises(ValueError, match="share_prefixes") as ei:
        s.pool.EnginePool(lambda i: fakes[i], 2,
                          roles=[ROLE_PREFILL, ROLE_DECODE])
    # an all-unified roles list is not disaggregated: no wiring needed
    pool = s.pool.EnginePool(lambda i: fakes[i], 2,
                             roles=[ROLE_UNIFIED, ROLE_UNIFIED])
    assert not pool.disaggregated()
    pool.shutdown()
    return _record(pool, fakes, {"msg": str(ei.value)})


def _pool_kv_pull_knobs_validated_at_construction(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    with pytest.raises(ValueError, match="kv pull deadline_s") as ei:
        _disagg_pool(s, fakes, kv_pull_deadline_s=-1.0)
    return {"msg": str(ei.value)}


def _two_leg_split_routes_prefill_then_decode_with_hint(s):
    prompt = list(range(1, 33))            # 2 full pages at Pg=16
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    fakes[0].script = [[5]]                # leg 1: the bridging token
    fakes[1].script = [[6, 7, 8]]          # leg 2: the rest
    pool = _disagg_pool(s, fakes)
    assert pool.disaggregated()
    assert pool.role_counts() == {ROLE_PREFILL: 1, ROLE_DECODE: 1}
    toks = pool.submit(prompt, max_new_tokens=4).result()
    assert toks == [5, 6, 7, 8]
    (p1, mnt1, _), = fakes[0].submits
    assert (p1, mnt1) == (prompt, 1)
    (p2, mnt2, kw2), = fakes[1].submits
    assert (p2, mnt2) == (prompt + [5], 3)
    assert kw2["pull"]["replica_idx"] == 0
    assert len(kw2["pull"]["hashes"]) == 2
    ps = pool.pool_stats()
    assert ps["disagg_handoffs"] == 1
    assert ps.get("disagg_handoff_fallbacks", 0) == 0
    kinds = [e[2] for e in pool.events.snapshot()]
    assert "handoff" in kinds and "handoff_first_token" in kinds
    pool.shutdown()
    return _record(pool, fakes)


def _dead_decode_side_falls_back_to_decode_in_place(s):
    prompt = list(range(1, 33))
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    fakes[0].script = [[5], [6, 7, 8]]     # leg 1, then the fallback
    pool = _disagg_pool(s, fakes)
    fakes[1]._stopped = True               # the decode side dies
    toks = pool.submit(prompt, max_new_tokens=4).result()
    assert toks == [5, 6, 7, 8]
    assert [sub[:2] for sub in fakes[0].submits] == [
        (prompt, 1), (prompt + [5], 3)]
    assert "pull" not in fakes[0].submits[1][2]
    assert pool.pool_stats()["disagg_handoff_fallbacks"] == 1
    assert "handoff_fallback" in [e[2] for e in pool.events.snapshot()]
    pool.shutdown()
    return _record(pool, fakes)


def _single_token_requests_skip_the_handoff(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    fakes[0].script = [[9]]
    fakes[1].script = [[9]]
    pool = _disagg_pool(s, fakes)
    pool.submit(list(range(1, 33)), max_new_tokens=1).result()
    assert pool.pool_stats().get("disagg_handoffs", 0) == 0
    pool.shutdown()
    return _record(pool, fakes)


def _batch_lane_never_lands_on_prefill_replica(s):
    # the prefill replica is emptier: batch must still skip it
    fakes = [FakeEngine(s.errors, 0, outstanding=0),
             FakeEngine(s.errors, 1, outstanding=900)]
    pool = _disagg_pool(s, fakes)
    pool.submit(list(range(8)), max_new_tokens=4,
                priority=LANE_BATCH).result()
    assert fakes[0].submits == [] and len(fakes[1].submits) == 1
    pool.shutdown()
    return _record(pool, fakes)


def _batch_lane_with_only_prefill_capacity_fails_typed(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    pool = _disagg_pool(s, fakes)
    fakes[1].shutdown()
    with pytest.raises(s.errors.EngineShutdown) as ei:
        pool.submit(list(range(8)), max_new_tokens=4,
                    priority=LANE_BATCH).result()
    pool.shutdown()
    return _record(pool, fakes, {"msg": str(ei.value)})


def _sticky_session_pinned_to_prefill_is_dropped_not_followed(s):
    fakes = [FakeEngine(s.errors, 0, outstanding=900),
             FakeEngine(s.errors, 1, outstanding=0)]
    pool = _disagg_pool(s, fakes)
    with pool._lock:
        pool._sticky["s"] = 0              # a stale entry on prefill
    pool.submit(list(range(8)), max_new_tokens=1, session_id="s").result()
    assert fakes[0].submits == []
    assert pool._sticky["s"] == 1
    assert pool.route_stats["sticky_hits"] == 0
    pool.shutdown()
    return _record(pool, fakes, {"sticky": dict(pool._sticky)})


def _role_pool_views_scale_apart_on_the_same_pool(s):
    fakes = [FakeEngine(s.errors, i) for i in range(4)]
    # the prefill side breaches its TTFT SLO; the decode side idles
    fakes[0].report_extra = {"ttft_ewma_s": 0.5, "total_slots": 4}
    fakes[1].report_extra = {"itl_ewma_s": 0.001, "total_slots": 4}
    pool = _disagg_pool(s, fakes, n=2)
    clock = [0.0]
    provider = s.scale.ImmediateCapacityProvider()
    sc_pre = s.scale.PoolAutoscaler(
        s.pool.RolePoolView(pool, ROLE_PREFILL),
        s.scale.SLOPolicy(min_replicas=1, max_replicas=2,
                          ttft_slo_s=0.001, cooldown_up_s=0.0),
        provider, time_fn=lambda: clock[0])
    sc_dec = s.scale.PoolAutoscaler(
        s.pool.RolePoolView(pool, ROLE_DECODE),
        s.scale.SLOPolicy(min_replicas=1, max_replicas=2,
                          itl_slo_s=60.0, idle_stable_s=3600.0),
        provider, time_fn=lambda: clock[0])
    decisions = []
    for _ in range(4):
        decisions.append((sc_pre.tick(), sc_dec.tick()))
        clock[0] += 1.0
        if pool.role_counts().get(ROLE_PREFILL, 0) > 1:
            break
    counts = pool.role_counts()
    assert counts[ROLE_PREFILL] == 2 and counts[ROLE_DECODE] == 1
    assert sc_pre.counts["scale_ups"] >= 1
    assert sc_dec.counts["scale_ups"] == 0
    ps = pool.pool_stats()
    assert [r["role"] for r in ps["replicas"]].count(ROLE_PREFILL) == 2
    assert set(ps["autoscale_by_role"]) == {ROLE_PREFILL, ROLE_DECODE}
    assert pool.capacity_hint_fn() == 0.0
    pool.shutdown()
    return _record(pool, fakes, {
        "decisions": decisions, "counts": counts,
        "timelines": [sc_pre.timeline, sc_dec.timeline]})


def _role_pool_view_rejects_unknown_role(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    pool = _disagg_pool(s, fakes)
    with pytest.raises(ValueError, match="unknown replica role") as ei:
        s.pool.RolePoolView(pool, "prefil")
    pool.shutdown()
    return _record(pool, fakes, {"msg": str(ei.value)})


def _last_prefill_death_degrades_to_unified(s):
    """The split is read per submit: with the prefill replica dead the
    pool serves one unified leg on the decode replica."""
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    fakes[1].script = [[6, 7, 8, 9]]
    pool = _disagg_pool(s, fakes)
    fakes[0]._stopped = True
    pool._note_replica_death(pool.replica(0))
    assert not pool.disaggregated()
    assert pool.submit(list(range(1, 33)), max_new_tokens=4).result() == \
        [6, 7, 8, 9]
    pool.shutdown()
    return _record(pool, fakes)


_FAKE_CASES = [
    _roles_must_name_every_replica,
    _unknown_role_rejected_at_construction,
    _disaggregated_pool_requires_share_prefixes,
    _pool_kv_pull_knobs_validated_at_construction,
    _two_leg_split_routes_prefill_then_decode_with_hint,
    _dead_decode_side_falls_back_to_decode_in_place,
    _single_token_requests_skip_the_handoff,
    _batch_lane_never_lands_on_prefill_replica,
    _batch_lane_with_only_prefill_capacity_fails_typed,
    _sticky_session_pinned_to_prefill_is_dropped_not_followed,
    _role_pool_views_scale_apart_on_the_same_pool,
    _role_pool_view_rejects_unknown_role,
    _last_prefill_death_degrades_to_unified,
]


@pytest.mark.parametrize("case", _FAKE_CASES,
                         ids=[c.__name__.lstrip("_") for c in _FAKE_CASES])
def test_fake_disagg_case(case):
    _both(case)


# ----------------------------------------------------- real engines


@pytest.fixture(scope="module")
def tiny():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8),
                                                           jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    tmodel = tl.build_model(tl.llama_tiny(dtype=torch.float32), sd, "cpu")

    def want(prompt, n):
        out = jl.generate(jmodel, params, jnp.asarray([prompt], jnp.int32),
                          max_new_tokens=n, temperature=0.0)
        return np.asarray(out)[0, len(prompt):].tolist()

    return types.SimpleNamespace(model=tmodel, sd=sd, params=params,
                                 want=want)


def _real_disagg_pool(tiny):
    def factory(idx):
        return teng.LLMEngine(tiny.model, max_slots=2, page_size=8,
                              n_pages=48, chunk=2, prefill_chunk=8,
                              temperature=0.0, eos_id=-1, seed=0,
                              prefix_cache=True, device="cpu")
    return tpool.EnginePool(factory, 2, share_prefixes=True,
                            roles=[ROLE_PREFILL, ROLE_DECODE], seed=0)


def _prompt(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(1, jl.llama_tiny().vocab_size - 1, size=24).tolist()


def test_disagg_handoff_is_token_identical(tiny):
    prompt = _prompt(0)
    pool = _real_disagg_pool(tiny)
    try:
        assert pool.submit(list(prompt), max_new_tokens=8).result() == \
            tiny.want(prompt, 8)
        ps = pool.pool_stats()
        assert ps["disagg_handoffs"] == 1
        assert ps.get("disagg_handoff_fallbacks", 0) == 0
        # the decode leg pulled the prompt's 3 full pages (Pg 8)
        decode = pool.replica(1).engine
        assert decode.role == ROLE_DECODE
        assert decode.kv_migration_stats["pulled_pages"] == 3
        assert decode.kv_migration_stats["fallbacks"] == 0
        assert [e[2] for e in pool.events.snapshot()] == [
            "route", "route", "handoff", "handoff_first_token"]
    finally:
        pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_disagg_decode_dead_recovers_token_identical(tiny):
    prompt = _prompt(1)
    pool = _real_disagg_pool(tiny)
    try:
        pool.engines()[1].shutdown()
        assert pool.submit(list(prompt), max_new_tokens=8).result() == \
            tiny.want(prompt, 8)
        assert pool.pool_stats()["disagg_handoff_fallbacks"] == 1
        # decoded in place: the donor's own cache held the pages
        donor = pool.replica(0).engine
        assert donor.stats["cache_hit_tokens"] >= 24
    finally:
        pool.shutdown()
    tfaults.check_pool_quiesced(pool)


# ------------------------------------------- deployment-level knobs


@pytest.mark.parametrize("bad", [
    dict(prefill_replicas=2),
    dict(disaggregate=True),
    dict(disaggregate=True, prefix_cache=True, prefill_replicas=2,
         decode_replicas=2, num_engine_replicas=3),
    dict(disaggregate=True, prefix_cache=True, decode_replicas=0),
    dict(kv_pull_deadline_s=0),
    dict(autoscale=True, num_engine_replicas=3, autoscale_max_replicas=2),
    dict(engine_stall_deadline_s=0.0),
], ids=["roles_need_disaggregate", "disaggregate_needs_prefix_cache",
        "replica_count_conflicts", "empty_side", "junk_pull_knob",
        "autoscale_max_below_floor", "stall_deadline_not_positive"])
def test_deployment_rejects_what_the_reference_rejects(tiny, bad):
    msgs = []
    with pytest.raises(ValueError) as ei:
        jllm.LlamaDeployment(params=object(), **bad)
    msgs.append(str(ei.value))
    with pytest.raises(ValueError) as ei:
        tllm.LlamaDeployment(tl.llama_tiny(dtype=torch.float32), tiny.sd,
                             device="cpu", **bad)
    msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_deployment_role_split_sets_pool_width(tiny):
    kw = dict(disaggregate=True, prefix_cache=True, prefill_replicas=1,
              decode_replicas=2)
    j = jllm.LlamaDeployment(params=object(), **kw)
    t = tllm.LlamaDeployment(tl.llama_tiny(dtype=torch.float32), tiny.sd,
                             device="cpu", page_size=8, max_slots=2,
                             max_new_tokens=6, **kw)
    assert (t.num_engine_replicas, t.prefill_replicas,
            t.decode_replicas) == (j.num_engine_replicas,
                                   j.prefill_replicas,
                                   j.decode_replicas) == (3, 1, 2)
    try:
        prompt = _prompt(2)
        assert t(prompt) == prompt + tiny.want(prompt, 6)
        pool = t.engine()
        assert pool.role_counts() == {ROLE_PREFILL: 1, ROLE_DECODE: 2}
        assert t.serve_stats()["engine"]["pool"]["disagg_handoffs"] == 1
        assert t.autoscaler() is None and t.watchdog() is None
    finally:
        t.shutdown()
    tfaults.check_pool_quiesced(t.engine())
