"""The port's engine pool (``ray_tpu_torch/serve/engine_pool.py``) against
the JAX package's, on the CPU.

- The scripted-fake cases of tests/test_engine_pool.py run through
  both packages' ``EnginePool`` with the same seed. Each side's fake
  engine raises its own package's typed errors (the pool tests
  ``isinstance`` against its package's ``serve/errors.py``). Each case
  returns a record — the route decisions, ``route_stats``,
  ``stats``, ``pool_stats()`` and the pool's event kinds — and the two
  records must be equal.
- The real-engine cases (``llama_tiny`` fp32, the flax params of
  PRNGKey(0)): two packages' pools of the same engines; every stream
  that completes equals JAX ``generate``, and the pools' outcomes
  agree where no thread race can change them.
- ``check_pool_quiesced`` after every real pool, and an autouse
  fixture holding every port engine built in a case to allocator
  occupancy == prefix-cache residency at teardown.
- From other reference files: the weight fence of ``_pull_hint``
  (tests/test_weight_rollout.py), a ``share_prefixes`` pull that lands
  the donor's bytes (tests/test_kv_migration.py), the deployment's pool
  knobs and ``serve_stats()`` against the JAX ``LlamaDeployment``, and
  the pool's ``spec_stats`` rates (a fault of the reference's).
"""
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import engine as jeng
from ray_tpu.serve import engine_pool as jpool
from ray_tpu.serve import errors as jerr
from ray_tpu.serve import faults as jfaults
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import prefix_cache as jpc
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.kv_cache import export_pages_bytes
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import engine_pool as tpool
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import faults as tfaults
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import prefix_cache as tpc

_SIDES = {
    "jax": types.SimpleNamespace(pool=jpool, errors=jerr,
                                 path_hashes=jpc.path_hashes),
    "torch": types.SimpleNamespace(pool=tpool, errors=terr,
                                   path_hashes=tpc.path_hashes),
}


@pytest.fixture(autouse=True)
def _no_page_leaks(monkeypatch):
    """Every port engine built in a case — the ones a pool killed or
    rebuilt too — ends with allocator occupancy == prefix-cache
    residency (tests/test_engine_pool.py's net)."""
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
        assert eng.alloc.occupancy() == cached, (
            f"engine leaked pages: occupancy {eng.alloc.occupancy()} != "
            f"prefix-cache residency {cached}")


# ------------------------------------------------------- fake engines


class FakeHandle:
    """Streams ``tokens``, then raises ``exc`` if set (marking the engine
    stopped first when ``die_on_failure``: a replica death)."""

    def __init__(self, engine, tokens, exc=None):
        self._engine = engine
        self._tokens = list(tokens)
        self._exc = exc
        self.cancelled = False

    def stream(self):
        yield from self._tokens
        if self._exc is not None:
            if self._engine.die_on_failure:
                self._engine._stopped = True
            raise self._exc

    def cancel(self):
        self.cancelled = True
        return True


class FakeEngine:
    """The surface the pool touches, scripted; raises ``errors``'
    types."""

    def __init__(self, errors, idx, *, outstanding=0, digest=frozenset(),
                 max_queued=None, queue_depth=0, retry_after=1.0,
                 page_size=16):
        self.errors = errors
        self.idx = idx
        self.Pg = page_size
        self._stopped = False
        self._draining = False
        self.die_on_failure = False
        self.outstanding = outstanding
        self.digest = digest
        self.max_queued = max_queued
        self.queue_depth = queue_depth
        self.retry_after = retry_after
        self.stats = {"submitted": 0}
        self.ttfts_s = []
        self.submits = []
        self.script = []
        self.started = False
        self.shutdowns = 0

    def start(self):
        self.started = True
        return self

    def submit(self, prompt, max_new_tokens=64, deadline_s=None):
        if self._stopped:
            raise self.errors.EngineShutdown("engine stopped")
        if self._draining:
            raise self.errors.EngineDraining("draining")
        self.submits.append((list(prompt), max_new_tokens, deadline_s))
        self.stats["submitted"] += 1
        out = self.script.pop(0) if self.script else [1, 2]
        if isinstance(out, BaseException):
            raise out
        if isinstance(out, FakeHandle):
            return out
        return FakeHandle(self, out)

    def shutdown(self):
        self.shutdowns += 1
        self._stopped = True

    def drain(self):
        self._draining = True

    def wait_idle(self, timeout_s=30.0):
        return True

    def is_idle(self):
        return True

    def load_report(self):
        return {"free_slots": 4, "free_pages": 100,
                "queue_depth": self.queue_depth,
                "outstanding_tokens": self.outstanding,
                "max_queued": self.max_queued,
                "shed_retry_after_s": self.retry_after,
                "draining": self._draining,
                "stopped": self._stopped,
                "prefix_digest": self.digest}

    def prefix_stats(self):
        return None

    def spec_stats(self):
        return None

    def lifecycle_stats(self):
        return {"max_queued": self.max_queued, "max_retries": 2,
                "retry_backoff_s": 0.02, "shed": 0}


def _record(pool, extra=None):
    """What the two pools must agree on."""
    rec = {"route_stats": dict(pool.route_stats),
           "stats": dict(pool.stats),
           "pool_stats": pool.pool_stats(),
           "events": [(e[2], e[4]) for e in pool.events.snapshot()]}
    if extra:
        rec.update(extra)
    return rec


def _both(case):
    rec = {pkg: case(side) for pkg, side in _SIDES.items()}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def _fake_pool(s, fakes, **kw):
    pool = s.pool.EnginePool(lambda i: fakes[i], len(fakes), **kw)
    assert all(f.started for f in fakes)
    return pool


def _rejects_zero_replicas(s):
    with pytest.raises(ValueError):
        s.pool.EnginePool(lambda i: FakeEngine(s.errors, i), 0)
    return {}


def _p2c_routes_least_outstanding(s):
    fakes = [FakeEngine(s.errors, 0, outstanding=500),
             FakeEngine(s.errors, 1, outstanding=5)]
    pool = _fake_pool(s, fakes)
    h = pool.submit([1, 2, 3])
    assert h.replica_idx == 1
    assert pool.route_stats["route_p2c"] == 1
    assert pool.route_stats["affinity_hits"] == 0
    pool.shutdown()
    return _record(pool)


def _affinity_routes_longest_cached_prefix(s):
    prompt = list(range(1, 65))
    hashes = s.path_hashes(prompt, 16)
    fakes = [FakeEngine(s.errors, 0, digest=frozenset(hashes[:1])),
             FakeEngine(s.errors, 1, outstanding=900,
                        digest=frozenset(hashes[:3]))]
    pool = _fake_pool(s, fakes)
    assert pool.submit(prompt).replica_idx == 1
    assert pool.route_stats["route_affinity"] == 1
    assert pool.route_stats["affinity_hit_pages"] == 3
    pool.shutdown()
    return _record(pool)


def _sticky_session_rehomes_after_death(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    pool = _fake_pool(s, fakes)
    first = pool.submit([1, 2], session_id="s").replica_idx
    assert pool.submit([3, 4], session_id="s").replica_idx == first
    assert pool.route_stats["sticky_hits"] >= 1
    fakes[first]._stopped = True
    pool._note_replica_death(pool.replica(first))
    assert pool.replica(first).state == s.pool.DEAD
    rehomed = pool.submit([5, 6], session_id="s").replica_idx
    assert rehomed == 1 - first
    pool.shutdown()
    return _record(pool, {"first": first})


def _spill_when_affinity_target_saturated(s):
    prompt = list(range(1, 33))
    fakes = [FakeEngine(s.errors, 0,
                        digest=frozenset(s.path_hashes(prompt, 16)),
                        max_queued=2, queue_depth=2),
             FakeEngine(s.errors, 1)]
    pool = _fake_pool(s, fakes)
    assert pool.submit(prompt).replica_idx == 1
    assert pool.route_stats["spills"] == 1
    assert pool.pool_stats()["spill_rate"] == 1.0
    pool.shutdown()
    return _record(pool)


def _all_shed_aggregates_max_retry_after(s):
    fakes = [FakeEngine(s.errors, 0, retry_after=2.0),
             FakeEngine(s.errors, 1, retry_after=5.0)]
    fakes[0].script.append(s.errors.EngineOverloaded(
        "full", retry_after_s=2.0))
    fakes[1].script.append(s.errors.EngineOverloaded(
        "full", retry_after_s=5.0))
    pool = _fake_pool(s, fakes)
    with pytest.raises(s.errors.EngineOverloaded) as ei:
        pool.submit([1, 2, 3])
    assert ei.value.retry_after_s == 5.0
    assert pool.route_stats["all_shed"] == 1
    pool.shutdown()
    return _record(pool, {"msg": str(ei.value)})


def _saturated_everywhere_sheds_with_report_hints(s):
    fakes = [FakeEngine(s.errors, 0, max_queued=1, queue_depth=1,
                        retry_after=0.5),
             FakeEngine(s.errors, 1, max_queued=1, queue_depth=3,
                        retry_after=4.0)]
    pool = _fake_pool(s, fakes)
    with pytest.raises(s.errors.EngineOverloaded) as ei:
        pool.submit([1])
    assert ei.value.retry_after_s == 4.0
    assert fakes[0].submits == [] and fakes[1].submits == []
    pool.shutdown()
    return _record(pool, {"msg": str(ei.value)})


def _no_healthy_replicas_is_typed_shutdown(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    pool = _fake_pool(s, fakes)
    for f in fakes:
        f._stopped = True
    with pytest.raises(s.errors.EngineShutdown) as ei:
        pool.submit([1, 2])
    pool.shutdown()
    return _record(pool, {"msg": str(ei.value)})


def _submit_routes_around_replica_that_died_racing(s):
    fakes = [FakeEngine(s.errors, 0, outstanding=0),
             FakeEngine(s.errors, 1, outstanding=10)]
    fakes[0].script.append(s.errors.EngineShutdown("died mid-submit"))
    orig_submit = FakeEngine.submit

    def dying_submit(self, prompt, **kw):
        if self.script and isinstance(self.script[0],
                                      s.errors.EngineShutdown):
            self._stopped = True
        return orig_submit(self, prompt, **kw)

    fakes[0].submit = dying_submit.__get__(fakes[0])
    pool = _fake_pool(s, fakes)
    assert pool.submit([1, 2]).replica_idx == 1
    assert pool.replica(0).state == s.pool.DEAD
    assert pool.route_stats["replica_deaths"] == 1
    pool.shutdown()
    return _record(pool)


def _unstreamed_death_resubmits_token_identically(s):
    fakes = [FakeEngine(s.errors, 0, outstanding=0),
             FakeEngine(s.errors, 1, outstanding=10)]
    fakes[0].die_on_failure = True
    fakes[0].script.append(FakeHandle(fakes[0], [],
                                      RuntimeError("device lost")))
    fakes[1].script.append([7, 8, 9])
    pool = _fake_pool(s, fakes)
    h = pool.submit([1, 2])
    assert h.replica_idx == 0
    assert h.result() == [7, 8, 9]
    assert h.replica_idx == 1
    assert pool.route_stats["requeues"] == 1
    assert h.ttft_s is not None and h.resubmits == 1
    pool.shutdown()
    return _record(pool)


def _partially_streamed_death_fails_typed(s):
    fakes = [FakeEngine(s.errors, 0, outstanding=0),
             FakeEngine(s.errors, 1, outstanding=10)]
    fakes[0].die_on_failure = True
    fakes[0].script.append(FakeHandle(fakes[0], [7, 8],
                                      RuntimeError("device lost")))
    pool = _fake_pool(s, fakes)
    h = pool.submit([1, 2])
    got = []
    with pytest.raises(s.errors.EngineShutdown,
                       match="cannot be replayed"):
        for t in h.stream():
            got.append(t)
    assert got == [7, 8]
    assert h.error is not None and h.done
    assert fakes[1].submits == []
    pool.shutdown()
    return _record(pool, {"error": str(h.error)})


def _request_level_failure_is_not_a_replica_death(s):
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1)]
    for f in fakes:
        f.script.append(FakeHandle(f, [],
                                   s.errors.DeadlineExceeded("too slow")))
    pool = _fake_pool(s, fakes)
    with pytest.raises(s.errors.DeadlineExceeded):
        pool.submit([1, 2]).result()
    assert pool.route_stats["replica_deaths"] == 0
    assert pool.replica(0).state == s.pool.HEALTHY
    pool.shutdown()
    return _record(pool)


def _resubmit_cap_fails_typed(s):
    fakes = [FakeEngine(s.errors, i) for i in range(3)]
    for f in fakes:
        f.die_on_failure = True
        f.script.append(FakeHandle(f, [], RuntimeError("boom")))
    pool = _fake_pool(s, fakes, max_resubmits=1)
    h = pool.submit([1, 2])
    with pytest.raises(s.errors.EngineShutdown):
        h.result()
    assert pool.route_stats["requeues"] == 1
    pool.shutdown()
    return _record(pool, {"error": str(h.error)})


def _deadline_shrinks_across_resubmit(s):
    fakes = [FakeEngine(s.errors, 0, outstanding=0),
             FakeEngine(s.errors, 1, outstanding=10)]
    fakes[0].die_on_failure = True
    fakes[0].script.append(FakeHandle(fakes[0], [], RuntimeError("boom")))
    fakes[1].script.append([5])
    pool = _fake_pool(s, fakes)
    assert pool.submit([1, 2], deadline_s=30.0).result() == [5]
    assert fakes[0].submits[0][2] == 30.0
    remaining = fakes[1].submits[0][2]
    assert remaining is not None and 0 < remaining < 30.0
    pool.shutdown()
    return _record(pool)


def _drain_rebuilds_replica_with_new_generation(s):
    pool = s.pool.EnginePool(lambda i: FakeEngine(s.errors, i), 2)
    old = pool.replica(0).engine
    assert pool.drain(0) is True
    rep = pool.replica(0)
    assert rep.state == s.pool.HEALTHY and rep.generation == 1
    assert rep.engine is not old
    assert old._draining and old.shutdowns >= 1
    pool.replica(1).state = s.pool.DRAINING
    with pytest.raises(RuntimeError):
        pool.drain(1)
    pool.replica(1).state = s.pool.HEALTHY
    pool.shutdown()
    return _record(pool)


def _restart_dead_rebuilds_only_dead_replicas(s):
    fakes = {0: FakeEngine(s.errors, 0), 1: FakeEngine(s.errors, 1)}

    def factory(i):
        fakes[i] = FakeEngine(s.errors, i)
        return fakes[i]

    pool = s.pool.EnginePool(lambda i: fakes[i], 2)
    fakes[0]._stopped = True
    pool._note_replica_death(pool.replica(0))
    pool._factory = factory
    assert pool.restart_dead() == 1
    assert pool.replica(0).generation == 1
    assert pool.replica(1).generation == 0
    assert pool.healthy_count() == 2
    pool.shutdown()
    return _record(pool)


def _pool_shutdown_is_typed_and_idempotent(s):
    pool = _fake_pool(s, [FakeEngine(s.errors, 0),
                          FakeEngine(s.errors, 1)])
    pool.shutdown()
    pool.shutdown()
    assert all(pool.replica(i).state == s.pool.DEAD for i in (0, 1))
    with pytest.raises(s.errors.EngineShutdown):
        pool.submit([1])
    return _record(pool)


def _pool_load_report_aggregates_and_maxes_hint(s):
    fakes = [FakeEngine(s.errors, 0, outstanding=10, queue_depth=1,
                        retry_after=0.5),
             FakeEngine(s.errors, 1, outstanding=30, queue_depth=2,
                        retry_after=3.5)]
    pool = _fake_pool(s, fakes)
    rpt = pool.load_report()
    assert rpt["free_slots"] == 8 and rpt["queue_depth"] == 3
    assert rpt["outstanding_tokens"] == 40
    assert rpt["shed_retry_after_s"] == 3.5
    assert rpt["healthy_replicas"] == 2 and rpt["stopped"] is False
    pool.shutdown()
    after = pool.load_report()
    assert after["stopped"] is True
    # the JAX pool also stamps "tp" (tensor parallelism: ROADMAP item 8)
    rpt.pop("tp", None)
    after.pop("tp", None)
    return _record(pool, {"report": rpt, "after": after})


def _pool_stats_rates_and_replica_rows(s):
    pool = _fake_pool(s, [FakeEngine(s.errors, 0),
                          FakeEngine(s.errors, 1)])
    for _ in range(4):
        pool.submit([1, 2]).result()
    ps = pool.pool_stats()
    assert ps["routed"] == 4 and ps["affinity_hit_rate"] == 0.0
    assert [r["idx"] for r in ps["replicas"]] == [0, 1]
    assert pool.stats["submitted"] == 4
    pool.shutdown()
    return _record(pool, {"lifecycle": pool.lifecycle_stats(),
                          "ttfts": pool.ttfts_s})


def _wait_for(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


def _auto_restart_backoff_doubles_and_caps(s):
    backoffs = []
    orig = s.pool.EnginePool._backoff_rebuild

    class Spied(s.pool.EnginePool):
        def _backoff_rebuild(self, rep, backoff_s):
            backoffs.append(backoff_s)
            orig(self, rep, 0.0)      # skip the real sleep

    pool = Spied(lambda i: FakeEngine(s.errors, i), 2, auto_restart=True,
                 restart_backoff_s=0.1, restart_backoff_max_s=0.4,
                 max_restarts=None)
    for _ in range(4):
        rep = pool.replica(0)
        rep.engine._stopped = True
        pool._note_replica_death(rep)
        assert _wait_for(lambda: pool.replica(0).state
                         == s.pool.HEALTHY)
    assert backoffs == pytest.approx([0.1, 0.2, 0.4, 0.4])
    assert pool.replica(0).deaths == 4
    pool.shutdown()
    return _record(pool, {"backoffs": backoffs})


def _crash_loop_cap_parks_replica_degraded(s):
    pool = s.pool.EnginePool(lambda i: FakeEngine(s.errors, i), 1,
                             auto_restart=True, restart_backoff_s=0.0,
                             max_restarts=1)
    rep = pool.replica(0)
    rep.engine._stopped = True
    pool._note_replica_death(rep)
    assert _wait_for(lambda: pool.replica(0).state == s.pool.HEALTHY)
    rep = pool.replica(0)
    rep.engine._stopped = True
    pool._note_replica_death(rep)
    assert pool.replica(0).state == s.pool.DEGRADED and pool.degraded
    assert pool.route_stats["crash_loops"] == 1
    with pytest.raises(s.errors.PoolDegraded) as ei:
        pool.submit([1, 2])
    assert s.errors.classify_http_status(ei.value) == 503
    assert isinstance(ei.value, s.errors.EngineShutdown)
    assert pool.restart_dead() == 1
    assert pool.submit([1, 2]).result() == [1, 2]
    pool.shutdown()
    return _record(pool, {"msg": str(ei.value)})


def _backoff_rebuild_aborts_when_world_moved(s):
    pool = s.pool.EnginePool(lambda i: FakeEngine(s.errors, i), 1,
                             auto_restart=True, restart_backoff_s=0.2,
                             max_restarts=None)
    rep = pool.replica(0)
    rep.engine._stopped = True
    pool._note_replica_death(rep)
    pool.shutdown()
    time.sleep(0.4)
    assert pool.replica(0).state == s.pool.DEAD
    assert pool.route_stats["restarts"] == 0
    return _record(pool)


def _resubmit_after_death_skips_draining_replica(s):
    fakes = [FakeEngine(s.errors, 0, outstanding=0),
             FakeEngine(s.errors, 1, outstanding=50),
             FakeEngine(s.errors, 2, outstanding=5)]
    fakes[0].die_on_failure = True
    fakes[0].script.append(FakeHandle(fakes[0], [],
                                      RuntimeError("device lost")))
    fakes[1].script.append([7, 8])
    pool = _fake_pool(s, fakes)
    pool.replica(2).state = s.pool.DRAINING
    fakes[2]._draining = True
    h = pool.submit([1, 2])
    assert h.replica_idx == 0
    assert h.result() == [7, 8] and h.replica_idx == 1
    assert fakes[2].submits == []
    pool.replica(2).state = s.pool.HEALTHY
    pool.shutdown()
    return _record(pool)


def _idle_replica_death_detected_at_route_time(s):
    built = []

    def factory(i):
        built.append(FakeEngine(s.errors, i))
        return built[-1]

    pool = s.pool.EnginePool(factory, 2, auto_restart=True,
                             restart_backoff_s=0.0)
    built[0]._stopped = True
    assert pool.submit([1, 2, 3]).replica_idx == 1
    assert pool.route_stats["replica_deaths"] == 1
    assert _wait_for(lambda: pool.replica(0).generation == 1)
    assert pool.replica(0).state == s.pool.HEALTHY and len(built) == 3
    pool.shutdown()
    return _record(pool)


def _scale_down_drain_vs_kill_vs_resubmit_three_way(s):
    gate = threading.Event()
    fakes = [FakeEngine(s.errors, 0, outstanding=5),
             FakeEngine(s.errors, 1, outstanding=50),
             FakeEngine(s.errors, 2, outstanding=0)]
    fakes[2].wait_idle = lambda timeout_s=30.0: (gate.wait(timeout_s),
                                                 True)[1]
    fakes[0].die_on_failure = True
    fakes[0].script.append(FakeHandle(fakes[0], [],
                                      RuntimeError("device lost")))
    fakes[1].script.append([7, 8])
    pool = _fake_pool(s, fakes)
    retired = []
    scaler = threading.Thread(target=lambda: retired.extend(
        pool.scale_down(1, timeout_s=10.0)))
    scaler.start()
    assert _wait_for(lambda: pool.replica(2).state == s.pool.DRAINING)
    h = pool.submit([1, 2])
    assert h.replica_idx == 0
    assert h.result() == [7, 8] and h.replica_idx == 1
    fakes[2]._stopped = True
    pool._note_replica_death(pool.replica(2))
    gate.set()
    scaler.join(timeout=10.0)
    assert not scaler.is_alive() and retired == [2]
    assert fakes[2].submits == []
    assert pool.route_stats["replica_deaths"] == 2
    assert pool.route_stats["replicas_retired"] == 1
    assert pool.replica(2).state == s.pool.RETIRED
    pool.shutdown()
    return _record(pool)


def _direct_submit_to_named_replica(s):
    """``_submit_once(target_idx=)``, the disaggregated handoff's
    decode-in-place rung: no routing policy, no sticky write, a shed
    from the named replica raised as is, an unhealthy one refused."""
    fakes = [FakeEngine(s.errors, 0), FakeEngine(s.errors, 1,
                                                 outstanding=900)]
    pool = _fake_pool(s, fakes)
    rep, _inner = pool._submit_once([1, 2], 4, None, "s",
                                    target_idx=1, record_sticky=False)
    assert rep.idx == 1 and pool._sticky == {}
    fakes[1].script.append(s.errors.EngineOverloaded(
        "full", retry_after_s=3.0))
    with pytest.raises(s.errors.EngineOverloaded):
        pool._submit_once([1, 2], 4, None, None, target_idx=1)
    pool.replica(0).state = s.pool.DRAINING
    with pytest.raises(s.errors.EngineShutdown):
        pool._submit_once([1, 2], 4, None, None, target_idx=0)
    pool.replica(0).state = s.pool.HEALTHY
    pool.shutdown()
    return _record(pool)


_FAKE_CASES = [
    _direct_submit_to_named_replica,
    _rejects_zero_replicas, _p2c_routes_least_outstanding,
    _affinity_routes_longest_cached_prefix,
    _sticky_session_rehomes_after_death,
    _spill_when_affinity_target_saturated,
    _all_shed_aggregates_max_retry_after,
    _saturated_everywhere_sheds_with_report_hints,
    _no_healthy_replicas_is_typed_shutdown,
    _submit_routes_around_replica_that_died_racing,
    _unstreamed_death_resubmits_token_identically,
    _partially_streamed_death_fails_typed,
    _request_level_failure_is_not_a_replica_death,
    _resubmit_cap_fails_typed, _deadline_shrinks_across_resubmit,
    _drain_rebuilds_replica_with_new_generation,
    _restart_dead_rebuilds_only_dead_replicas,
    _pool_shutdown_is_typed_and_idempotent,
    _pool_load_report_aggregates_and_maxes_hint,
    _pool_stats_rates_and_replica_rows,
    _auto_restart_backoff_doubles_and_caps,
    _crash_loop_cap_parks_replica_degraded,
    _backoff_rebuild_aborts_when_world_moved,
    _resubmit_after_death_skips_draining_replica,
    _idle_replica_death_detected_at_route_time,
    _scale_down_drain_vs_kill_vs_resubmit_three_way,
]


@pytest.mark.parametrize("case", _FAKE_CASES,
                         ids=[c.__name__.lstrip("_") for c in _FAKE_CASES])
def test_fake_pool_case(case):
    _both(case)


def test_p2c_seeded_routes_equal():
    """Many P2C routes over equal-load replicas: the same seed gives
    the same picks in both pools."""
    def case(s):
        pool = _fake_pool(s, [FakeEngine(s.errors, i) for i in range(4)],
                          seed=7)
        picks = [pool.submit([i]).replica_idx for i in range(32)]
        pool.shutdown()
        return _record(pool, {"picks": picks})

    assert len(set(_both(case)["picks"])) > 1


def test_concurrent_routes_count_routes_in_flight():
    """Four submits route while every replica's submit is held: the
    port's pool counts the routes in flight as outstanding work and
    spreads them 2 / 2; the reports alone (all equal, as the JAX pool
    reads them) would send all four to replica 0."""
    gate = threading.Event()
    entered = threading.Semaphore(0)

    class Held(FakeEngine):
        def submit(self, prompt, **kw):
            entered.release()
            gate.wait(10)
            return super().submit(prompt, **kw)

    pool = tpool.EnginePool(lambda i: Held(terr, i), 2)
    hs = []
    threads = [threading.Thread(target=lambda: hs.append(
        pool.submit([1, 2, 3], max_new_tokens=4))) for _ in range(4)]
    for t in threads:
        t.start()
        assert entered.acquire(timeout=10)     # routed, submit held
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert sorted(h.replica_idx for h in hs) == [0, 0, 1, 1]
    assert pool._routing == {0: 0, 1: 0}
    pool.shutdown()


def test_roles_other_than_unified_are_refused():
    """Prefill and decode roles construct (the disaggregated pool), a
    decode replica joins by ``add_replica(role=)``, and an unknown role
    is refused there: the same records as the JAX pool."""
    def case(s):
        pool = s.pool.EnginePool(lambda i: FakeEngine(s.errors, i), 2,
                                 roles=["prefill", "decode"],
                                 share_prefixes=True)
        assert pool.disaggregated()
        assert pool.add_replica(role="decode") == 2
        with pytest.raises(ValueError, match="unknown replica role"):
            pool.add_replica(role="router")
        counts = pool.role_counts()
        report = pool.load_report("decode")
        report.pop("tp", None)      # the JAX pool's tensor parallelism
        pool.shutdown()
        return _record(pool, {"roles": counts, "report": report})

    rec = _both(case)
    assert rec["roles"] == {"prefill": 1, "decode": 2}
    assert [r["role"] for r in rec["pool_stats"]["replicas"]] == [
        "prefill", "decode", "decode"]


# ----------------------------------------------------- real engines

_REF_TOKENS = 40


@pytest.fixture(scope="module")
def tiny():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8),
                                                           jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    tmodel = tl.build_model(tl.llama_tiny(dtype=torch.float32), sd, "cpu")
    cache = {}

    def want(prompt, n):
        key = tuple(prompt)
        if key not in cache:
            out = jl.generate(jmodel, params,
                              jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=_REF_TOKENS, temperature=0.0)
            cache[key] = np.asarray(out)[0, len(prompt):].tolist()
        return cache[key][:n]

    def engine(pkg, **kw):
        if pkg == "jax":
            if "fault_injector" in kw and kw["fault_injector"] is not None:
                kw["fault_injector"] = kw["fault_injector"]["jax"]
            return jeng.LLMEngine(jmodel, params, **kw)
        if "fault_injector" in kw and kw["fault_injector"] is not None:
            kw["fault_injector"] = kw["fault_injector"]["torch"]
        return teng.LLMEngine(tmodel, device="cpu", **kw)

    return types.SimpleNamespace(engine=engine, want=want, sd=sd,
                                 jmodel=jmodel, params=params,
                                 tmodel=tmodel)


def _pools(tiny, n, mk_kw, **pool_kw):
    """The JAX pool and the port pool of ``n`` engines each."""
    return {pkg: _SIDES[pkg].pool.EnginePool(
        lambda i, pkg=pkg: tiny.engine(pkg, **mk_kw(i)), n, **pool_kw)
        for pkg in ("jax", "torch")}


def test_pool_parity_and_affinity_compounding(tiny):
    """Two replicas, shared-prefix prompts, two waves: every stream
    equals generate; the second wave routes by affinity, the same
    replicas in both pools."""
    pools = _pools(tiny, 2, lambda i: dict(
        max_slots=2, page_size=8, n_pages=64, chunk=4, seed=i,
        prefix_cache=True))
    shared = [3, 1, 4, 1, 5, 9, 2, 6]
    prompts = [shared + [10 + i, 20 + i, 30 + i] for i in range(4)]
    rec = {}
    for pkg, pool in pools.items():
        routes = []
        for _wave in range(2):
            hs = [pool.submit(p, max_new_tokens=10) for p in prompts]
            for p, h in zip(prompts, hs):
                assert h.result() == tiny.want(p, 10)
            routes.append([h.replica_idx for h in hs])
        ps = pool.pool_stats()
        assert pool.route_stats["affinity_hits"] > 0
        rec[pkg] = {"wave2": routes[1],
                    "affinity_hits": ps["affinity_hits"]}
        pool.shutdown()
        (jfaults if pkg == "jax" else tfaults).check_pool_quiesced(pool)
    assert rec["torch"]["affinity_hits"] == rec["jax"]["affinity_hits"]


def _kill_pool(tiny, pkg, n, n_prompts, new, seed, replicas, slots=2):
    faults = jfaults if pkg == "jax" else tfaults
    inj = faults.FaultInjector()
    inj.kill_replica(round=6)

    def factory(idx):
        return tiny.engine(pkg, max_slots=slots, page_size=16, n_pages=64,
                           chunk=2, prefill_chunk=16, temperature=0.0,
                           eos_id=-1, seed=idx,
                           fault_injector=({pkg: inj} if idx == 0
                                           else None))

    pool = _SIDES[pkg].pool.EnginePool(factory, replicas)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, n, size=10).tolist()
               for _ in range(n_prompts)]
    return pool, prompts, faults


def test_replica_kill_recovers_unstreamed_requests(tiny):
    """Replica 0 is killed mid-run: every request completes equal to
    generate (resubmitted to the survivor if it had not streamed) or
    fails typed EngineShutdown; nothing hangs or is lost."""
    for pkg in ("jax", "torch"):
        pool, prompts, faults = _kill_pool(tiny, pkg, 50, 6, 16, 11, 2)
        errors = _SIDES[pkg].errors
        results = [None] * len(prompts)

        def consume(i, h):
            try:
                results[i] = ("ok", h.result())
            except errors.EngineShutdown:
                results[i] = ("typed", None)

        handles = [pool.submit(p, max_new_tokens=16) for p in prompts]
        threads = [threading.Thread(target=consume, args=(i, h))
                   for i, h in enumerate(handles)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(not t.is_alive() for t in threads), pkg
        assert all(r is not None for r in results), pkg
        ok = [i for i, r in enumerate(results) if r[0] == "ok"]
        for i in ok:
            assert results[i][1] == tiny.want(prompts[i], 16), (pkg, i)
        assert pool.route_stats["replica_deaths"] == 1
        assert pool.replica(0).state == _SIDES[pkg].pool.DEAD
        assert pool.route_stats["requeues"] + (len(results)
                                               - len(ok)) > 0
        pool.shutdown()
        faults.check_pool_quiesced(pool)


def test_mid_stream_kill_fails_typed_after_tokens(tiny):
    """A request that streamed before its replica died fails typed
    EngineShutdown; its tokens so far are generate's; the same count
    streamed in both pools (the rounds are deterministic)."""
    got = {}
    for pkg in ("jax", "torch"):
        faults = jfaults if pkg == "jax" else tfaults
        inj = faults.FaultInjector()
        inj.kill_replica(round=6)
        pool = _SIDES[pkg].pool.EnginePool(
            lambda i, pkg=pkg, inj=inj: tiny.engine(
                pkg, max_slots=1, page_size=16, n_pages=32, chunk=2,
                prefill_chunk=16, temperature=0.0, eos_id=-1, seed=i,
                overlap=False, fault_injector={pkg: inj}), 1)
        h = pool.submit([5, 9, 2, 7], max_new_tokens=32)
        toks = []
        with pytest.raises(_SIDES[pkg].errors.EngineShutdown):
            for t in h.stream():
                toks.append(t)
        assert toks and toks == tiny.want([5, 9, 2, 7], len(toks))
        got[pkg] = (len(toks) > 0, type(h.error).__name__)
        pool.shutdown()
        faults.check_pool_quiesced(pool)
    assert got["torch"] == got["jax"]


def test_drain_completes_inflight_and_rebuilds(tiny):
    pool = tpool.EnginePool(
        lambda i: tiny.engine("torch", max_slots=2, page_size=8,
                              n_pages=32, chunk=4, seed=i), 2)
    prompt = [5, 9, 2, 7, 11]
    h = pool.submit(prompt, max_new_tokens=8)
    idx = h.replica_idx
    assert pool.drain(idx) is True
    assert h.result() == tiny.want(prompt, 8)
    rep = pool.replica(idx)
    assert rep.state == tpool.HEALTHY and rep.generation == 1
    assert pool.submit(prompt, max_new_tokens=8).result() == \
        tiny.want(prompt, 8)
    kinds = [e[2] for e in pool.events.snapshot()]
    assert kinds == ["route", "drain", "restart", "route"]
    pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_draining_engine_rejects_direct_submits(tiny):
    eng = tiny.engine("torch", max_slots=2, page_size=8, n_pages=32,
                      chunk=4).start()
    eng.drain()
    assert eng.load_report()["draining"] is True
    with pytest.raises(terr.EngineDraining):
        eng.submit([1, 2, 3], max_new_tokens=4)
    assert eng.wait_idle(5.0) is True
    eng.shutdown()
    tfaults.check_quiesced(eng)


def test_engine_load_report_shape(tiny):
    eng = tiny.engine("torch", max_slots=2, page_size=8, n_pages=32,
                      chunk=4, prefix_cache=True).start()
    prompt = [(i % 50) + 1 for i in range(16)]
    eng.submit(prompt, max_new_tokens=6).result()
    rpt = eng.load_report()
    for key in ("free_slots", "free_pages", "queue_depth",
                "outstanding_tokens", "max_queued",
                "shed_retry_after_s", "draining", "stopped",
                "prefix_digest"):
        assert key in rpt, key
    assert _wait_for(lambda: bool(eng.load_report()["prefix_digest"]))
    assert tpc.path_hashes(prompt, eng.Pg)[0] in \
        eng.load_report()["prefix_digest"]
    eng.shutdown()
    tfaults.check_quiesced(eng, expect_cached_pages=eng.prefix_cache
                           .cached_pages)


def test_cancel_through_pool_handle(tiny):
    pool = tpool.EnginePool(
        lambda i: tiny.engine("torch", max_slots=1, page_size=8,
                              n_pages=32, chunk=2, eos_id=-1, seed=i), 1)
    h = pool.submit([5, 9, 2, 7], max_new_tokens=64)
    assert h.cancel() is True
    with pytest.raises(terr.RequestCancelled):
        h.result()
    pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_drain_racing_replica_death_quiesces_leak_free(tiny):
    """Replica 1 drains while replica 0 dies mid-decode: every request
    completes equal to generate or fails typed; none is lost; every
    engine quiesces."""
    for pkg in ("jax", "torch"):
        # ids below the vocabulary (256): the reference case's ids up to
        # 1000 are clamped by the JAX gather, and refused by the port
        pool, prompts, faults = _kill_pool(tiny, pkg, 256, 8, 20, 23, 3)
        handles = [pool.submit(p, max_new_tokens=20) for p in prompts]
        drainer = threading.Thread(target=lambda: pool.drain(1))
        drainer.start()
        completed = typed = 0
        for h, p in zip(handles, prompts):
            try:
                assert h.result() == tiny.want(p, 20)
                completed += 1
            except _SIDES[pkg].errors.EngineShutdown:
                typed += 1
        drainer.join(timeout=60)
        assert not drainer.is_alive()
        assert completed + typed == len(handles) and completed >= 1
        assert pool.route_stats["replica_deaths"] >= 1
        assert pool.route_stats["drains"] == 1
        pool.shutdown()
        faults.check_pool_quiesced(pool)


def test_fail_all_stops_before_releasing_consumers(tiny):
    """A replica's ``_fail_all`` marks the engine stopped before it
    releases any consumer, so the pool, judging the death by
    ``_stopped`` as the consumer sees the error, never takes it for a
    request failure (the reference sets ``_stopped`` last: under load
    its pool then re-raises the raw error and the request is lost)."""
    eng = tiny.engine("torch", max_slots=1, page_size=8, n_pages=32,
                      chunk=2, eos_id=-1)
    seen = []
    hs = [eng.submit([5, 9, 2, 7], max_new_tokens=8),
          eng.submit([4, 4, 2], max_new_tokens=8)]
    eng.step()                            # one slotted, one queued
    for h in hs:
        q = h._req.out_q
        put = q.put
        q.put = lambda item, put=put: (seen.append(eng._stopped),
                                       put(item))[1]
    eng._fail_all(tfaults.ReplicaKilled("injected replica death"))
    assert seen and all(seen), seen
    for h in hs:
        with pytest.raises(tfaults.ReplicaKilled):
            h.result()
    tfaults.check_quiesced(eng)


# ----------------------------------------- from other reference files


def test_pull_hint_respects_weight_fence(tiny):
    """tests/test_weight_rollout.py: a sibling serving another payload
    is never named as a pull donor."""
    pool = tpool.EnginePool(
        lambda i: tiny.engine("torch", max_slots=2, page_size=8,
                              n_pages=64, chunk=4, prefix_cache=True,
                              seed=i), 2, share_prefixes=True)
    try:
        prompt = [9, 8, 7, 6, 5, 4, 3, 2] * 4
        pool.replica(1).engine.submit(list(prompt),
                                      max_new_tokens=2).result()
        assert _wait_for(lambda: bool(
            pool.replica(1).engine.load_report()["prefix_digest"]))
        reports = {i: pool.replica(i).engine.load_report() for i in (0, 1)}
        chain = tpc.path_hashes(prompt, pool.replica(0).engine.Pg)
        assert any(h in reports[1]["prefix_digest"] for h in chain)
        assert pool._pull_hint(list(prompt), pool.replica(0),
                               reports) is not None
        pool.swap_replica_weights(1, tiny.sd, weights_id="other")
        pool.replica(1).engine.submit(list(prompt),
                                      max_new_tokens=2).result()
        assert _wait_for(lambda: bool(
            pool.replica(1).engine.load_report()["prefix_digest"]))
        reports = {i: pool.replica(i).engine.load_report() for i in (0, 1)}
        assert pool._pull_hint(list(prompt), pool.replica(0),
                               reports) is None
        assert [e[2] for e in pool.events.snapshot()] == ["weight_swap"]
    finally:
        pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_pool_share_prefixes_pulls_donor_bytes(tiny):
    """tests/test_kv_migration.py: the pool names the warm sibling as
    donor, the cold replica pulls instead of recomputing — the stream
    equals generate, the landed pages hold the donor's bytes."""
    prefix = list(range(1, 33))                 # 4 pages of 8
    prompt = prefix + [11, 22, 33, 44]
    pool = tpool.EnginePool(
        lambda i: tiny.engine("torch", max_slots=2, page_size=8,
                              n_pages=64, chunk=4, prefix_cache=True,
                              seed=i), 2, share_prefixes=True, seed=0)
    try:
        hw = pool.submit(prefix + [7, 7, 7, 7], max_new_tokens=2,
                         session_id="w")
        hw.result()
        warm, cold = hw.replica_idx, 1 - hw.replica_idx
        assert _wait_for(lambda: bool(
            pool.replica(warm).engine.load_report()["prefix_digest"]))
        # land the measured session on the cold replica
        with pool._lock:
            pool._sticky["m"] = cold
        hm = pool.submit(prompt, max_new_tokens=6, session_id="m")
        assert hm.replica_idx == cold
        assert hm.result() == tiny.want(prompt, 6)
        st = pool.kv_migration_stats()
        assert st["pulls"] >= 1 and st["pulled_pages"] == 4
        assert st["fallbacks"] == 0
        assert pool.pool_stats()["pull_hints"] >= 1
        hashes = tpc.path_hashes(prefix, 8)
        donor, req = (pool.replica(warm).engine,
                      pool.replica(cold).engine)
        pages = {}
        for name, eng in (("donor", donor), ("req", req)):
            pinned = eng.kv_pin_prefix(hashes)
            assert len(pinned) == 4
            pages[name] = export_pages_bytes(eng.pages, pinned)
            eng.kv_release_pages(pinned)
        assert pages["req"] == pages["donor"]
    finally:
        pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_pool_spec_stats_rates(tiny):
    """The pool's ``spec_stats`` rates from the summed counters (the
    reference's pool reads keys its engines do not report, and gives
    0.0 for both)."""
    pool = tpool.EnginePool(
        lambda i: tiny.engine("torch", max_slots=2, page_size=8,
                              n_pages=64, chunk=4, spec_len=4,
                              spec_ngram=2, seed=i), 2)
    rep = [3, 1, 4, 1, 5, 9, 2, 6] * 3
    for p in (rep, rep[2:], rep[4:]):
        assert pool.submit(p, max_new_tokens=20).result() == \
            tiny.want(p, 20)
    st = pool.spec_stats()
    per = [r.engine.spec_stats() for r in pool._replicas]
    proposed = sum(d["proposed_tokens"] for d in per)
    accepted = sum(d["accepted_tokens"] for d in per)
    assert proposed and st["proposed_tokens"] == proposed
    assert st["accept_rate"] == round(accepted / proposed, 4) > 0
    s = pool.stats
    assert st["tokens_per_dispatch"] == round(
        s["spec_tokens"] / s["spec_riders"], 4) > 1.0
    assert st["spec_len"] == 4 and st["spec_ngram"] == 2
    pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_deployment_pool_knobs_and_serve_stats(tiny):
    """``LlamaDeployment(num_engine_replicas=2)`` against the JAX one:
    the same knob validation, the same routes for sequential session
    requests, equal streams, and equal ``serve_stats()`` pool blocks."""
    jcfg, tcfg = (jl.llama_tiny(dtype=jnp.float32),
                  tl.llama_tiny(dtype=torch.float32))
    for bad in (dict(num_engine_replicas=0),
                dict(kv_pull_deadline_s=-1.0),
                dict(kv_pull_backoff_s="x")):
        with pytest.raises(ValueError):
            jllm.LlamaDeployment(jcfg, tiny.params, **bad)
        with pytest.raises(ValueError):
            tllm.LlamaDeployment(tcfg, tiny.sd, device="cpu", **bad)
    kw = dict(num_engine_replicas=2, max_slots=2, page_size=8,
              max_new_tokens=6, prefix_cache=True, overlap=False,
              kv_pull_deadline_s=2.0, kv_pull_backoff_s=0.01)
    deps = {"jax": jllm.LlamaDeployment(jcfg, tiny.params, **kw),
            "torch": tllm.LlamaDeployment(tcfg, tiny.sd, device="cpu",
                                          **kw)}
    shared = list(range(1, 17))
    reqs = [{"prompt_ids": shared + [20 + i], "session_id": f"s{i % 2}"}
            for i in range(4)]
    rec = {}
    for pkg, dep in deps.items():
        try:
            outs = [dep(r) for r in reqs]
            for r, o in zip(reqs, outs):
                assert o == r["prompt_ids"] + tiny.want(r["prompt_ids"], 6)
            pool = dep.engine()
            assert pool.n_replicas == 2
            st = dep.serve_stats()["engine"]
            ps = st.pop("pool")
            rpt = dep.load_report()
            rpt.pop("tp", None)
            rec[pkg] = {
                "routes": [e[4] for e in pool.events.snapshot()
                           if e[2] == "route"],
                "stats": {k: st[k] for k in (
                    "submitted", "admitted", "completed", "slots_total",
                    "pages_total", "pages_free", "max_queued",
                    "max_retries", "retry_backoff_s", "consistent",
                    "cache_hit_tokens")},
                "pool": {k: ps[k] for k in (
                    "routed", "affinity_hits", "sticky_hits",
                    "n_replicas", "replicas")},
                "report_keys": sorted(rpt)}
        finally:
            dep.engine().shutdown()
    assert rec["torch"] == rec["jax"]
