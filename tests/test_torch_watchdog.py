"""The port's pool watchdog (``ray_tpu_torch/serve/watchdog.py``) and the
pool's suspect and wedged marks against the JAX package's, on the CPU.

- The heartbeat-fake cases of tests/test_serve_watchdog.py (the
  suspect -> wedged ladder, the bundle before the kill, recovery on
  progress or drained work, a slow but moving readback, idle silence,
  capacity exclusion, engines without the heartbeat, the stats block,
  knob validation) run through both packages' ``EnginePool`` and
  ``PoolWatchdog`` on one fake clock. Each case returns a record — the
  replica states after each tick, the watchdog's counts, log and
  ``stats()``, the pool's ``route_stats`` and events, the kill's error
  — and the two records must be equal.
- ``AgentWatchdog`` against the JAX one on a fake engine and a fake
  clock: the same escalations, callbacks and ``stats()``.
- On port engines (``llama_tiny`` fp32, the flax params of
  PRNGKey(0)): a ``hang`` at replica 0's step is wedged within the
  stall deadline, its unstreamed requests complete on replica 1 equal
  to JAX ``generate``, the bundle names it, and the released zombie is
  fenced (no token committed, the prefix cache untouched).
- chip_smoke phase 3's disaggregated and watchdog cases, rehearsed with
  the CPU standing in for the card.

The reference file's chaos campaign (``tools/chaos_serve.py``) waits
for the port's ``serve/chaos.py`` (ROADMAP.md, queue 1, item 9).
"""
import importlib.util
import os
import pathlib
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import engine_pool as jpool
from ray_tpu.serve import errors as jerr
from ray_tpu.serve import obs as jobs
from ray_tpu.serve import watchdog as jwd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import engine_pool as tpool
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import faults as tfaults
from ray_tpu_torch.serve import obs as tobs
from ray_tpu_torch.serve import watchdog as twd

_SIDES = {
    "jax": types.SimpleNamespace(pool=jpool, errors=jerr, wd=jwd, obs=jobs),
    "torch": types.SimpleNamespace(pool=tpool, errors=terr, wd=twd,
                                   obs=tobs),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class HBFakeEngine:
    """A replica reduced to what the watchdog touches: a load report
    with ``heartbeat_age_s``/``has_work`` on a fake clock, and the
    lifecycle the pool's death path needs; raises ``errors``' types."""

    def __init__(self, errors, idx, clock):
        self.errors = errors
        self.idx = idx
        self._clock = clock
        self._stopped = False
        self._draining = False
        self._hb = clock()
        self.has_work = False
        self.force_kills = 0
        self.force_kill_err = None
        self.stats = {"submitted": 0}
        self.submits = []

    def start(self):
        return self

    def touch(self):
        self._hb = self._clock()

    def submit(self, prompt, max_new_tokens=64, deadline_s=None):
        if self._stopped:
            raise self.errors.EngineShutdown("engine stopped")
        self.submits.append(list(prompt))
        self.stats["submitted"] += 1

        class _H:
            def stream(_self):
                yield from [1, 2]

            def cancel(_self):
                return True
        return _H()

    def shutdown(self):
        self._stopped = True

    def force_kill(self, err=None):
        self.force_kills += 1
        self.force_kill_err = err
        self._stopped = True

    def drain(self):
        self._draining = True

    def wait_idle(self, timeout_s=30.0):
        return True

    def load_report(self):
        return {"free_slots": 4, "free_pages": 100, "queue_depth": 0,
                "outstanding_tokens": 0, "max_queued": None,
                "shed_retry_after_s": 1.0,
                "draining": self._draining, "stopped": self._stopped,
                "prefix_digest": frozenset(),
                "heartbeat_age_s": self._clock() - self._hb,
                "has_work": self.has_work}

    def prefix_stats(self):
        return None

    def spec_stats(self):
        return None


def _rig(s, clock, n=2, **kw):
    fakes = [HBFakeEngine(s.errors, i, clock) for i in range(n)]
    pool = s.pool.EnginePool(lambda i: fakes[i], n)
    kw.setdefault("flight_dir", False)
    wd = s.wd.PoolWatchdog(pool, time_fn=clock, **kw)
    return fakes, pool, wd


def _states(pool):
    return [pool.replica(i).state for i in range(pool.n_replicas)]


def _record(fakes, pool, wd, trail, extra=None):
    log = [{k: (v is not None if k == "bundle" else v)
            for k, v in e.items()} for e in wd.log]
    rec = {"trail": trail, "counts": dict(wd.counts), "log": log,
           "stats": wd.stats(), "route_stats": dict(pool.route_stats),
           "pool_stats": pool.pool_stats(),
           "events": [(e[2], e[4], e[5]) for e in pool.events.snapshot()],
           "kills": [(f.force_kills, type(f.force_kill_err).__name__,
                      str(f.force_kill_err)) for f in fakes],
           "generations": [pool.replica(i).generation
                           for i in range(pool.n_replicas)]}
    rec.update(extra or {})
    return rec


def _both(case, *args):
    rec = {pkg: case(side, *args) for pkg, side in _SIDES.items()}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def _ladder_suspect_then_wedge_drives_death_path(s):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0)
    assert wd.suspect_after_s == 5.0
    fakes[0].has_work = True
    trail = []
    for dt in (3.0, 3.0, 5.0):
        clock.advance(dt)
        wd.tick()
        trail.append(_states(pool))
    assert trail == [["healthy", "healthy"], ["suspect", "healthy"],
                     ["dead", "healthy"]]
    assert isinstance(fakes[0].force_kill_err, s.wd.ReplicaWedged)
    assert isinstance(fakes[0].force_kill_err, s.errors.EngineShutdown)
    assert fakes[0].force_kill_err.bundle_path is None
    assert fakes[1].force_kills == 0
    pool.shutdown()
    return _record(fakes, pool, wd, trail)


def _wedge_dumps_flight_bundle_before_kill(s, tmp):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0,
                           flight_dir=os.path.join(tmp, s.pool.__name__))
    fakes[0].has_work = True
    trail = []
    for dt in (6.0, 5.0):
        clock.advance(dt)
        wd.tick()
        trail.append(_states(pool))
    err = fakes[0].force_kill_err
    assert err.bundle_path is not None and os.path.isdir(err.bundle_path)
    (wedge,) = [e for e in wd.log if e["event"] == "wedged"]
    assert wedge["bundle"] == err.bundle_path
    b = s.obs.load_flight_bundle(err.bundle_path)
    # the dump precedes the kill: the pool snapshot shows no death yet
    bundle = {"reason": b["reason"], "extra": b["extra"],
              "gap": b["engine"]["heartbeat_gap_s"] >= 9.0,
              "deaths": b["pool"]["pool_stats"].get("replica_deaths", 0),
              "watchdog_log": [e["event"] for e in b["watchdog"]["log"]]}
    pool.shutdown()
    return _record(fakes, pool, wd, trail, {"bundle": bundle})


def _suspect_recovers_on_heartbeat_progress(s):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0)
    fakes[0].has_work = True
    trail = []
    clock.advance(6.0)
    wd.tick()
    trail.append(_states(pool))
    fakes[0].touch()                       # a long but moving prefill
    clock.advance(1.0)
    wd.tick()
    trail.append(_states(pool))
    clock.advance(6.0)                     # a fresh stall: from the top
    wd.tick()
    trail.append(_states(pool))
    assert trail == [["suspect", "healthy"], ["healthy", "healthy"],
                     ["suspect", "healthy"]]
    pool.shutdown()
    return _record(fakes, pool, wd, trail)


def _progressing_readback_drain_never_escalates(s):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0)
    fakes[0].has_work = True
    trail = []
    for _ in range(8):                     # 32 s, each step under 5 s
        clock.advance(4.0)
        fakes[0].touch()
        wd.tick()
        trail.append(_states(pool))
    assert wd.counts["suspected"] == 0
    for dt in (6.0, 5.0):                  # the touches stop
        clock.advance(dt)
        wd.tick()
        trail.append(_states(pool))
    assert trail[-1][0] == "dead"
    pool.shutdown()
    return _record(fakes, pool, wd, trail)


def _suspect_recovers_when_work_drains(s):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0)
    fakes[0].has_work = True
    clock.advance(6.0)
    wd.tick()
    trail = [_states(pool)]
    fakes[0].has_work = False              # drained; the heartbeat stale
    clock.advance(1.0)
    wd.tick()
    trail.append(_states(pool))
    assert trail[-1] == ["healthy", "healthy"]
    assert wd.counts["recovered"] == 1
    pool.shutdown()
    return _record(fakes, pool, wd, trail)


def _idle_stale_heartbeat_is_never_suspected(s):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0)
    trail = []
    for _ in range(5):
        clock.advance(100.0)
        wd.tick()
        trail.append(_states(pool))
    assert wd.counts["suspected"] == 0
    pool.shutdown()
    return _record(fakes, pool, wd, trail)


def _suspect_excluded_from_routing_and_capacity(s):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0)
    fakes[0].has_work = True
    clock.advance(6.0)
    wd.tick()
    trail = [_states(pool)]
    assert pool.healthy_count() == 1
    assert pool.load_report()["healthy_replicas"] == 1
    assert pool.pool_stats()["suspect_replicas"] == 1
    routes = [pool.submit([1, 2, 3]).replica_idx for _ in range(4)]
    assert routes == [1] * 4 and fakes[0].submits == []
    pool.shutdown()
    return _record(fakes, pool, wd, trail, {"routes": routes})


def _engines_without_heartbeat_surface_are_skipped(s):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0)
    orig = fakes[0].load_report

    def bare_report():
        rpt = orig()
        rpt.pop("heartbeat_age_s")
        rpt.pop("has_work")
        return rpt

    fakes[0].load_report = bare_report
    fakes[0].has_work = True
    clock.advance(100.0)
    wd.tick()
    trail = [_states(pool)]
    assert wd.counts["suspected"] == 0
    pool.shutdown()
    return _record(fakes, pool, wd, trail)


def _watchdog_stats_block_in_pool_stats(s):
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=8.0,
                           suspect_after_s=2.0, poll_interval_s=0.5)
    wd.tick()
    blk = pool.pool_stats()["watchdog"]
    assert blk == {"ticks": 1, "suspected": 0, "recovered": 0,
                   "wedged": 0, "active_suspects": 0,
                   "stall_deadline_s": 8.0, "suspect_after_s": 2.0,
                   "poll_interval_s": 0.5}
    pool.shutdown()
    return _record(fakes, pool, wd, [])


def _watchdog_validates_knobs(s):
    clock = FakeClock()
    fakes = [HBFakeEngine(s.errors, 0, clock)]
    pool = s.pool.EnginePool(lambda i: fakes[i], 1)
    msgs = []
    for kw in (dict(stall_deadline_s=0.0),
               dict(stall_deadline_s=1.0, suspect_after_s=2.0)):
        with pytest.raises(ValueError) as ei:
            s.wd.PoolWatchdog(pool, **kw)
        msgs.append(str(ei.value))
    pool.shutdown()
    return {"msgs": msgs}


def _suspect_replica_dies_idle_and_is_forgotten(s):
    """A suspect whose engine stops on its own is noted dead by the next
    tick (routing's corpse check) and its suspicion dropped."""
    clock = FakeClock()
    fakes, pool, wd = _rig(s, clock, stall_deadline_s=10.0)
    fakes[0].has_work = True
    clock.advance(6.0)
    wd.tick()
    fakes[0]._stopped = True
    clock.advance(1.0)
    wd.tick()
    trail = [_states(pool)]
    assert wd.stats()["active_suspects"] == 0
    assert fakes[0].force_kills == 0
    pool.shutdown()
    return _record(fakes, pool, wd, trail)


_FAKE_CASES = [
    _ladder_suspect_then_wedge_drives_death_path,
    _suspect_recovers_on_heartbeat_progress,
    _progressing_readback_drain_never_escalates,
    _suspect_recovers_when_work_drains,
    _idle_stale_heartbeat_is_never_suspected,
    _suspect_excluded_from_routing_and_capacity,
    _engines_without_heartbeat_surface_are_skipped,
    _watchdog_stats_block_in_pool_stats,
    _watchdog_validates_knobs,
    _suspect_replica_dies_idle_and_is_forgotten,
]


@pytest.mark.parametrize("case", _FAKE_CASES,
                         ids=[c.__name__.lstrip("_") for c in _FAKE_CASES])
def test_fake_watchdog_case(case):
    _both(case)


def test_wedge_dumps_flight_bundle_before_kill(tmp_path):
    rec = _both(_wedge_dumps_flight_bundle_before_kill, str(tmp_path))
    assert rec["bundle"]["reason"] == "wedged-r0"
    assert rec["bundle"]["extra"]["stall_deadline_s"] == 10.0
    assert rec["bundle"]["deaths"] == 0 and rec["bundle"]["gap"]


def test_agent_watchdog_matches_the_reference():
    """``AgentWatchdog`` on one fake engine: no escalation while idle,
    while moving or below the deadline; a wedge at it (the bundle off),
    the kill and the callback; nothing on a stopped engine."""
    def case(s):
        clock = FakeClock()
        eng = HBFakeEngine(s.errors, 0, clock)
        current = [eng]
        wedges = []
        wd = s.wd.AgentWatchdog(lambda: current[0], wedges.append,
                                stall_deadline_s=4.0, time_fn=clock,
                                flight_dir=False)
        out = []
        for dt, work, touch in ((10.0, False, False), (3.0, True, True),
                                (3.0, True, False), (2.0, True, False),
                                (1.0, True, False)):
            clock.advance(dt)
            eng.has_work = work
            if touch:
                eng.touch()
            err = wd.tick()
            out.append(None if err is None
                       else (type(err).__name__, str(err),
                             err.bundle_path))
        current[0] = None
        out.append(wd.tick())
        assert isinstance(wedges[0], s.wd.ReplicaWedged)
        return {"out": out, "wedges": [str(w) for w in wedges],
                "kills": eng.force_kills, "stats": wd.stats()}

    rec = _both(case)
    assert rec["out"][:3] == [None, None, None]
    assert rec["out"][3][0] == "ReplicaWedged" and rec["kills"] == 1
    assert rec["stats"]["wedged"] == 1 and rec["stats"]["ticks"] == 6


# ------------------------------------------------------ real engines


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

    return types.SimpleNamespace(model=tmodel, want=want)


def _smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _warm_factory(tiny, inj_for, cls_for=lambda idx: teng.LLMEngine):
    """Warmed port engines: the pool's replicas join with their first
    rounds behind them."""
    def factory(idx):
        eng = cls_for(idx)(tiny.model, max_slots=2, page_size=8,
                  n_pages=64, chunk=4, temperature=0.0,
                  seed=idx, prefix_cache=True,
                  admit_timeout_s=0.5,
                  fault_injector=inj_for(idx), device="cpu")
        eng.start()
        eng.submit([3, 1, 4, 1], max_new_tokens=4).result()
        eng.submit([3, 1, 4, 1, 5, 9], max_new_tokens=4).result()
        eng.reset_latency_stats()
        return eng
    return factory


def test_injected_hang_escalates_to_death_within_deadline(tiny, tmp_path):
    """The watchdog and replica 0's heartbeat run on one fake clock
    (chip_smoke's ``_clocked_engine``), which moves only once the hang
    holds replica 0, in quarters of the deadline: HEALTHY before half
    of it, SUSPECT from half, WEDGED at the deadline and not before.
    Replica 1's heartbeat reads a clock that never moves. On a loaded
    host a round of the survivor can take as long as the deadline on
    the wall clock."""
    smoke = _smoke()
    clock = FakeClock()
    classes = [smoke._clocked_engine(teng.LLMEngine, c)
               for c in (clock, FakeClock())]
    stall = 1.0
    inj = tfaults.FaultInjector()
    pool = tpool.EnginePool(
        _warm_factory(tiny, lambda idx: inj if idx == 0 else None,
                      classes.__getitem__), 2)
    watchdog = twd.PoolWatchdog(pool, stall_deadline_s=stall,
                                poll_interval_s=0.05, time_fn=clock,
                                flight_dir=str(tmp_path))
    try:
        prompts = [[3, 1, 4, 1, 10 + i, 20 + i] for i in range(6)]
        want = [tiny.want(p, 12) for p in prompts]
        hang = inj.hang("step")
        t0 = clock()
        results = [None] * len(prompts)

        def consume(i, h):
            try:
                results[i] = ("ok", h.result())
            except terr.EngineShutdown as e:
                results[i] = ("typed", type(e).__name__)

        handles = [pool.submit(p, max_new_tokens=12) for p in prompts]
        threads = [threading.Thread(target=consume, args=(i, h))
                   for i, h in enumerate(handles)]
        for t in threads:
            t.start()
        smoke._await_hang(pool.replica(0).engine, hang)
        seen = []
        for _ in range(4):
            clock.advance(stall / 4)
            watchdog.tick()
            seen.append((clock() - t0, pool.replica(0).state,
                         watchdog.counts["wedged"]))
        assert seen == [(0.25 * stall, tpool.HEALTHY, 0),
                        (0.5 * stall, tpool.SUSPECT, 0),
                        (0.75 * stall, tpool.SUSPECT, 0),
                        (stall, tpool.DEAD, 1)], seen
        (wedge,) = [e for e in watchdog.log if e["event"] == "wedged"]
        assert wedge["heartbeat_age_s"] >= stall * 0.9
        bundle = tobs.load_flight_bundle(wedge["bundle"])
        assert bundle["reason"].startswith("wedged-r0")
        assert bundle["extra"]["replica"] == 0
        assert bundle["engine"]["heartbeat_gap_s"] >= stall * 0.9
        assert bundle["engine"]["events"]
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None for r in results), "request lost"
        ok = [i for i, r in enumerate(results) if r[0] == "ok"]
        assert ok, "no request completed on the survivor"
        for i in ok:
            assert results[i][1] == want[i], i
        # the streamed ones (none here: the hang precedes every
        # emission) would fail typed ReplicaWedged
        assert {r[1] for r in results if r[0] == "typed"} <= {
            "ReplicaWedged"}
        assert pool.replica(0).state == tpool.DEAD
        deadline = time.monotonic() + 5.0
        while (pool.replica(1).state != tpool.HEALTHY
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert pool.replica(1).state == tpool.HEALTHY
        assert pool.replica(1).generation == 0
        assert pool.route_stats["wedged"] == 1
        kinds = [e[2] for e in pool.events.snapshot()]
        assert kinds.index("wedged") < kinds.index("replica_death")
    finally:
        watchdog.stop()
        inj.release_all()
        pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_released_zombie_is_fenced(tiny):
    inj = tfaults.FaultInjector()
    eng = _warm_factory(tiny, lambda idx: inj)(0)
    try:
        cached_before = eng.prefix_cache.cached_pages
        inj.hang("step")
        h = eng.submit([7, 1, 8, 2], max_new_tokens=32)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            rpt = eng.load_report()
            if rpt["has_work"] and rpt["heartbeat_age_s"] > 0.3:
                break
            time.sleep(0.01)
        else:
            pytest.fail("hang plan never engaged")
        eng.force_kill(twd.ReplicaWedged("test wedge"))
        with pytest.raises(twd.ReplicaWedged):
            h.result()
        assert eng.stats["force_killed"] == 1
        inj.release_all()
        eng._thread.join(timeout=10.0)
        assert not eng._thread.is_alive(), "released zombie never exited"
        assert h._req.generated == []
        assert eng.prefix_cache.cached_pages == cached_before
    finally:
        inj.release_all()
        eng.shutdown()
    tfaults.check_quiesced(eng, expect_cached_pages=eng.prefix_cache
                           .cached_pages)


def test_chip_smoke_pool_control_rehearses_on_the_cpu():
    """chip_smoke phase 3's disaggregated and watchdog cases with the CPU
    standing in for the card: the phase's own checks (the handoffs and
    pulls, suspect -> wedged -> death, typed failures, the fenced
    zombie) hold, so a card run fails only where the card differs."""
    res = _smoke().phase_pool_control(tl, 0, card_device="cpu")
    assert res["disagg"]["handoffs"] == 8
    assert res["disagg"]["pulls"]["pulled_pages"] == 8
    assert res["watchdog"]["counters"]["wedged"] == 1
    assert res["watchdog"]["failed_typed"] >= 1
