"""The port's SLO autoscaler (``ray_tpu_torch/serve/pool_autoscaler.py``)
and capacity seam (``ray_tpu_torch/autoscaler/node_provider.py``)
against the JAX package's, on the CPU.

- The policy cases of tests/test_pool_autoscaler.py (pressure from the
  queue, sheds and the TTFT SLO, the hysteresis band, the idle window
  and its reset, both cooldowns, both clamps, capacity on order,
  Retry-After covering the provisioning ETA, no scale-down while an
  order is in flight, denials, ticket release, the metrics and the
  ``autoscale`` block, the background loop, policy validation) run
  through both packages' ``EnginePool`` and ``PoolAutoscaler`` over
  scripted fake engines on one fake clock. Each case returns a record —
  every tick's decision, the provider's tickets, the pool's size, the
  scaler's ``stats()`` and ``timeline``, the pool's events — and the
  two records must be equal.
- On port engines (``llama_tiny`` fp32, the flax params of
  PRNGKey(0)): a scale-down in the middle of six requests completes
  them all equal to JAX ``generate`` and leaks no page; ``scale_to``
  grows and shrinks a real pool; an autoscaler on a fake clock takes a
  real pool 1 -> 2 -> 1 through a burst and idle time with no request
  lost and the retired engine's pages freed; the deployment's
  ``autoscale`` knobs build one scaler, or one per role.

The reference file's ``test_tpu_slice_provider_lifecycle`` waits for
the port of ``TPUSliceCapacityProvider`` and ``SimulatedTPUCloud``
(ROADMAP.md, queue 1, item 13).
"""
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.autoscaler import node_provider as jnp_prov
from ray_tpu.models import llama as jl
from ray_tpu.serve import engine_pool as jpool
from ray_tpu.serve import errors as jerr
from ray_tpu.serve import pool_autoscaler as jscale
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch.autoscaler import node_provider as tnp_prov
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import engine_pool as tpool
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import faults as tfaults
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import pool_autoscaler as tscale
from ray_tpu_torch.util import metrics as tmetrics

_SIDES = {
    "jax": types.SimpleNamespace(pool=jpool, errors=jerr, scale=jscale,
                                 prov=jnp_prov, metrics=jmetrics),
    "torch": types.SimpleNamespace(pool=tpool, errors=terr, scale=tscale,
                                   prov=tnp_prov, metrics=tmetrics),
}


class FakeHandle:
    def stream(self):
        yield from (1, 2)

    def cancel(self):
        return True


class FakeEngine:
    """A replica reduced to the signals the autoscaler senses, each a
    mutable attribute; raises ``errors``' types."""

    def __init__(self, errors, idx):
        self.errors = errors
        self.idx = idx
        self._stopped = False
        self._draining = False
        self.free_slots = 4
        self.total_slots = 4
        self.queue_depth = 0
        self.outstanding = 0
        self.shed_total = 0
        self.ttft_ewma = None
        self.shed_next = False
        self.stats = {"submitted": 0}
        self.ttfts_s = []
        self.shutdowns = 0

    def start(self):
        return self

    def submit(self, prompt, max_new_tokens=64, deadline_s=None):
        if self._stopped:
            raise self.errors.EngineShutdown("stopped")
        if self._draining:
            raise self.errors.EngineDraining("draining")
        if self.shed_next:
            raise self.errors.EngineOverloaded("shed", retry_after_s=0.1)
        self.stats["submitted"] += 1
        return FakeHandle()

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
        return {"free_slots": self.free_slots,
                "total_slots": self.total_slots, "free_pages": 100,
                "queue_depth": self.queue_depth,
                "outstanding_tokens": self.outstanding,
                "max_queued": None, "shed_retry_after_s": 0.1,
                "shed_total": self.shed_total,
                "ttft_ewma_s": self.ttft_ewma,
                "draining": self._draining, "stopped": self._stopped,
                "prefix_digest": frozenset()}

    def prefix_stats(self):
        return None

    def spec_stats(self):
        return None

    def lifecycle_stats(self):
        return {"max_queued": None, "max_retries": 2,
                "retry_backoff_s": 0.02, "shed": 0}


def _manual_provider(s, eta=1.0, capacity=None):
    """Capacity that turns ready only when the case says so."""

    class ManualProvider(s.prov.ReplicaCapacityProvider):
        def __init__(self):
            self.eta = eta
            self.capacity = capacity
            self.requested = []
            self.ready_tickets = set()
            self.released = []
            self._n = 0

        def request(self):
            held = len(self.requested) - len(self.released)
            if self.capacity is not None and held >= self.capacity:
                raise s.prov.CapacityUnavailable("at capacity")
            self._n += 1
            t = f"ticket-{self._n}"
            self.requested.append(t)
            return t

        def ready(self, ticket):
            return ticket in self.ready_tickets

        def eta_s(self, ticket):
            return 0.0 if ticket in self.ready_tickets else self.eta

        def release(self, ticket):
            self.released.append(ticket)

    return ManualProvider()


def _rig(s, n=1, policy=None, provider=None):
    engines = {}

    def factory(idx):
        engines[idx] = FakeEngine(s.errors, idx)
        return engines[idx]

    pool = s.pool.EnginePool(factory, n)
    clock = [0.0]
    scaler = s.scale.PoolAutoscaler(
        pool,
        s.scale.SLOPolicy(**policy) if policy is not None else
        s.scale.SLOPolicy(min_replicas=n, max_replicas=4, queue_high=2.0,
                          queue_low=0.5, idle_stable_s=5.0,
                          cooldown_up_s=0.0, cooldown_down_s=0.0),
        provider or _manual_provider(s), time_fn=lambda: clock[0])
    return pool, scaler, clock, engines


def _record(pool, scaler, decisions, extra=None):
    prov = scaler.provider
    rec = {"decisions": decisions, "stats": scaler.stats(),
           "timeline": list(scaler.timeline),
           "active": pool.active_count(),
           "requested": list(getattr(prov, "requested", [])),
           "released": list(getattr(prov, "released", [])),
           "states": [r["state"] for r in pool.pool_stats()["replicas"]],
           "events": [(e[2], e[4], e[5]) for e in pool.events.snapshot()]}
    rec.update(extra or {})
    return rec


def _both(case):
    rec = {pkg: case(side) for pkg, side in _SIDES.items()}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def _scale_up_on_queue_pressure(s):
    pool, scaler, clock, engines = _rig(s)
    engines[0].queue_depth = 5
    d = [scaler.tick()]
    assert d == ["up"] and pool.active_count() == 1
    assert scaler.target_replicas() == 2
    scaler.provider.ready_tickets.update(scaler.provider.requested)
    clock[0] += 1.0
    d.append(scaler.tick())
    assert pool.active_count() == 2
    assert scaler.stats()["replicas_added"] == 1
    pool.shutdown()
    return _record(pool, scaler, d)


def _scale_up_on_shed_pressure(s):
    pool, scaler, clock, engines = _rig(s)
    d = [scaler.tick()]
    engines[0].shed_total = 3
    clock[0] += 1.0
    d.append(scaler.tick())
    assert d[-1] == "up"
    pool.shutdown()
    return _record(pool, scaler, d)


def _scale_up_on_ttft_slo_breach(s):
    pool, scaler, clock, engines = _rig(
        s, policy=dict(max_replicas=4, ttft_slo_s=0.5, cooldown_up_s=0.0))
    engines[0].ttft_ewma = 0.9
    d = [scaler.tick()]
    assert d == ["up"]
    pool.shutdown()
    return _record(pool, scaler, d)


def _hold_inside_hysteresis_band(s):
    pool, scaler, clock, engines = _rig(s)
    engines[0].queue_depth = 1
    d = []
    for _ in range(5):
        d.append(scaler.tick())
        clock[0] += 10.0
    assert d == ["hold"] * 5 and scaler.stats()["holds"] == 5
    pool.shutdown()
    return _record(pool, scaler, d)


def _scale_down_on_sustained_idle_via_drain(s):
    pool, scaler, clock, engines = _rig(
        s, n=2, policy=dict(min_replicas=1, max_replicas=4,
                            idle_stable_s=5.0, cooldown_down_s=0.0))
    d = [scaler.tick()]
    clock[0] += 2.0
    d.append(scaler.tick())
    clock[0] += 4.0
    d.append(scaler.tick())
    assert d == ["hold", "hold", "down"] and pool.active_count() == 1
    retired = [e for e in engines.values() if e.shutdowns][0]
    assert retired._draining
    pool.shutdown()
    return _record(pool, scaler, d)


def _idle_timer_resets_on_activity(s):
    pool, scaler, clock, engines = _rig(
        s, n=2, policy=dict(min_replicas=1, max_replicas=4,
                            idle_stable_s=5.0, cooldown_down_s=0.0))
    d = [scaler.tick()]
    clock[0] += 4.0
    engines[0].queue_depth = 1
    d.append(scaler.tick())
    engines[0].queue_depth = 0
    clock[0] += 4.0
    d.append(scaler.tick())
    assert d[-1] == "hold" and pool.active_count() == 2
    pool.shutdown()
    return _record(pool, scaler, d)


def _cooldown_limits_consecutive_scale_ups(s):
    pool, scaler, clock, engines = _rig(
        s, policy=dict(max_replicas=4, cooldown_up_s=10.0))
    engines[0].queue_depth = 50
    d = [scaler.tick()]
    clock[0] += 1.0
    d.append(scaler.tick())
    clock[0] += 10.0
    d.append(scaler.tick())
    assert d == ["up", "hold", "up"]
    pool.shutdown()
    return _record(pool, scaler, d)


def _scale_down_cooldown(s):
    pool, scaler, clock, engines = _rig(
        s, n=3, policy=dict(min_replicas=1, max_replicas=4,
                            idle_stable_s=1.0, cooldown_down_s=30.0))
    d = [scaler.tick()]
    clock[0] += 2.0
    d.append(scaler.tick())
    clock[0] += 2.0
    d.append(scaler.tick())
    clock[0] += 30.0
    d.append(scaler.tick())
    assert d == ["hold", "down", "hold", "down"]
    assert pool.active_count() == 1
    pool.shutdown()
    return _record(pool, scaler, d)


def _max_replicas_clamp(s):
    pool, scaler, clock, engines = _rig(
        s, policy=dict(max_replicas=2, cooldown_up_s=0.0))
    engines[0].queue_depth = 50
    d = [scaler.tick()]
    clock[0] += 1.0
    d.append(scaler.tick())
    assert d == ["up", "hold"]
    assert len(scaler.provider.requested) == 1
    pool.shutdown()
    return _record(pool, scaler, d)


def _min_replicas_clamp(s):
    pool, scaler, clock, engines = _rig(
        s, policy=dict(min_replicas=1, max_replicas=4, idle_stable_s=1.0,
                       cooldown_down_s=0.0))
    d = [scaler.tick()]
    clock[0] += 100.0
    d.append(scaler.tick())
    assert d == ["hold", "hold"]
    assert [e.shutdowns for e in engines.values()] == [0]
    pool.shutdown()
    return _record(pool, scaler, d)


def _pending_capacity_counts_toward_target_and_eta(s):
    provider = _manual_provider(s, eta=3.0)
    pool, scaler, clock, engines = _rig(s, provider=provider)
    engines[0].queue_depth = 50
    d = [scaler.tick()]
    assert scaler.target_replicas() == 2
    assert scaler.capacity_eta_s() == 3.0
    clock[0] += 1.0
    d.append(scaler.tick())
    assert pool.active_count() == 1 and scaler.target_replicas() == 3
    pool.shutdown()
    return _record(pool, scaler, d, {"eta": scaler.capacity_eta_s()})


def _all_shed_hint_covers_provisioning_eta(s):
    provider = _manual_provider(s, eta=3.0)
    pool, scaler, clock, engines = _rig(s, provider=provider)
    engines[0].queue_depth = 50
    d = [scaler.tick()]
    engines[0].shed_next = True
    with pytest.raises(s.errors.EngineOverloaded) as ei:
        pool.submit([1, 2, 3])
    assert ei.value.retry_after_s >= 3.0
    pool.shutdown()
    return _record(pool, scaler, d, {"msg": str(ei.value),
                                     "hint": ei.value.retry_after_s})


def _no_scale_down_while_capacity_pending(s):
    provider = _manual_provider(s, eta=3.0)
    pool, scaler, clock, engines = _rig(
        s, n=2, policy=dict(min_replicas=1, max_replicas=4,
                            idle_stable_s=0.5, cooldown_up_s=0.0,
                            cooldown_down_s=0.0), provider=provider)
    engines[0].queue_depth = 50
    d = [scaler.tick()]
    engines[0].queue_depth = 0
    clock[0] += 10.0
    d.append(scaler.tick())
    clock[0] += 10.0
    d.append(scaler.tick())
    assert d[-1] == "hold" and pool.active_count() == 2
    pool.shutdown()
    return _record(pool, scaler, d)


def _capacity_denial_is_counted_not_fatal(s):
    provider = _manual_provider(s, capacity=0)
    pool, scaler, clock, engines = _rig(s, provider=provider)
    engines[0].queue_depth = 50
    d = [scaler.tick()]
    assert d == ["hold"] and scaler.stats()["denied"] == 1
    assert scaler.target_replicas() == 1
    pool.shutdown()
    return _record(pool, scaler, d)


def _retired_replica_releases_its_ticket(s):
    provider = _manual_provider(s, eta=0.0)
    pool, scaler, clock, engines = _rig(
        s, policy=dict(min_replicas=1, max_replicas=4, idle_stable_s=1.0,
                       cooldown_up_s=0.0, cooldown_down_s=0.0),
        provider=provider)
    engines[0].queue_depth = 50
    d = [scaler.tick()]
    engines[0].queue_depth = 0
    provider.ready_tickets.update(provider.requested)
    clock[0] += 1.0
    d.append(scaler.tick())
    assert pool.active_count() == 2
    engines[0].outstanding = 10
    clock[0] += 2.0
    d.append(scaler.tick())
    assert d[-1] == "down"
    assert provider.released == provider.requested
    assert scaler.stats()["pending"] == 0
    pool.shutdown()
    return _record(pool, scaler, d)


def _immediate_provider_ceiling_and_release(s):
    """The port's own copy of ``ImmediateCapacityProvider``: granted up
    to its ceiling, always ready, a release frees a place."""
    prov = s.prov.ImmediateCapacityProvider(capacity=2)
    tickets = [prov.request(), prov.request()]
    with pytest.raises(s.prov.CapacityUnavailable) as ei:
        prov.request()
    prov.release(tickets[0])
    prov.release(tickets[0])               # idempotent
    tickets.append(prov.request())
    return {"tickets": tickets, "ready": [prov.ready(t) for t in tickets],
            "eta": [prov.eta_s(t) for t in tickets], "msg": str(ei.value)}


def _metrics_and_pool_stats_surface_autoscale(s):
    s.metrics.clear_registry()
    pool, scaler, clock, engines = _rig(s)
    engines[0].queue_depth = 50
    d = [scaler.tick()]

    def val(name):
        samples = s.metrics.registry()[name]._samples()
        return samples[0][1] if samples else 0

    vals = [val("serve_pool_scale_up_total"),
            val("serve_pool_target_replicas")]
    engines[0].queue_depth = 1
    clock[0] += 1.0
    d.append(scaler.tick())
    vals.append(val("serve_pool_scale_hold_total"))
    assert vals == [1, 2, 1]
    block = pool.pool_stats()["autoscale"]
    assert (block["scale_ups"], block["ticks"], block["target_replicas"],
            block["max_replicas"]) == (1, 2, 2, 4)
    pool.shutdown()
    s.metrics.clear_registry()
    return _record(pool, scaler, d, {"metrics": vals, "block": block})


def _policy_validation(s):
    msgs = []
    for kw in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
               dict(queue_low=5.0, queue_high=1.0)):
        with pytest.raises(ValueError) as ei:
            s.scale.SLOPolicy(**kw)
        msgs.append(str(ei.value))
    return {"msgs": msgs,
            "defaults": str(s.scale.SLOPolicy()).split("(", 1)[1]}


_POLICY_CASES = [
    _scale_up_on_queue_pressure, _scale_up_on_shed_pressure,
    _scale_up_on_ttft_slo_breach, _hold_inside_hysteresis_band,
    _scale_down_on_sustained_idle_via_drain,
    _idle_timer_resets_on_activity,
    _cooldown_limits_consecutive_scale_ups, _scale_down_cooldown,
    _max_replicas_clamp, _min_replicas_clamp,
    _pending_capacity_counts_toward_target_and_eta,
    _all_shed_hint_covers_provisioning_eta,
    _no_scale_down_while_capacity_pending,
    _capacity_denial_is_counted_not_fatal,
    _retired_replica_releases_its_ticket,
    _immediate_provider_ceiling_and_release,
    _metrics_and_pool_stats_surface_autoscale,
    _policy_validation,
]


@pytest.mark.parametrize("case", _POLICY_CASES,
                         ids=[c.__name__.lstrip("_") for c in _POLICY_CASES])
def test_policy_case(case):
    _both(case)


def test_background_loop_scales_up_and_stops():
    out = {}
    for pkg, s in _SIDES.items():
        engines = {}

        def factory(idx, s=s, engines=engines):
            engines[idx] = FakeEngine(s.errors, idx)
            return engines[idx]

        pool = s.pool.EnginePool(factory, 1)
        provider = _manual_provider(s, eta=0.0)
        scaler = s.scale.PoolAutoscaler(
            pool, s.scale.SLOPolicy(max_replicas=2, cooldown_up_s=0.0),
            provider).run(interval_s=0.01)
        engines[0].queue_depth = 50
        deadline = time.monotonic() + 5.0
        while not provider.requested and time.monotonic() < deadline:
            time.sleep(0.01)
        provider.ready_tickets.update(provider.requested)
        while pool.active_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        scaler.stop()
        assert scaler._thread is None and scaler.stats()["ticks"] > 0
        out[pkg] = (pool.active_count(), provider.requested)
        pool.shutdown()
    assert out["torch"] == out["jax"] == (2, ["ticket-1"])


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

    def factory(idx):
        return teng.LLMEngine(tmodel, max_slots=2, page_size=16,
                              n_pages=64, chunk=2, prefill_chunk=16,
                              temperature=0.0, eos_id=-1, seed=idx,
                              device="cpu")

    return types.SimpleNamespace(model=tmodel, sd=sd, want=want,
                                 factory=factory)


def test_scale_down_drains_without_losing_inflight(tiny):
    pool = tpool.EnginePool(tiny.factory, 2)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 256, size=10).tolist() for _ in range(6)]
    handles = [pool.submit(p, max_new_tokens=16) for p in prompts]
    assert len(pool.scale_down(1, timeout_s=30.0)) == 1
    assert [h.result() for h in handles] == [tiny.want(p, 16)
                                             for p in prompts]
    assert pool.active_count() == pool.healthy_count() == 1
    assert pool.submit(prompts[0], max_new_tokens=16).result() == \
        tiny.want(prompts[0], 16)
    pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_scale_to_grows_and_shrinks_real_pool(tiny):
    pool = tpool.EnginePool(tiny.factory, 1)
    assert pool.scale_to(3) == 3
    rng = np.random.RandomState(5)
    handles = [pool.submit(rng.randint(1, 256, size=8).tolist(),
                           max_new_tokens=8) for _ in range(6)]
    assert all(len(h.result()) == 8 for h in handles)
    assert pool.scale_to(1) == 1
    assert pool.scale_to(2) == 2          # a tombstone's index reused
    assert sorted(pool.replica(i).generation for i in range(3)) == \
        [0, 0, 1]
    pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_autoscaler_takes_a_real_pool_one_two_one(tiny):
    """A burst on one replica scales the pool to two (the order lands on
    the next tick), every request completes equal to ``generate``, then
    idle time past ``idle_stable_s`` retires one through the drain; no
    request is lost and every engine, the retired one too, quiesces."""
    class Gated(teng.LLMEngine):
        # replica 0's scheduler starts at go(): the burst queues whole
        def start(self):
            return self

        def go(self):
            return teng.LLMEngine.start(self)

    def factory(idx):
        if idx:
            return tiny.factory(idx)
        return Gated(tiny.model, max_slots=2, page_size=16, n_pages=64,
                     chunk=2, prefill_chunk=16, temperature=0.0,
                     eos_id=-1, seed=idx, device="cpu")

    pool = tpool.EnginePool(factory, 1)
    clock = [0.0]
    scaler = tscale.PoolAutoscaler(
        pool, tscale.SLOPolicy(min_replicas=1, max_replicas=2,
                               cooldown_up_s=0.0, cooldown_down_s=0.0,
                               idle_stable_s=5.0),
        time_fn=lambda: clock[0])
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, size=9).tolist() for _ in range(10)]
    try:
        handles = [pool.submit(p, max_new_tokens=8) for p in prompts]
        assert pool.load_report()["queue_depth"] == 10
        decisions = [scaler.tick()]
        pool.replica(0).engine.go()
        clock[0] += 1.0
        late = [pool.submit(p, max_new_tokens=8) for p in prompts[:4]]
        decisions.append(scaler.tick())    # harvest: replica 1 joins
        assert pool.active_count() == 2
        late += [pool.submit(p, max_new_tokens=8) for p in prompts[4:8]]
        for h, p in zip(handles + late, prompts + prompts[:8]):
            assert h.result() == tiny.want(p, 8)
        assert {h.replica_idx for h in late} == {0, 1}
        for e in pool.engines():
            e.wait_idle(30)
        for _ in range(3):
            clock[0] += 3.0
            decisions.append(scaler.tick())
        assert decisions == ["up", "hold", "hold", "hold", "down"], \
            decisions
        assert pool.active_count() == 1
        assert scaler.stats()["replicas_added"] == 1
        assert scaler.stats()["replicas_retired"] == 1
        kinds = [e[2] for e in pool.events.snapshot()]
        assert kinds.count("autoscale") == 2 and "drain" in kinds
    finally:
        pool.shutdown()
    tfaults.check_pool_quiesced(pool)


def test_deployment_autoscale_and_watchdog_knobs(tiny):
    """``LlamaDeployment(autoscale=True)`` builds one scaler with the
    pool's floor and the overrides; with ``disaggregate`` one per role
    with that side's overrides and a shared provider; with
    ``engine_stall_deadline_s`` a running watchdog; ``shutdown`` stops
    them all."""
    cfg = tl.llama_tiny(dtype=torch.float32)
    kw = dict(device="cpu", page_size=8, max_slots=2, max_new_tokens=4)
    dep = tllm.LlamaDeployment(
        cfg, tiny.sd, autoscale=True, autoscale_max_replicas=3,
        autoscale_policy={"ttft_slo_s": 0.25}, autoscale_interval_s=0.05,
        engine_stall_deadline_s=5.0, watchdog_interval_s=0.2, **kw)
    assert dep.autoscaler() is None and dep.watchdog() is None
    assert dep([1, 2, 3]) == [1, 2, 3] + tiny.want([1, 2, 3], 4)
    sc, wd = dep.autoscaler(), dep.watchdog()
    assert (sc.policy.min_replicas, sc.policy.max_replicas,
            sc.policy.ttft_slo_s) == (1, 3, 0.25)
    assert wd.stall_deadline_s == 5.0 and wd.poll_interval_s == 0.2
    assert dep.engine()._autoscaler is sc and dep.engine()._watchdog is wd
    st = dep.serve_stats()["engine"]["pool"]
    assert st["autoscale"]["max_replicas"] == 3
    assert st["watchdog"]["stall_deadline_s"] == 5.0
    dep.shutdown()
    assert sc._thread is None and wd._thread is None
    tfaults.check_pool_quiesced(dep.engine())

    dep = tllm.LlamaDeployment(
        cfg, tiny.sd, disaggregate=True, prefix_cache=True,
        decode_replicas=2, autoscale=True, autoscale_max_replicas=4,
        autoscale_policy={"queue_high": 3.0,
                          "prefill": {"ttft_slo_s": 0.5},
                          "decode": {"itl_slo_s": 0.1}}, **kw)
    dep.engine()
    scalers = dep.autoscaler()
    assert set(scalers) == {"prefill", "decode"}
    pre, dec = scalers["prefill"], scalers["decode"]
    assert (pre.policy.min_replicas, pre.policy.ttft_slo_s,
            pre.policy.itl_slo_s, pre.policy.queue_high) == (1, 0.5, None,
                                                             3.0)
    assert (dec.policy.min_replicas, dec.policy.ttft_slo_s,
            dec.policy.itl_slo_s) == (2, None, 0.1)
    assert pre.provider is dec.provider
    assert dep.watchdog() is None
    ps = dep.engine().pool_stats()
    assert set(ps["autoscale_by_role"]) == {"prefill", "decode"}
    dep.shutdown()
    assert pre._thread is None and dec._thread is None
    tfaults.check_pool_quiesced(dep.engine())
