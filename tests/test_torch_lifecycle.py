"""The port's request lifecycle (cancel, deadlines, bounded admission,
fault containment, force-kill) against the JAX engine's, on the CPU.

The engine cases of tests/test_request_lifecycle.py and
tests/test_serve_watchdog.py::test_released_zombie_is_fenced (the
HTTP-proxy cases wait for the proxy), plus the lone-slot
pool-exhaustion repair. Each case runs the same script through both
packages' ``LLMEngine`` (``llama_tiny`` fp32 with the flax params of
PRNGKey(0), carried over by ``flax_state_dict``; ``overlap=False``
unless a case says otherwise) under the same ``FaultInjector`` plan,
and returns a record: every handle's outcome (its tokens, or its error
type and message), ``lifecycle_stats()`` and the counters the
reference's case asserts. The two records must be EQUAL, every
survivor's stream must equal JAX ``generate``, and both engines must
pass their package's ``check_quiesced``. Where the reference's case
races a scheduler thread, only the properties the race cannot change
are compared.
"""
import importlib.util
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
from ray_tpu.serve import engine as jeng
from ray_tpu.serve import errors as jerr
from ray_tpu.serve import faults as jfaults
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import faults as tfaults
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.prefix_cache import path_hashes
from ray_tpu_torch.util import metrics as tmetrics

_REF_TOKENS = 40


@pytest.fixture(scope="module")
def tiny():
    """Per package: a namespace with ``engine(**kw)``, its ``errors``
    and ``faults`` modules; and ``want(prompt, n)``, JAX ``generate``."""
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

    def side(pkg):
        if pkg == "jax":
            def engine(**kw):
                return jeng.LLMEngine(jmodel, params,
                                      **{"overlap": False, **kw})
            return types.SimpleNamespace(pkg=pkg, engine=engine, errors=jerr,
                                         faults=jfaults)

        def engine(**kw):
            return teng.LLMEngine(tmodel, device="cpu",
                                  **{"overlap": False, **kw})
        return types.SimpleNamespace(pkg=pkg, engine=engine, errors=terr,
                                     faults=tfaults)

    return types.SimpleNamespace(jax=side("jax"), torch=side("torch"),
                                 want=want, sd=sd)


def _drive(eng, max_rounds=5000):
    for _ in range(max_rounds):
        if not eng.step():
            return
    raise AssertionError(f"engine did not quiesce within {max_rounds} "
                         f"rounds")


def _outcome(h):
    """A handle's end: ("ok", tokens) or ("err", type name, message)."""
    try:
        return ("ok", h.result())
    except Exception as e:  # noqa: BLE001 - the record names the type
        return ("err", type(e).__name__, str(e))


def _slot_of(eng, handle):
    for i, s in enumerate(eng.slots):
        if s is not None and s.req is handle._req:
            return i
    return None


def _both(tiny, case, *args, **kw):
    """Run ``case(side, ...)`` through both packages; the records must be
    equal. Returns the record."""
    rec = {pkg: case(getattr(tiny, pkg), *args, **kw)
           for pkg in ("jax", "torch")}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def _lifecycle(eng, *keys):
    stats = {k: eng.stats[k] for k in keys}
    return {"lifecycle": eng.lifecycle_stats(), "stats": stats}


# ----------------------------------------------------- the repair first


def _lone_slot_pinned(side):
    """A donor pin on a cached 4-page prefix leaves 4 of 8 usable pages;
    a 16 + 40-token request cannot grow past them, and nothing else
    holds pages to preempt."""
    eng = side.engine(max_slots=2, page_size=8, n_pages=9, chunk=4,
                      prefix_cache=True)
    prefix = list(range(1, 33))
    h0 = eng.submit(prefix, max_new_tokens=1)
    _drive(eng)
    h0.result()
    pinned = eng.kv_pin_prefix(path_hashes(prefix, 8))
    assert len(pinned) == 4 and eng.alloc.n_free == 4
    h1 = eng.submit(list(range(40, 56)), max_new_tokens=40)
    h2 = eng.submit([5, 9, 2], max_new_tokens=2)
    _drive(eng)
    rec = {"out": [_outcome(h1), _outcome(h2)],
           "stopped": eng.load_report()["stopped"],
           **_lifecycle(eng, "failed_all", "completed")}
    # the engine still serves
    h3 = eng.submit([4, 4, 8], max_new_tokens=6)
    _drive(eng)
    rec["after"] = _outcome(h3)
    eng.kv_release_pages(pinned)
    side.faults.check_quiesced(eng)
    return rec


def test_lone_slot_exhaustion_is_contained_like_jax(tiny):
    """A lone slot that cannot grow fails only its own request, with the
    reference's error, and the engine keeps serving: on the parent
    commit the port's step() raised a RuntimeError out of the growth."""
    rec = _both(tiny, _lone_slot_pinned)
    err = rec["out"][0]
    assert err[:2] == ("err", "RequestError")
    assert err[2].startswith("request 1: page pool exhausted by one slot")
    assert rec["out"][1] == ("ok", tiny.want([5, 9, 2], 2))
    assert rec["after"] == ("ok", tiny.want([4, 4, 8], 6))
    assert rec["stopped"] is False
    assert rec["stats"] == {"failed_all": 0, "completed": 2}
    assert rec["lifecycle"]["contained_faults"] == 1
    assert rec["lifecycle"]["fault_failed"] == 1


# ------------------------------------------------------------ cancellation


def _cancel_queued(side, want):
    eng = side.engine(max_slots=1, page_size=8, n_pages=32, chunk=2)
    h1 = eng.submit([5, 9, 2], max_new_tokens=12)
    eng.step()                       # h1 takes the only slot
    h2 = eng.submit([7, 7, 7], max_new_tokens=12)
    assert h2.cancel() is True and h2.done
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)],
            **_lifecycle(eng, "cancelled")}


def test_cancel_queued_request(tiny):
    rec = _both(tiny, _cancel_queued, tiny.want)
    assert rec["out"][0] == ("ok", tiny.want([5, 9, 2], 12))
    assert rec["out"][1][1] == "RequestCancelled"
    assert rec["stats"]["cancelled"] == 1


def _cancel_mid_decode(side):
    eng = side.engine(max_slots=4, page_size=8, n_pages=64, chunk=2)
    h1 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=24)
    h2 = eng.submit([2, 7, 1, 8], max_new_tokens=24)
    for _ in range(4):
        eng.step()
    assert _slot_of(eng, h2) is not None     # mid-decode
    assert h2.cancel() is True
    assert _slot_of(eng, h2) is None         # the slot frees now
    _drive(eng)
    side.faults.check_quiesced(eng)
    # how many tokens reached the stream before the cancel depends on
    # when the device finished, so only that it was partial is compared
    return {"out": [_outcome(h1), _outcome(h2)[:2]],
            "partial": len(h2._req.generated) < 24,
            **_lifecycle(eng, "cancelled")}


def test_cancel_mid_decode_survivor_parity(tiny):
    rec = _both(tiny, _cancel_mid_decode)
    assert rec["out"][0] == ("ok", tiny.want([3, 1, 4, 1, 5], 24))
    assert rec["out"][1] == ("err", "RequestCancelled")
    assert rec["partial"]
    assert rec["stats"]["cancelled"] == 1


def _cancel_mid_prefill(side):
    eng = side.engine(max_slots=2, page_size=8, n_pages=64, chunk=2,
                      prefill_chunk=8)
    p1 = list(range(1, 25))                  # 24 tokens: 3 chunks
    h1 = eng.submit(p1, max_new_tokens=6)
    eng.step()                               # the first chunk only
    ix = _slot_of(eng, h1)
    assert 0 < eng.slots[ix].prefilled < len(p1)
    assert h1.cancel() is True
    h2 = eng.submit([7, 3], max_new_tokens=6)
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)]}


def test_cancel_mid_prefill(tiny):
    rec = _both(tiny, _cancel_mid_prefill)
    assert rec["out"][0][1] == "RequestCancelled"
    assert rec["out"][1] == ("ok", tiny.want([7, 3], 6))


def _cancel_after_completion(side):
    eng = side.engine(max_slots=1, page_size=8, n_pages=32, chunk=4)
    h = eng.submit([5, 9, 2], max_new_tokens=4)
    _drive(eng)
    out = _outcome(h)
    noop = h.cancel()
    side.faults.check_quiesced(eng)
    return {"out": out, "cancel": noop, **_lifecycle(eng, "cancelled")}


def test_cancel_after_completion_is_noop(tiny):
    rec = _both(tiny, _cancel_after_completion)
    assert rec["out"] == ("ok", tiny.want([5, 9, 2], 4))
    assert rec["cancel"] is False and rec["stats"]["cancelled"] == 0


def _cancel_retired_in_flight(side):
    """No-eos mode retires a slot at dispatch while its tokens are still
    in flight; a cancel then closes the stream without touching freed
    pages. Whether the tokens are still in flight depends on when the
    device finished, so only the invariants are compared."""
    eng = side.engine(max_slots=2, page_size=8, n_pages=32, chunk=4)
    h = eng.submit([5, 9, 2], max_new_tokens=12)
    for _ in range(3):
        eng.step()
        if _slot_of(eng, h) is None:
            break
    if not h.done:
        assert h.cancel() is True
        with pytest.raises(side.errors.RequestCancelled):
            h.result()
        assert eng.stats["cancelled"] == 1
    _drive(eng)
    side.faults.check_quiesced(eng)
    return True


def test_cancel_retired_request_with_tokens_in_flight(tiny):
    _both(tiny, _cancel_retired_in_flight)


# --------------------------------------------------------------- deadlines


def _deadline_queued(side):
    eng = side.engine(max_slots=1, page_size=8, n_pages=32, chunk=2)
    h1 = eng.submit([5, 9, 2], max_new_tokens=8)
    eng.step()                       # h1 owns the only slot
    h2 = eng.submit([1, 2, 3], max_new_tokens=8, deadline_s=0.01)
    time.sleep(0.03)
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)[:2]],
            **_lifecycle(eng, "deadline_exceeded")}


def test_deadline_expires_while_queued(tiny):
    rec = _both(tiny, _deadline_queued)
    assert rec["out"] == [("ok", tiny.want([5, 9, 2], 8)),
                          ("err", "DeadlineExceeded")]
    assert rec["stats"]["deadline_exceeded"] == 1


def _deadline_slow_step(side):
    """The slow-step fault: a stall blows a request past its deadline;
    the request without one is exact."""
    inj = side.faults.FaultInjector()
    inj.slow("step", 0.05, round=3, times=1)
    eng = side.engine(max_slots=4, page_size=8, n_pages=64, chunk=2,
                      fault_injector=inj)
    h1 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=24)
    h2 = eng.submit([2, 7, 1, 8], max_new_tokens=24, deadline_s=0.04)
    _drive(eng)
    assert ("step", 3, None, "sleep") in inj.log
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)[:2]],
            **_lifecycle(eng, "deadline_exceeded")}


def test_deadline_expires_mid_decode_under_slow_step(tiny):
    rec = _both(tiny, _deadline_slow_step)
    assert rec["out"] == [("ok", tiny.want([3, 1, 4, 1, 5], 24)),
                          ("err", "DeadlineExceeded")]
    assert rec["stats"]["deadline_exceeded"] == 1


def _deadline_validation(side):
    eng = side.engine(max_slots=1, page_size=8, n_pages=32, chunk=2)
    out = []
    for dl in (0.0, -1):
        with pytest.raises(side.errors.RequestError) as ei:
            eng.submit([1], max_new_tokens=1, deadline_s=dl)
        out.append(str(ei.value))
    return out


def test_deadline_validation(tiny):
    assert _both(tiny, _deadline_validation) == ["deadline_s must be > 0"] * 2


# ---------------------------------------------- bounded admission and shed


def _overload(side):
    eng = side.engine(max_slots=1, page_size=8, n_pages=32, chunk=2,
                      max_queued=2, shed_retry_after_s=2.5)
    hs = [eng.submit([i + 1, i + 2], max_new_tokens=4) for i in range(2)]
    with pytest.raises(side.errors.EngineOverloaded) as ei:
        eng.submit([9, 9], max_new_tokens=4)
    shed = (ei.value.retry_after_s, str(ei.value))
    _drive(eng)
    out = [_outcome(h) for h in hs]
    h = eng.submit([5, 5], max_new_tokens=4)      # capacity is back
    _drive(eng)
    out.append(_outcome(h))
    side.faults.check_quiesced(eng)
    return {"shed": shed, "out": out, **_lifecycle(eng, "shed")}


def test_overload_sheds_fast_with_retry_after(tiny):
    rec = _both(tiny, _overload)
    assert rec["shed"][0] == 2.5
    assert rec["out"] == [("ok", tiny.want([i + 1, i + 2], 4))
                          for i in range(2)] + [
        ("ok", tiny.want([5, 5], 4))]
    assert rec["stats"]["shed"] == 1
    assert rec["lifecycle"]["shed"] == 1
    assert rec["lifecycle"]["max_queued"] == 2


def test_shed_counter_exported_to_metrics(tiny):
    eng = tiny.torch.engine(max_slots=1, page_size=8, n_pages=32, chunk=2,
                            max_queued=0)
    with pytest.raises(terr.EngineOverloaded):
        eng.submit([1, 2], max_new_tokens=4)
    reg = tmetrics.registry()
    assert teng.SHED_TOTAL == jeng.SHED_TOTAL
    assert teng.SHED_TOTAL in reg
    assert any(v >= 1 for _tags, v in reg[teng.SHED_TOTAL]._samples())
    assert teng.SHED_TOTAL in tmetrics.prometheus_text()
    tfaults.check_quiesced(eng)


def test_lifecycle_metric_families_carry_the_reference_names():
    for name in ("SHED_TOTAL", "CANCELLED_TOTAL", "DEADLINE_TOTAL",
                 "CONTAINED_TOTAL", "RETRIES_TOTAL", "BATCH_TOKENS_TOTAL",
                 "BATCH_PREEMPTED_TOTAL"):
        assert getattr(teng, name) == getattr(jeng, name)
    fams = teng._metrics()
    for key, name in (("shed", teng.SHED_TOTAL),
                      ("cancelled", teng.CANCELLED_TOTAL),
                      ("deadline_exceeded", teng.DEADLINE_TOTAL),
                      ("contained_faults", teng.CONTAINED_TOTAL),
                      ("retries", teng.RETRIES_TOTAL),
                      ("batch_tokens", teng.BATCH_TOKENS_TOTAL),
                      ("batch_preempted", teng.BATCH_PREEMPTED_TOTAL)):
        assert tmetrics.registry()[name] is fams[key]


# --------------------------------------------------- fault class: allocator


def _alloc_recovers(side):
    inj = side.faults.FaultInjector()
    inj.exhaust_alloc(times=2)
    eng = side.engine(max_slots=2, page_size=8, n_pages=64, chunk=4,
                      fault_injector=inj)
    h1 = eng.submit([3, 1, 4], max_new_tokens=8)
    h2 = eng.submit([2, 7, 1, 8], max_new_tokens=8)
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)], "log": list(inj.log),
            **_lifecycle(eng)}


def test_alloc_exhaustion_recovers_without_failures(tiny):
    """A transiently dry pool at admission is a wait, not an error."""
    rec = _both(tiny, _alloc_recovers)
    assert rec["out"] == [("ok", tiny.want([3, 1, 4], 8)),
                          ("ok", tiny.want([2, 7, 1, 8], 8))]
    assert [e for e in rec["log"] if e[0] == "alloc"]
    assert rec["lifecycle"]["contained_faults"] == 0
    assert rec["lifecycle"]["retries"] == 0


def _alloc_lone_slot(side):
    inj = side.faults.FaultInjector()
    inj.exhaust_alloc(round=2, times=1)
    eng = side.engine(max_slots=1, page_size=4, n_pages=32, chunk=2,
                      fault_injector=inj)
    h1 = eng.submit([1, 2, 3], max_new_tokens=16)
    _drive(eng)
    rec = {"out": [_outcome(h1)],
           **_lifecycle(eng, "fault_failed", "failed_all")}
    h2 = eng.submit([4, 4, 8], max_new_tokens=6)
    _drive(eng)
    rec["out"].append(_outcome(h2))
    side.faults.check_quiesced(eng)
    return rec


def test_alloc_exhaustion_lone_slot_contained(tiny):
    """A lone slot that cannot grow is attributable: that request fails
    typed, the engine serves the next."""
    rec = _both(tiny, _alloc_lone_slot)
    assert rec["out"][0][:2] == ("err", "RequestError")
    assert "page pool exhausted" in rec["out"][0][2]
    assert rec["out"][1] == ("ok", tiny.want([4, 4, 8], 6))
    assert rec["lifecycle"]["contained_faults"] == 1
    assert rec["stats"] == {"fault_failed": 1, "failed_all": 0}


# ---------------------------------------------------- fault class: dispatch


def _decode_fault(side, overlap=False):
    inj = side.faults.FaultInjector()
    inj.inject("dispatch_decode", sid=1, round=3)
    eng = side.engine(max_slots=4, page_size=8, n_pages=64, chunk=2,
                      fault_injector=inj, retry_backoff_s=0.005,
                      overlap=overlap)
    h1 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=16)   # slot 0
    h2 = eng.submit([2, 7, 1, 8], max_new_tokens=16)      # slot 1: culprit
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)], "attempts":
            h1._req.attempts, "log": list(inj.log),
            **_lifecycle(eng, "fault_failed", "failed_all")}


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["lockstep", "overlapped"])
def test_decode_dispatch_fault_contained(tiny, overlap):
    """A decode rider's fault fails only that request; the innocent
    co-rider requeues once and still matches greedy decode. The port's
    overlapped loop is held to the JAX engine's lockstep record (on the
    CPU every readback is ready, so the two loops run the same rounds)."""
    rec = {"jax": _decode_fault(tiny.jax),
           "torch": _decode_fault(tiny.torch, overlap)}
    assert rec["torch"] == rec["jax"]
    rec = rec["torch"]
    assert rec["out"][0] == ("ok", tiny.want([3, 1, 4, 1, 5], 16))
    assert rec["out"][1] == ("err", "RuntimeError",
                             "injected fault at dispatch_decode")
    assert rec["lifecycle"]["contained_faults"] == 1
    assert rec["lifecycle"]["retries"] == 1
    assert rec["lifecycle"]["retry_exhausted"] == 0
    assert rec["stats"] == {"fault_failed": 1, "failed_all": 0}
    assert rec["attempts"] == 1


def _prefill_fault(side):
    inj = side.faults.FaultInjector()
    inj.inject("dispatch_prefill", sid=0, round=1, exc=ValueError("bad row"))
    eng = side.engine(max_slots=4, page_size=8, n_pages=64, chunk=2,
                      fault_injector=inj, retry_backoff_s=0.005)
    h1 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=8)    # slot 0: culprit
    h2 = eng.submit([2, 7, 1, 8], max_new_tokens=8)       # slot 1
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)],
            "culprit_tokens": len(h1._req.generated),
            **_lifecycle(eng, "fault_failed")}


def test_prefill_dispatch_fault_contained(tiny):
    rec = _both(tiny, _prefill_fault)
    assert rec["out"][0] == ("err", "ValueError", "bad row")
    assert rec["culprit_tokens"] == 0            # died before any token
    assert rec["out"][1] == ("ok", tiny.want([2, 7, 1, 8], 8))
    assert rec["lifecycle"]["retries"] == 1
    assert rec["stats"]["fault_failed"] == 1


def _spec_fault(side):
    inj = side.faults.FaultInjector()
    inj.inject("dispatch_spec", sid=1, round=4)
    eng = side.engine(max_slots=4, page_size=8, n_pages=64, chunk=2,
                      spec_len=3, spec_ngram=2, fault_injector=inj,
                      retry_backoff_s=0.005)
    rep = ([7, 8, 9, 10] * 5)[:16]           # repetitive: drafts fire
    h1 = eng.submit(rep, max_new_tokens=12)          # slot 0
    h2 = eng.submit(list(rep[2:]), max_new_tokens=12)  # slot 1
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)], "log": list(inj.log),
            **_lifecycle(eng, "failed_all")}


def test_spec_dispatch_fault_contained(tiny):
    rec = _both(tiny, _spec_fault)
    rep = ([7, 8, 9, 10] * 5)[:16]
    assert rec["out"][0] == ("ok", tiny.want(rep, 12))
    assert rec["out"][1] == ("err", "RuntimeError",
                             "injected fault at dispatch_spec")
    assert rec["lifecycle"]["contained_faults"] == 1
    assert rec["stats"]["failed_all"] == 0


def _retry_exhausted(side):
    inj = side.faults.FaultInjector()
    inj.inject("dispatch_decode", sid=1, round=3)
    eng = side.engine(max_slots=4, page_size=8, n_pages=64, chunk=2,
                      max_retries=0, fault_injector=inj)
    h1 = eng.submit([3, 1, 4], max_new_tokens=16)    # innocent
    h2 = eng.submit([2, 7, 1], max_new_tokens=16)    # culprit
    _drive(eng)
    out = [_outcome(h1), _outcome(h2)]
    h3 = eng.submit([4, 4, 8], max_new_tokens=6)
    _drive(eng)
    out.append(_outcome(h3))
    side.faults.check_quiesced(eng)
    return {"out": out, **_lifecycle(eng)}


def test_retry_policy_exhausts_bounded(tiny):
    """max_retries=0: the innocent participant fails too, naming the
    budget, and the engine still serves the next request."""
    rec = _both(tiny, _retry_exhausted)
    assert rec["out"][0][:2] == ("err", "RequestError")
    assert "failed after 0 retries" in rec["out"][0][2]
    assert rec["out"][1] == ("err", "RuntimeError",
                             "injected fault at dispatch_decode")
    assert rec["out"][2] == ("ok", tiny.want([4, 4, 8], 6))
    assert rec["lifecycle"]["retry_exhausted"] == 1
    assert rec["lifecycle"]["retries"] == 0


# ---------------------------------------------------- fault class: readback


def _readback_fault(side):
    inj = side.faults.FaultInjector()
    inj.inject("readback", sid=1, round=1, exc=OSError("xfer error"))
    eng = side.engine(max_slots=4, page_size=8, n_pages=64, chunk=2,
                      fault_injector=inj)
    h1 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=12)
    h2 = eng.submit([2, 7, 1, 8], max_new_tokens=12)
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [_outcome(h1), _outcome(h2)],
            **_lifecycle(eng, "fault_failed", "failed_all")}


def test_readback_fault_isolated(tiny):
    rec = _both(tiny, _readback_fault)
    assert rec["out"] == [("ok", tiny.want([3, 1, 4, 1, 5], 12)),
                          ("err", "OSError", "xfer error")]
    assert rec["lifecycle"]["contained_faults"] == 1
    assert rec["stats"] == {"fault_failed": 1, "failed_all": 0}


def _readback_eos(side, eos):
    inj = side.faults.FaultInjector()
    inj.inject("readback", sid=0, round=2)
    eng = side.engine(max_slots=2, page_size=8, n_pages=32, chunk=4,
                      eos_id=eos, fault_injector=inj)
    h = eng.submit([5, 9, 2], max_new_tokens=16)
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": _outcome(h), **_lifecycle(eng, "fault_failed")}


def test_readback_fault_eos_mode_slot_teardown(tiny):
    """With an eos the slot is live at emission, so a readback fault
    tears the slot down (pages freed), not just the stream."""
    eos = max(tiny.want([5, 9, 2], 16)) + 1
    rec = _both(tiny, _readback_eos, eos)
    assert rec["out"] == ("err", "RuntimeError", "injected fault at readback")
    assert rec["stats"]["fault_failed"] == 1


# ------------------------------------------------------------ global faults


def _global_fault(side):
    inj = side.faults.FaultInjector()
    inj.inject("step", round=2, exc=RuntimeError("device lost"))
    eng = side.engine(max_slots=2, page_size=8, n_pages=32, chunk=2,
                      fault_injector=inj).start()
    hs = [eng.submit([3, 1, 4], max_new_tokens=40),
          eng.submit([2, 7, 1], max_new_tokens=40)]
    out = [_outcome(h) for h in hs]
    with pytest.raises(side.errors.EngineShutdown):
        eng.submit([1], max_new_tokens=1)
    eng._thread.join(timeout=10)
    side.faults.check_quiesced(eng)
    return {"out": out, **_lifecycle(eng, "failed_all")}


def test_global_fault_fails_all_and_stops(tiny):
    """A fault at the step site has no culprit (a device loss): every
    request fails with the raw error, the engine stops, later submits
    see EngineShutdown, and nothing leaks."""
    rec = _both(tiny, _global_fault)
    assert rec["out"] == [("err", "RuntimeError", "device lost")] * 2
    assert rec["stats"]["failed_all"] == 1
    assert rec["lifecycle"]["contained_faults"] == 0


def _kill_replica(side):
    inj = side.faults.FaultInjector()
    inj.kill_replica(round=2)    # before any stream can complete
    eng = side.engine(max_slots=2, page_size=8, n_pages=32, chunk=2,
                      fault_injector=inj)
    hs = [eng.submit([3, 1, 4], max_new_tokens=20),
          eng.submit([2, 7, 1], max_new_tokens=20),
          eng.submit([9, 9], max_new_tokens=4)]
    with pytest.raises(side.faults.ReplicaKilled):
        _drive(eng)
    eng._fail_all(side.faults.ReplicaKilled("injected replica death"))
    out = [_outcome(h)[:2] for h in hs]
    side.faults.check_quiesced(eng)
    return {"out": out, "stopped": eng.load_report()["stopped"]}


def test_kill_replica_fails_every_request_and_stops(tiny):
    """``kill_replica`` escapes containment: driven by hand, step()
    raises ReplicaKilled, and ``_fail_all`` (the scheduler loop's
    handler) fails every request with it."""
    rec = _both(tiny, _kill_replica)
    assert rec["out"] == [("err", "ReplicaKilled")] * 3
    assert rec["stopped"] is True


def test_containment_catches_engine_faults_only(tiny):
    """A dispatch error that is not an EngineFault (a failed kernel
    launch, a CUDA error) is not contained: it escapes step() and the
    scheduler loop stops the engine, failing every request with it."""
    eng = tiny.torch.engine(max_slots=2, page_size=8, n_pages=32, chunk=2)

    def launch_failure(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access")

    eng._decode_step = launch_failure
    eng.start()
    hs = [eng.submit([3, 1, 4], max_new_tokens=8),
          eng.submit([2, 7, 1], max_new_tokens=8)]
    outs = [_outcome(h) for h in hs]
    assert outs == [("err", "RuntimeError",
                     "CUDA error: an illegal memory access")] * 2
    eng._thread.join(timeout=10)
    assert eng.stats["failed_all"] == 1
    assert eng.stats["contained_faults"] == 0
    assert eng.load_report()["stopped"] is True
    tfaults.check_quiesced(eng)


# ---------------------------------------------------------------- shutdown


def _shutdown_readers(side):
    eng = side.engine(max_slots=1, page_size=8, n_pages=32, chunk=2).start()
    outcomes = [None] * 3

    def run(i):
        try:
            outcomes[i] = list(eng.submit([i + 1, i + 2],
                                          max_new_tokens=100).stream())
        except BaseException as e:  # noqa: BLE001 - recorded
            outcomes[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)                 # let the readers block mid-flight
    eng.shutdown()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for out in outcomes:
        assert isinstance(out, (list, side.errors.EngineShutdown)), out
    eng.shutdown()                   # idempotent
    with pytest.raises(side.errors.EngineShutdown):
        eng.submit([1], max_new_tokens=1)
    side.faults.check_quiesced(eng)
    return True


def test_shutdown_unblocks_all_stream_readers(tiny):
    _both(tiny, _shutdown_readers)


def _shutdown_queued(side):
    eng = side.engine(max_slots=1, page_size=8, n_pages=32, chunk=2)
    h = eng.submit([1, 2], max_new_tokens=4)
    eng.shutdown()
    side.faults.check_quiesced(eng)
    return _outcome(h)


def test_shutdown_fails_queued_requests_typed(tiny):
    assert _both(tiny, _shutdown_queued) == ("err", "EngineShutdown",
                                             "engine stopped")


# ---------------------------------------------------- client disconnection


def test_stream_disconnect_cancels_engine_request(tiny):
    """A client abandoning a deployment stream closes the generator,
    which cancels the engine request: its slot and pages free. The
    cancel must win the engine lock between two rounds of a busy
    scheduler thread (the loop yields it). (The JAX half is the
    reference's own case: whether its first token comes out before the
    rest were decoded depends on its compiles.)"""
    # one decode step a round: the cancel lands long before the budget
    # could run out, however the threads are scheduled
    dep = tllm.LlamaDeployment(tl.llama_tiny(dtype=torch.float32), tiny.sd,
                               max_new_tokens=120, max_slots=4, page_size=8,
                               decode_chunk=1, device="cpu")
    gen = dep.stream([3, 1, 4])
    next(gen)                        # the stream is established
    gen.close()                      # the client disconnects
    eng = dep._engine
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with eng._lock:
            settled = (not any(eng.slots) and not eng._fetchq
                       and not eng._pending_prefill)
        if settled and eng.stats["cancelled"] == 1:
            break
        time.sleep(0.01)
    assert eng.stats["cancelled"] == 1, dict(eng.stats)
    tfaults.check_quiesced(eng)
    dep.shutdown()


# ------------------------------------------------------- injector mechanics


def _bounded_times(side):
    inj = side.faults.FaultInjector()
    plan = inj.inject("dispatch_decode", sid=0, times=1)
    eng = side.engine(max_slots=2, page_size=8, n_pages=32, chunk=2,
                      fault_injector=inj)
    h1 = eng.submit([3, 1, 4], max_new_tokens=8)
    _drive(eng)
    out = [_outcome(h1)]
    fired = [plan.fired]
    h2 = eng.submit([2, 7, 1], max_new_tokens=8)   # re-lands on slot 0
    _drive(eng)
    out.append(_outcome(h2))
    fired.append(plan.fired)
    side.faults.check_quiesced(eng)
    return {"out": out, "fired": fired}


def test_injector_bounded_times_allows_recovery(tiny):
    rec = _both(tiny, _bounded_times)
    assert rec["out"][0][:2] == ("err", "RuntimeError")
    assert rec["out"][1] == ("ok", tiny.want([2, 7, 1], 8))
    assert rec["fired"] == [1, 1]


def test_engine_fault_attribution_defaults():
    for mod in (jfaults, tfaults):
        e = mod.EngineFault(RuntimeError("x"), culprit_sid=3, culprit_rid=7)
        assert e.sids == [3] and e.culprit_rid == 7
        e2 = mod.EngineFault(RuntimeError("x"))
        assert e2.sids == [] and e2.culprit_sid is None


def test_fault_plan_matching_equals_the_reference():
    """The same plans fired at the same (site, round, sid) sequence give
    the same log, the same raises and the same exhaustions."""
    def run(mod):
        inj = mod.FaultInjector()
        inj.inject("dispatch_decode", sid=1, round=3, times=2)
        inj.exhaust_alloc(round=2, times=2)
        inj.slow("readback", 0.0, sid=0)
        seen = []
        for rnd in range(1, 6):
            for site, sid in (("step", None), ("dispatch_decode", 0),
                              ("dispatch_decode", 1), ("readback", 0)):
                try:
                    inj.fire(site, rnd, sid, rid=10 + (sid or 0))
                    seen.append(None)
                except mod.EngineFault as e:
                    seen.append((e.culprit_sid, e.culprit_rid, str(e)))
            seen.append(inj.exhausted(rnd))
        return seen, inj.log, [p.fired for p in inj.plans]

    assert run(tfaults) == run(jfaults)


# ---------------------------------------------- classification (errors.py)


def test_classify_http_status_direct():
    for err in (jerr, terr):
        assert err.classify_http_status(err.EngineOverloaded("full")) == 429
        assert err.classify_http_status(err.DeadlineExceeded("late")) == 504
        assert err.classify_http_status(err.EngineShutdown("bye")) == 503
        assert err.classify_http_status(err.RequestCancelled("gone")) == 499
        assert err.classify_http_status(ValueError("nope")) == 500


class GetTimeoutError(Exception):
    """Stands in for the runtime's get-timeout error: the classifier
    matches by name."""


def test_classify_http_status_wrapped_and_stringly():
    for err in (jerr, terr):
        assert err.classify_http_status(GetTimeoutError("slow")) == 504
        outer = RuntimeError("task failed")
        outer.__cause__ = err.DeadlineExceeded("late")
        assert err.classify_http_status(outer) == 504
        wrapper = RuntimeError("boom")
        wrapper.cause = err.EngineOverloaded("full", retry_after_s=3.0)
        assert err.classify_http_status(wrapper) == 429
        assert err.retry_after_s(wrapper) == 3.0
        assert err.classify_http_status(
            RuntimeError("RayTaskError: EngineOverloaded: shed")) == 429


# ------------------------------------------ the wedge: force-kill and fence


def _zombie(side):
    """A scheduler thread wedged inside step() (a hang plan): the report
    still answers, with a growing heartbeat age; a submit sheds after
    ``admit_timeout_s``; force_kill unblocks the consumer typed; the
    released zombie commits no token and leaves the prefix cache as it
    was; a second shutdown() finishes the cleanup."""
    inj = side.faults.FaultInjector()
    eng = side.engine(max_slots=2, page_size=8, n_pages=64, chunk=4,
                      prefix_cache=True, admit_timeout_s=0.5,
                      fault_injector=inj).start()
    eng.submit([3, 1, 4, 1], max_new_tokens=4).result()
    eng.submit([3, 1, 4, 1, 5, 9], max_new_tokens=4).result()
    eng.reset_latency_stats()
    try:
        cached_before = eng.prefix_cache.cached_pages
        inj.hang("step")
        h = eng.submit([7, 1, 8, 2], max_new_tokens=32)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            rpt = eng.load_report()
            took = time.monotonic() - t0
            if rpt["has_work"] and rpt["heartbeat_age_s"] > 0.3:
                break
            time.sleep(0.01)
        else:
            pytest.fail("hang plan never engaged")
        assert took < 0.5              # the lock-free fallback answered
        ages = [rpt["heartbeat_age_s"]]
        time.sleep(0.05)
        ages.append(eng.load_report()["heartbeat_age_s"])
        assert ages[1] > ages[0]
        t0 = time.monotonic()
        with pytest.raises(side.errors.EngineOverloaded) as ei:
            eng.submit([1, 2], max_new_tokens=2)
        assert time.monotonic() - t0 < 2.0
        assert ei.value.retry_after_s == 1.0
        eng.force_kill(side.errors.EngineShutdown("test wedge"))
        with pytest.raises(side.errors.EngineShutdown):
            h.result()
        inj.release_all()
        eng._thread.join(timeout=10.0)
        assert not eng._thread.is_alive(), "released zombie never exited"
        committed = len(h._req.generated)
        assert eng.prefix_cache.cached_pages == cached_before
    finally:
        inj.release_all()
        eng.shutdown()       # the second shutdown: the deferred cleanup
    side.faults.check_quiesced(eng, expect_cached_pages=cached_before)
    return {"committed": committed, "stats": {
        k: eng.stats[k] for k in ("force_killed", "admit_timeouts")},
        "out": _outcome(h)}


def test_released_zombie_is_fenced(tiny):
    rec = _both(tiny, _zombie)
    assert rec["committed"] == 0
    assert rec["stats"] == {"force_killed": 1, "admit_timeouts": 1}
    assert rec["out"] == ("err", "EngineShutdown", "test wedge")


def _wedged_decode(side, want):
    """A wedge at the decode dispatch site, with two streams reading:
    force_kill unblocks both at once, the zombie's dispatch is
    abandoned, and the pages it held come back."""
    inj = side.faults.FaultInjector()
    eng = side.engine(max_slots=4, page_size=8, n_pages=64, chunk=2,
                      prefix_cache=True, fault_injector=inj).start()
    inj.hang("dispatch_decode", round=3)
    prompts = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8])
    hs = [eng.submit(list(p), max_new_tokens=24) for p in prompts]
    seen = [[], []]
    errs = [None, None]

    def read(i):
        try:
            for t in hs[i].stream():
                seen[i].append(t)
        except side.errors.EngineShutdown as e:
            errs[i] = e

    threads = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10.0
    while not any(e[0] == "dispatch_decode" for e in inj.log):
        assert time.monotonic() < deadline, "hang plan never engaged"
        time.sleep(0.005)
    t0 = time.monotonic()
    eng.force_kill()
    for t in threads:
        t.join(timeout=5)
    unblocked = time.monotonic() - t0
    assert not any(t.is_alive() for t in threads) and unblocked < 1.0
    before = [len(s) for s in seen]
    inj.release_all()
    eng._thread.join(timeout=10)
    assert [len(h._req.generated) for h in hs] == before
    eng.shutdown()
    side.faults.check_quiesced(eng)
    # how many tokens were out before the wedge depends on when the
    # device finished; each must be greedy decode's
    prefix = all(h._req.generated == want(p, len(h._req.generated))
                 for h, p in zip(hs, prompts))
    return {"errs": [type(e).__name__ for e in errs], "prefix": prefix}


def test_force_kill_unblocks_readers_of_a_wedged_decode(tiny):
    rec = _both(tiny, _wedged_decode, tiny.want)
    assert rec == {"errs": ["EngineShutdown"] * 2, "prefix": True}


def test_load_report_carries_the_lifecycle_fields(tiny):
    reps = {}
    for pkg in ("jax", "torch"):
        eng = getattr(tiny, pkg).engine(max_slots=2, page_size=8,
                                        n_pages=32, chunk=2,
                                        shed_retry_after_s=3.0)
        reps[pkg] = eng.load_report()
    for key in ("heartbeat_age_s", "shed_retry_after_s", "queue_depth",
                "queue_depth_online", "queue_depth_batch",
                "max_queued_batch", "role"):
        assert key in reps["torch"], key
        if key != "heartbeat_age_s":
            assert reps["torch"][key] == reps["jax"][key], key
    assert reps["torch"]["shed_retry_after_s"] == 3.0
    assert reps["torch"]["heartbeat_age_s"] >= 0.0


def test_admission_knobs_are_validated_like_jax(tiny):
    for kw in ({"admit_timeout_s": 0}, {"admit_timeout_s": -1.0},
               {"max_queued_batch": -1}, {"role": "router"}):
        for pkg in ("jax", "torch"):
            with pytest.raises(ValueError):
                getattr(tiny, pkg).engine(max_slots=1, page_size=8,
                                          n_pages=16, **kw)


def test_chip_smoke_fault_plans_rehearse_on_the_cpu():
    """chip_smoke phase 3's fault and lane plans with the CPU standing in
    for the card: the phase's own checks (every expected failure and
    error type, lifecycle_stats, quiescence, batch-only preemption)
    hold, so a card run fails only where the card differs."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = smoke.phase_engine_faults(tl, 0, card_device="cpu")
    assert res["lone_slot"]["failed"] == {0: "RequestError"}
    assert res["lanes_int8"]["lanes"]["batch_preemptions"] >= 1
