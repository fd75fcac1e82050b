"""The port's priority lanes and replica roles against the JAX package's,
on the CPU.

- The engine cases of tests/test_batch_tier.py (the lane contract): an
  unknown priority, the per-lane queue depths and admission bounds, an
  online request admitted before an earlier batch one, the batch lane
  draining alone, an online burst that preempts batch slots with every
  stream token-identical, and batch TTFTs kept out of the SLO signal.
  Each runs the same script through both packages' ``LLMEngine``
  (``llama_tiny`` fp32, the flax params of PRNGKey(0), ``overlap=False``)
  and the records (outcomes, counters, reports) must be EQUAL, every
  stream equal to JAX ``generate``.
- The planner: ``plan_step``'s lane order and ``role_plan_caps`` held to
  the JAX scheduler on seeded random ``SlotView`` sets.
- An engine per replica role, streams and dispatch counts equal to
  JAX's; ``submit_rollout_batch``.
- ``LlamaDeployment``'s dict payloads and lifecycle knobs, against the
  JAX deployment.
"""
import dataclasses
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
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import scheduler as jsched
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import faults as tfaults
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import scheduler as tsched

PROMPTS = [[5, 9, 2], [7, 11, 3, 1], [2, 4, 6, 8, 10], [9, 1],
           [3, 3, 5, 7], [12, 2, 9, 4, 1, 6]]
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

    knobs = dict(max_slots=2, page_size=8, n_pages=32, chunk=4,
                 temperature=0.0, eos_id=-1, seed=0, overlap=False)

    def jax_engine(**kw):
        return jeng.LLMEngine(jmodel, params, **{**knobs, **kw})

    def torch_engine(**kw):
        return teng.LLMEngine(tmodel, device="cpu", **{**knobs, **kw})

    return types.SimpleNamespace(
        jax=types.SimpleNamespace(engine=jax_engine, errors=jerr,
                                  faults=jfaults),
        torch=types.SimpleNamespace(engine=torch_engine, errors=terr,
                                    faults=tfaults),
        want=want, sd=sd)


def _drive(eng):
    for _ in range(5000):
        if not eng.step():
            return
    raise AssertionError("engine did not quiesce")


def _both(tiny, case, *args):
    rec = {pkg: case(getattr(tiny, pkg), *args) for pkg in ("jax", "torch")}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


# -------------------------------------------------------------- lane basics


def _unknown_priority(side):
    eng = side.engine()
    with pytest.raises(side.errors.RequestError) as ei:
        eng.submit([1, 2, 3], max_new_tokens=4, priority="urgent")
    return str(ei.value)


def test_submit_rejects_unknown_priority(tiny):
    assert "unknown priority 'urgent'" in _both(tiny, _unknown_priority)


def _lane_depths(side):
    eng = side.engine()
    eng.submit([1, 2, 3], max_new_tokens=4)
    eng.submit([4, 5], max_new_tokens=4, priority="batch")
    eng.submit([6, 7], max_new_tokens=4, priority="batch")
    rpt = eng.load_report()
    _drive(eng)
    return {k: rpt[k] for k in ("queue_depth", "queue_depth_online",
                                "queue_depth_batch", "max_queued_batch")}


def test_per_lane_queue_depth_report(tiny):
    """``queue_depth`` is the ONLINE lane; batch backlog is its own."""
    assert _both(tiny, _lane_depths) == {
        "queue_depth": 1, "queue_depth_online": 1, "queue_depth_batch": 2,
        "max_queued_batch": None}


def _lane_bounds(side):
    eng = side.engine(max_queued=1, max_queued_batch=2)
    eng.submit([1, 2], max_new_tokens=4)
    eng.submit([3, 4], max_new_tokens=4, priority="batch")
    eng.submit([5, 6], max_new_tokens=4, priority="batch")
    sheds = []
    for prompt, prio in (([7, 8], "batch"), ([9, 10], "online")):
        with pytest.raises(side.errors.EngineOverloaded) as ei:
            eng.submit(prompt, max_new_tokens=4, priority=prio)
        sheds.append(str(ei.value))
    _drive(eng)
    return {"sheds": sheds, "shed": eng.stats["shed"]}


def test_per_lane_admission_bounds(tiny):
    """A deep batch backlog never sheds online traffic, and each lane
    sheds against its own bound."""
    rec = _both(tiny, _lane_bounds)
    assert rec["shed"] == 2
    assert "max_queued_batch=2" in rec["sheds"][0]
    assert "max_queued=1" in rec["sheds"][1]


def _online_first(side):
    eng = side.engine(max_slots=1)
    hb = eng.submit(PROMPTS[0], max_new_tokens=6, priority="batch")
    hb2 = eng.submit(PROMPTS[1], max_new_tokens=6, priority="batch")
    ho = eng.submit(PROMPTS[2], max_new_tokens=6)
    eng.step()
    first = eng.slots[0].req.rid
    _drive(eng)
    return {"first": first, "online": ho._req.rid,
            "out": [h.result() for h in (hb, hb2, ho)]}


def test_online_admits_before_earlier_batch(tiny):
    rec = _both(tiny, _online_first)
    assert rec["first"] == rec["online"]
    assert rec["out"] == [tiny.want(p, 6) for p in PROMPTS[:3]]


def _batch_alone(side):
    eng = side.engine()
    hs = [eng.submit(p, max_new_tokens=8, priority="batch")
          for p in PROMPTS]
    _drive(eng)
    out = [h.result() for h in hs]
    return {"out": out, "batch_tokens": eng.stats["batch_tokens"]}


def test_starvation_guard_batch_drains_when_online_idle(tiny):
    rec = _both(tiny, _batch_alone)
    assert rec["out"] == [tiny.want(p, 8) for p in PROMPTS]
    assert rec["batch_tokens"] == 8 * len(PROMPTS)


# --------------------------------------------------------- preemption parity


def _online_burst(side):
    eng = side.engine(max_slots=2)
    batch_hs = [eng.submit(p, max_new_tokens=40, priority="batch")
                for p in PROMPTS[:2]]
    for _ in range(2):               # the batch slots seed and decode
        eng.step()
    online_hs = [eng.submit(p, max_new_tokens=12) for p in PROMPTS[2:4]]
    _drive(eng)
    side.faults.check_quiesced(eng)
    return {"out": [h.result() for h in batch_hs + online_hs],
            "stats": {k: eng.stats[k] for k in (
                "preemptions", "batch_preemptions", "batch_tokens")}}


def test_online_burst_preempts_batch_token_identical(tiny):
    """Batch fills every slot; an online burst arrives mid-decode and
    preempts the youngest batch slots (never an online one: every
    preemption is a batch one), and each preempted request resumes
    token-identical after recompute."""
    rec = _both(tiny, _online_burst)
    assert rec["out"] == ([tiny.want(p, 40) for p in PROMPTS[:2]]
                          + [tiny.want(p, 12) for p in PROMPTS[2:4]])
    assert rec["stats"]["batch_preemptions"] >= 1
    assert rec["stats"]["preemptions"] == rec["stats"]["batch_preemptions"]
    assert rec["stats"]["batch_tokens"] == 80


def _batch_ttft(side):
    eng = side.engine()
    hb = eng.submit(PROMPTS[0], max_new_tokens=4, priority="batch")
    _drive(eng)
    hb.result()
    after_batch = (len(eng.ttfts_s), eng.load_report()["ttft_ewma_s"])
    ho = eng.submit(PROMPTS[1], max_new_tokens=4)
    _drive(eng)
    ho.result()
    return {"after_batch": after_batch, "after_online": len(eng.ttfts_s),
            "itl_none": eng.load_report()["itl_ewma_s"] is None}


def test_batch_ttft_excluded_from_online_slo_signal(tiny):
    rec = _both(tiny, _batch_ttft)
    assert rec["after_batch"] == (0, None)
    assert rec["after_online"] == 1


def _rollout_batch(side):
    eng = side.engine(max_slots=2)
    hs = eng.submit_rollout_batch(PROMPTS[:4], max_new_tokens=6,
                                  trace_id="run7")
    lanes = [(h._req.batch, h._req.trace_id) for h in hs]
    ho = eng.submit(PROMPTS[4], max_new_tokens=6)
    eng.step()
    seated = sorted(s.req.rid for s in eng.slots if s is not None)
    _drive(eng)
    return {"lanes": lanes, "online_seated": ho._req.rid in seated,
            "out": [h.result() for h in hs + [ho]],
            "batch_tokens": eng.stats["batch_tokens"]}


def test_submit_rollout_batch_queues_batch_lane_requests(tiny):
    rec = _both(tiny, _rollout_batch)
    assert rec["lanes"] == [(True, f"run7:{i}") for i in range(4)]
    assert rec["online_seated"]
    assert rec["out"] == [tiny.want(p, 6) for p in PROMPTS[:5]]
    assert rec["batch_tokens"] == 24


def _deadline_on_batch(side):
    eng = side.engine(max_slots=1)
    ho = eng.submit(PROMPTS[0], max_new_tokens=30)
    hb = eng.submit(PROMPTS[1], max_new_tokens=4, priority="batch",
                    deadline_s=0.01)
    time.sleep(0.03)
    _drive(eng)
    try:
        hb.result()
        err = None
    except side.errors.RequestError as e:
        err = type(e).__name__
    return {"online": ho.result(), "batch": err,
            "expired": eng.stats["deadline_exceeded"]}


def test_batch_request_deadline_expires_while_queued(tiny):
    rec = _both(tiny, _deadline_on_batch)
    assert rec == {"online": tiny.want(PROMPTS[0], 30),
                   "batch": "DeadlineExceeded", "expired": 1}


# ----------------------------------------------------------------- planner


def _random_views(g, mod, n):
    views = []
    for sid in range(n):
        seeded = bool(g.integers(0, 2))
        views.append(mod.SlotView(
            sid=sid, admit_seq=int(g.integers(0, 50)),
            prompt_remaining=0 if seeded else int(g.integers(0, 300)),
            owed=int(g.integers(0, 40)) if seeded else 0, seeded=seeded,
            spec_drafts=int(g.integers(0, 3)),
            stale=int(g.integers(0, 2)), pulling=bool(g.integers(0, 6) == 0),
            batch=bool(g.integers(0, 2))))
    return views


@pytest.mark.parametrize("seed", range(4))
def test_plan_step_lanes_and_role_caps_equal_the_reference(seed):
    """Seeded random slot sets through both planners, each role's caps
    applied as the engines apply them: the same plans."""
    g = np.random.default_rng(seed)
    for _ in range(60):
        n = int(g.integers(0, 9))
        total = max(n, int(g.integers(1, 9)))
        state = g.bit_generator.state
        tv = _random_views(g, tsched, n)
        g.bit_generator.state = state
        jv = _random_views(g, jsched, n)
        role = str(g.choice(["unified", "prefill", "decode"]))
        knobs = dict(page_size=int(g.choice([8, 16, 64])),
                     decode_chunk=int(g.integers(1, 9)),
                     prefill_budget=int(g.integers(1, 512)),
                     max_run_ahead=int(g.integers(1, 160)))
        caps = tsched.role_plan_caps(role, **knobs)
        assert caps == jsched.role_plan_caps(role, **knobs)
        kw = dict(total_slots=total, prefill_budget=caps["prefill_budget"],
                  decode_chunk=knobs["decode_chunk"],
                  max_run_ahead=caps["max_run_ahead"],
                  prefill_batch=int(g.integers(1, 5)),
                  eos_bounded=bool(g.integers(0, 2)),
                  spec_enabled=bool(g.integers(0, 2)))
        tp, jp = tsched.plan_step(tv, **kw), jsched.plan_step(jv, **kw)
        assert dataclasses.astuple(tp) == dataclasses.astuple(jp)


def test_prefill_grants_put_online_slots_first():
    views = [tsched.SlotView(sid=0, admit_seq=0, prompt_remaining=200,
                             owed=0, seeded=False, batch=True),
             tsched.SlotView(sid=1, admit_seq=5, prompt_remaining=100,
                             owed=0, seeded=False),
             tsched.SlotView(sid=2, admit_seq=3, prompt_remaining=100,
                             owed=0, seeded=False, batch=True)]
    plan = tsched.plan_step(views, total_slots=4, prefill_budget=256,
                            decode_chunk=4, max_run_ahead=128,
                            prefill_batch=4, eos_bounded=False)
    assert [(g.sid, g.tokens) for g in plan.prefill] == [(1, 100),
                                                         (0, 156)]


def test_role_plan_caps_constants_and_validation():
    assert tsched.REPLICA_ROLES == jsched.REPLICA_ROLES
    assert (tsched.LANE_ONLINE, tsched.LANE_BATCH) == (
        jsched.LANE_ONLINE, jsched.LANE_BATCH)
    for mod in (tsched, jsched):
        with pytest.raises(ValueError):
            mod.role_plan_caps("router", page_size=8, decode_chunk=4,
                               prefill_budget=256, max_run_ahead=128)


# ------------------------------------------------------------------- roles


def _role_engine(side, role):
    eng = side.engine(max_slots=4, n_pages=64, chunk=2, prefill_chunk=64,
                      role=role, eos_id=None)
    prompts = [list(range(1, 41)), PROMPTS[2], PROMPTS[5]]
    hs = [eng.submit(p, max_new_tokens=20) for p in prompts]
    _drive(eng)
    return {"out": [h.result() for h in hs], "role":
            eng.load_report()["role"],
            "stats": {k: eng.stats[k] for k in (
                "prefills", "prefill_tokens", "chunks", "decode_steps")}}


@pytest.mark.parametrize("role", ["unified", "prefill", "decode"])
def test_engine_per_role_equals_jax(tiny, role):
    """A prefill replica runs ahead one decode chunk at most, a decode
    replica prefills one page plus one token a round: the same rounds,
    counted, and the same streams as the JAX engine."""
    rec = _both(tiny, _role_engine, role)
    prompts = [list(range(1, 41)), PROMPTS[2], PROMPTS[5]]
    assert rec["out"] == [tiny.want(p, 20) for p in prompts]
    assert rec["role"] == role
    if role == "decode":
        assert rec["stats"]["prefills"] >= 40 // 9


# -------------------------------------------------------------- deployment


def test_deployment_dict_payloads_and_knobs_equal_jax(tiny):
    cfg = tl.llama_tiny(dtype=torch.float32)
    kw = dict(max_new_tokens=6, max_slots=4, page_size=8, deadline_s=30.0,
              max_queued=8, max_retries=1, retry_backoff_s=0.01,
              engine_stall_deadline_s=5.0)
    deps = {"jax": jllm.LlamaDeployment(jl.llama_tiny(dtype=jnp.float32),
                                        **kw),
            "torch": tllm.LlamaDeployment(cfg, tiny.sd, device="cpu", **kw)}
    rec = {}
    for pkg, dep in deps.items():
        assert dep.load_report() is None
        r = {"call_list": dep([5, 9, 2]),
             "call_dict": dep({"prompt_ids": [7, 11, 3, 1],
                               "max_new_tokens": 4, "session_id": "u1",
                               "trace_id": "t-1"}),
             "call_prompt": dep({"prompt": [9, 1], "deadline_s": 10}),
             "stream": list(dep.stream({"prompt_ids": [2, 4, 6],
                                        "max_new_tokens": 3})),
             "batch": dep.generate_batch([[3, 3, 5, 7], [12, 2, 9]])}
        eng = dep._engine
        r["knobs"] = (eng.max_queued, eng.max_retries, eng.retry_backoff_s,
                      eng.admit_timeout_s)
        stats = dep.serve_stats()["engine"]
        r["stats"] = {k: stats[k] for k in (
            "submitted", "slots_live", "slots_total", "max_queued",
            "max_retries", "retry_backoff_s")}
        rpt = dep.load_report()
        assert "prefix_digest" not in rpt
        r["report"] = {k: rpt[k] for k in ("queue_depth", "max_queued",
                                           "role", "total_slots")}
        with pytest.raises(ValueError):
            dep({"max_new_tokens": 3})
        if pkg == "torch":
            dep.shutdown()
        else:
            eng.shutdown()
        rec[pkg] = r
    assert rec["torch"] == rec["jax"]
    assert rec["torch"]["call_dict"] == [7, 11, 3, 1] + tiny.want(
        [7, 11, 3, 1], 4)
    assert rec["torch"]["stream"] == tiny.want([2, 4, 6], 3)
    assert rec["torch"]["knobs"] == (8, 1, 0.01, 5.0)


def test_deployment_deadline_default_applies_to_list_payloads(tiny):
    """The deployment-wide ``deadline_s`` reaches the engine for a plain
    list payload, and a dict's ``deadline_s`` overrides it."""
    dep = tllm.LlamaDeployment(tl.llama_tiny(dtype=torch.float32), tiny.sd,
                               max_new_tokens=4, max_slots=2, page_size=8,
                               deadline_s=7.5, device="cpu")
    assert dep._request_args([1, 2])[2] == 7.5
    assert dep._request_args({"prompt_ids": [1, 2],
                              "deadline_s": 2})[2] == 2.0
    ids, h = dep._submit([1, 2])
    assert h._req.deadline - h._req.t_submit == pytest.approx(7.5)
    h.result()
    dep.shutdown()


@pytest.mark.parametrize("bad", [0, -1.0])
def test_deployment_rejects_a_non_positive_stall_deadline(tiny, bad):
    for make in (lambda: jllm.LlamaDeployment(
                     jl.llama_tiny(dtype=jnp.float32),
                     engine_stall_deadline_s=bad),
                 lambda: tllm.LlamaDeployment(
                     tl.llama_tiny(dtype=torch.float32), tiny.sd,
                     engine_stall_deadline_s=bad, device="cpu")):
        with pytest.raises(ValueError, match="engine_stall_deadline_s"):
            make()
