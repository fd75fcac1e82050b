"""The port's overlapped loop (``LLMEngine(overlap=...)``) against its
lockstep loop and the JAX package on the CPU.

``llama_tiny(float32)`` with the flax params of ``PRNGKey(0)`` in both
packages. The overlapped loop plans round N+1 from the frontier read
back so far while round N may still run, so every path that reads
tokens — eos, speculation, the prefix cache, cancellation — must give
the lockstep loop's streams exactly, and the greedy streams of JAX
``generate`` (the JAX engine's, lockstep, for the int8 pool, whose
bytes depend on the write history).

The stale seam. On the CPU a dispatch is finished when it returns, so
``_Readback.ready()`` is always True, the ready-only sweep drains
everything and the planner never sees a stale frontier. The tests that
cover the stale paths (the eos cap, late-eos truncation, speculation
from a stale plan, cancel mid-round, the pipeline depth) report every
buffer as not ready, as on a card whose newest dispatch is still
running: the pre-plan sweep then reads nothing, each round is planned
with the previous dispatch undrained (``SlotView.stale`` > 0), and the
trailing drain blocks on the older of two dispatches. The seam lives in
the tests; the engine has none. Every engine ends leak-free.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import scheduler as jsched
from ray_tpu.serve.engine import LLMEngine as JEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import scheduler as tsched
from ray_tpu_torch.serve.engine import LLMEngine
from ray_tpu_torch.serve.errors import RequestCancelled

REP_PROMPT = ([7, 8, 9, 10] * 6)[:20]
_REF_TOKENS = 28


@pytest.fixture(scope="module")
def tiny():
    """(flax model, flax params, torch model, reference(prompt, n))."""
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
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
                              max_new_tokens=_REF_TOKENS, temperature=0.0)
            cache[key] = np.asarray(out)[0, len(prompt):].tolist()
        assert n <= _REF_TOKENS
        return cache[key][:n]

    return jmodel, params, model, reference


@pytest.fixture(autouse=True)
def _no_page_leaks(monkeypatch):
    """Every engine built in a test ends with every page free or held by
    its prefix cache: an overlapped round that loses an undrained
    rider's pages shows here, with the leaked ids."""
    created = []
    orig = LLMEngine.__init__

    def record(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        created.append(self)

    monkeypatch.setattr(LLMEngine, "__init__", record)
    yield
    for eng in created:
        cached = (eng.prefix_cache.cached_pages
                  if eng.prefix_cache is not None else 0)
        assert eng.alloc.occupancy() == cached, (
            f"engine leaked pages: {sorted(eng.alloc.leak_report())[:16]}")


@pytest.fixture
def stale(monkeypatch):
    """The stale seam: every readback reports not ready, and each plan's
    largest ``SlotView.stale`` is recorded (returned list)."""
    monkeypatch.setattr(teng._Readback, "ready", lambda self: False)
    seen = []
    real = teng.plan_step

    def spy(views, **kw):
        seen.append(max((v.stale for v in views), default=0))
        return real(views, **kw)

    monkeypatch.setattr(teng, "plan_step", spy)
    return seen


def _serve(eng, waves, n):
    out = []
    for wave in waves:
        hs = [eng.submit(list(p), max_new_tokens=n) for p in wave]
        while eng.step():
            pass
        out += [h.result() for h in hs]
    return out


# ------------------------------------------------------- knob resolution


@pytest.mark.parametrize("env", [None, "0", "1", "bogus"])
@pytest.mark.parametrize("kwarg", [None, False, True])
def test_overlap_knob_resolves_as_reference(tiny, monkeypatch, env, kwarg):
    """Default on; ``RAY_TPU_OVERLAP=0/1`` beats the keyword; any other
    value is ignored — as the JAX engine resolves it."""
    jmodel, params, model, _ = tiny
    if env is None:
        monkeypatch.delenv("RAY_TPU_OVERLAP", raising=False)
    else:
        monkeypatch.setenv("RAY_TPU_OVERLAP", env)
    kw = dict(max_slots=1, page_size=8, n_pages=16, overlap=kwarg)
    ours = LLMEngine(model, device="cpu", **kw).overlap
    assert ours == JEngine(jmodel, params, **kw).overlap
    assert ours is ({"0": False, "1": True}.get(env)
                    if env in ("0", "1") else kwarg is not False)


# ----------------------------------------------------- planner stale cap


_CAP = dict(total_slots=2, prefill_budget=16, decode_chunk=4,
            max_run_ahead=128, prefill_batch=4, eos_bounded=True)
_STALE_CASES = {
    # fresh riders: the eos bound is 2 decode chunks
    "fresh": ([dict(stale=0), dict(stale=0)], _CAP, 8),
    # one stale rider caps the dispatch at one chunk
    "stale_rider": ([dict(stale=4), dict(stale=0)], _CAP, 4),
    # without an eos nothing is discarded: run ahead to completion
    "no_eos": ([dict(stale=4, owed=24), dict(stale=4, owed=24)],
               dict(_CAP, eos_bounded=False), 24),
    # spec mode with no proposal: quick cadence, and the stale cap
    "spec_quick_stale": ([dict(stale=4), dict(stale=0)],
                         dict(_CAP, spec_enabled=True), 4),
}


@pytest.mark.parametrize("name", sorted(_STALE_CASES))
def test_stale_cap_matches_reference_planner(name):
    rows, kw, want = _STALE_CASES[name]
    rows = [dict(dict(owed=50), sid=i, admit_seq=i, prompt_remaining=0,
                 seeded=True, **r) for i, r in enumerate(rows)]
    ours = tsched.plan_step([tsched.SlotView(**r) for r in rows], **kw)
    ref = jsched.plan_step([jsched.SlotView(**r) for r in rows], **kw)
    assert ours.decode_steps == ref.decode_steps == want
    assert ours.prefill == () and ours.spec == ref.spec == ()


# --------------------------------------------------------- token parity


def _mid_stream_eos(stream, start=4):
    """The first id from ``start`` on that does not occur before it."""
    return next(t for i, t in enumerate(stream)
                if i >= start and t not in stream[:i])


def _cases(reference):
    """name -> (engine kwargs, waves, new tokens)."""
    g = np.random.default_rng(7)
    # one prompt length: one compile of the JAX reference
    rand = [g.integers(1, 255, size=9).tolist() for _ in range(4)]
    eos_prompt = [5, 9, 2]
    return {
        # the eos revealed a round late: emission truncates where the
        # lockstep loop does
        "plain_eos": (dict(max_slots=2, n_pages=32,
                           eos_id=_mid_stream_eos(reference(eos_prompt,
                                                            16))),
                      [[eos_prompt, [3, 1, 4, 1, 5]]], 16),
        # an eos that never comes: every slot runs to budget through the
        # stale-frontier planner
        "eos_bounded_to_budget": (dict(max_slots=2, n_pages=64, eos_id=-1),
                                  [rand], 20),
        # no eos at all: the overlapped loop is the opportunistic one
        "no_eos": (dict(max_slots=2, n_pages=64), [rand[:3]], 16),
        # speculation planned from a stale frontier
        "spec_eos": (dict(max_slots=2, n_pages=64, spec_len=4,
                          spec_ngram=2, eos_id=188),
                     [[REP_PROMPT, [9, 8, 9, 8]]], 24),
        # a cache-hit admission enters mid-prompt behind undrained
        # neighbours
        "prefix_cache_resume": (dict(max_slots=2, n_pages=32,
                                     prefix_cache=True, eos_id=-1),
                                [[REP_PROMPT + [3, 1]],
                                 [REP_PROMPT + [4, 2]]], 16),
    }


@pytest.mark.parametrize("seam", [False, True], ids=["ready", "stale"])
@pytest.mark.parametrize("name", ["plain_eos", "eos_bounded_to_budget",
                                  "no_eos", "spec_eos",
                                  "prefix_cache_resume"])
def test_overlapped_streams_equal_lockstep(tiny, request, name, seam):
    _, _, model, reference = tiny
    kw, waves, n = _cases(reference)[name]
    kw = dict(kw, page_size=8, chunk=4)
    lock = LLMEngine(model, device="cpu", overlap=False, **kw)
    want = _serve(lock, waves, n)
    seen = request.getfixturevalue("stale") if seam else []
    over = LLMEngine(model, device="cpu", overlap=True, **kw)
    assert _serve(over, waves, n) == want
    for p, got in zip((p for w in waves for p in w), want):
        full = reference(p, n)
        eos = kw.get("eos_id")
        assert got == full[:full.index(eos) + 1 if eos in full else n]
    if seam:
        # the stale paths ran: plans saw undrained steps...
        assert max(seen) > 0
        if name == "plain_eos":
            # ...and the eos was revealed after more decode steps had
            # been dispatched than the lockstep loop needed
            assert (over.stats["decode_steps"]
                    > lock.stats["decode_steps"])
    if kw.get("spec_len"):
        assert over.spec_stats()["rounds"] > 0
        assert lock.spec_stats()["rounds"] > 0
    if kw.get("prefix_cache"):
        assert over.stats["cache_hit_admissions"] == 1
        over.prefix_cache.check_invariants()


def test_int8_overlapped_streams_equal_jax_engine(tiny, stale):
    """The int8 pool's bytes depend on the write history, so the JAX
    engine (lockstep) is the reference: an eos mid-stream, stale
    plans."""
    jmodel, params, model, reference = tiny
    prompts = [[5, 9, 2], [2, 7, 1, 8], REP_PROMPT]
    kw = dict(max_slots=2, page_size=8, n_pages=64, chunk=4,
              kv_dtype="int8",
              eos_id=_mid_stream_eos(reference([5, 9, 2], 16)))
    want = _serve(JEngine(jmodel, params, overlap=False, **kw),
                  [prompts], 16)
    for overlap in (False, True):
        assert _serve(LLMEngine(model, device="cpu", overlap=overlap, **kw),
                      [prompts], 16) == want
    assert max(stale) > 0


# --------------------------------------------------- pipeline mechanics


def test_cancel_mid_round_with_undrained_dispatch(tiny, stale):
    """Cancel while a dispatch carrying the victim is undrained: its
    slot and pages free at once, the late readback skips it, the
    survivor stays exact."""
    _, _, model, reference = tiny
    p1, p2 = [3, 1, 4, 1, 5], [2, 7, 1, 8]
    eng = LLMEngine(model, device="cpu", max_slots=2, page_size=8,
                    n_pages=64, chunk=4, eos_id=-1, overlap=True)
    h1 = eng.submit(p1, max_new_tokens=24)
    h2 = eng.submit(p2, max_new_tokens=24)
    for _ in range(64):
        eng.step()
        if (eng.slots[1] is not None and eng.slots[1].req is h2._req
                and any(slot.req is h2._req
                        for _rb, riders, _s in eng._fetchq
                        for _i, slot, _t in riders)):
            break
    else:
        raise AssertionError("the pipeline never held the victim")
    assert h2.cancel() is True
    assert eng.slots[1] is None
    while eng.step():
        pass
    assert h1.result() == reference(p1, 24)
    with pytest.raises(RequestCancelled):
        h2.result()
    assert eng.stats["cancelled"] == 1


def test_pipeline_depth_reaches_two_and_never_more(tiny, stale):
    """Right after a decode dispatch the report shows two dispatches in
    flight; between steps, and at idle, never more than that."""
    _, _, model, _ = tiny
    eng = LLMEngine(model, device="cpu", max_slots=2, page_size=8,
                    n_pages=64, chunk=4, eos_id=-1, overlap=True)
    assert eng.load_report()["overlap"] is True
    depths = []
    dispatch = eng._dispatch_chunk_locked

    def probe(steps):
        dispatch(steps)
        depths.append(eng._report_locked()["fetchq_depth"])

    eng._dispatch_chunk_locked = probe
    hs = [eng.submit([5, 9, 2, 7], max_new_tokens=32),
          eng.submit([1, 8, 3], max_new_tokens=32)]
    while eng.step():
        rep = eng.load_report()
        assert rep["fetchq_depth"] <= 2
        if rep["fetchq_depth"]:
            assert not eng.is_idle()     # undrained tokens are work
    assert max(depths) == 2
    assert all(len(h.result()) == 32 for h in hs)
    rep = eng.load_report()
    assert rep["fetchq_depth"] == 0 and rep["pending_prefills"] == 0
    assert eng.is_idle()
