"""The port's speculative decoding (ray_tpu_torch.serve.spec_decode and
the engine's spec lane) against the JAX package's on the CPU.

- ``NGramIndex``: the port's copy proposes what
  ``ray_tpu.serve.spec_decode.NGramIndex`` proposes after the same
  syncs, and refuses what it refuses.
- The planner's spec lane: the port's ``plan_step`` returns the
  reference's plan on the same snapshots (the cases of
  tests/test_spec_decode.py, with their expected plans).
- The engine: ``llama_tiny(float32)`` with the flax params of
  ``PRNGKey(0)`` (carried over by ``flax_state_dict``) in both packages.
  Each scenario of tests/test_spec_decode.py (and
  tests/test_kv_quant.py::test_spec_accept_rate_survives_int8) runs the
  same submits through the JAX ``LLMEngine`` (lockstep,
  ``overlap=False``) and through the port's engine in both loops:
  greedy streams IDENTICAL (no tolerance; fp32 logits agree to ~1e-6
  and argmax ties break the same way), and under the lockstep loop the
  ``spec_stats()`` counters equal JAX's. Under the overlapped loop the
  proposals depend on what was read back when, so only the streams
  must match. Every engine ends leak-free.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import scheduler as jsched
from ray_tpu.serve import spec_decode as jspec
from ray_tpu.serve.engine import LLMEngine as JEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import scheduler as tsched
from ray_tpu_torch.serve import spec_decode as tspec
from ray_tpu_torch.serve.engine import LLMEngine
from ray_tpu_torch.serve.errors import RequestCancelled

REP_PROMPT = ([7, 8, 9, 10] * 6)[:20]
_REF_TOKENS = 28


@pytest.fixture(scope="module")
def tiny():
    """(flax model, flax params, torch model, reference(prompt, n)):
    ``reference`` is JAX greedy ``generate``, one call per prompt."""
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
    """Every port engine built in a test ends with every page free or
    held by its prefix cache (leaked page ids are named)."""
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


def _serve(eng, waves, n):
    """Each wave submitted after the previous one finished; the
    streams of all waves in order."""
    out = []
    for wave in waves:
        hs = [eng.submit(list(p), max_new_tokens=n) for p in wave]
        while eng.step():
            pass
        out += [h.result() for h in hs]
    return out


# ------------------------------------------------------ n-gram proposer


def _ngram_cases():
    g = np.random.default_rng(3)
    cases = [(2, [[1, 2, 3, 1, 2]]),
             (3, [[1, 2], [1, 2, 3, 4]]),
             (2, [[5, 6, 5], [5, 6, 5, 6, 5, 6, 7]]),
             (1, [[4, 4, 4, 9, 4]])]
    for n in (1, 2, 3, 4):
        seq = g.integers(0, 6, 80).tolist()     # small alphabet: repeats
        cuts = sorted(g.choice(np.arange(1, 80), 5, replace=False))
        cases.append((n, [seq[:c] for c in cuts] + [seq]))
    return cases


@pytest.mark.parametrize("n,syncs", _ngram_cases())
def test_ngram_index_matches_reference(n, syncs):
    ours, ref = tspec.NGramIndex(n), jspec.NGramIndex(n)
    for ctx in syncs:
        ours.sync(ctx)
        ref.sync(ctx)
        assert len(ours) == len(ref)
        for k in range(0, 6):
            assert ours.propose(k) == ref.propose(k), (ctx, k)
    # a context can never shrink, in both
    if len(syncs[-1]) > 1:
        for idx in (ours, ref):
            with pytest.raises(ValueError):
                idx.sync(syncs[-1][:-1])


def test_ngram_named_cases_and_validation():
    idx = tspec.NGramIndex(2)
    idx.sync([1, 2, 3, 1, 2])
    assert idx.propose(3) == [3, 1, 2] and idx.propose(1) == [3]
    short = tspec.NGramIndex(3)
    short.sync([1, 2])
    assert short.propose(4) == []
    for mod in (tspec, jspec):
        with pytest.raises(ValueError):
            mod.NGramIndex(0)


# ------------------------------------------------------ planner spec lane


_PLAN = dict(total_slots=4, prefill_budget=16, decode_chunk=4,
             max_run_ahead=128, prefill_batch=4, eos_bounded=False,
             spec_enabled=True)


def _views(*rows):
    return [dict(sid=i, admit_seq=i, **r) for i, r in enumerate(rows)]


_SEEDED = dict(prompt_remaining=0, seeded=True)
_PLANNER_CASES = {
    # the lanes are exclusive; zero-draft slots ride the verify
    "spec_replaces_decode": (
        _views(dict(_SEEDED, owed=50, spec_drafts=3),
               dict(_SEEDED, owed=50, spec_drafts=0)),
        dict(_PLAN, total_slots=2), ((), 0, ((0, 3), (1, 0)))),
    # no proposal: quick cadence, not run-ahead
    "no_proposal_quick_decode": (
        _views(dict(_SEEDED, owed=50), dict(_SEEDED, owed=50)),
        dict(_PLAN, total_slots=2), ((), 4, ())),
    # drafts clamped to owed - 1 and max_run_ahead - 1
    "clamps": (
        _views(dict(_SEEDED, owed=2, spec_drafts=8),
               dict(_SEEDED, owed=50, spec_drafts=8)),
        dict(_PLAN, total_slots=2, max_run_ahead=4),
        ((), 0, ((0, 1), (1, 3)))),
    # the prefill lane is planned first
    "never_starves_prefill": (
        _views(dict(prompt_remaining=40, owed=0, seeded=False),
               dict(_SEEDED, owed=50, spec_drafts=4)),
        _PLAN, (((0, 16),), 0, ((1, 4),))),
    "disabled_ignores_drafts": (
        _views(dict(_SEEDED, owed=50, spec_drafts=4)),
        dict(_PLAN, spec_enabled=False), None),
    # spec with an eos and a stale rider
    "eos_stale_spec": (
        _views(dict(_SEEDED, owed=30, spec_drafts=2, stale=4),
               dict(_SEEDED, owed=0, spec_drafts=0)),
        dict(_PLAN, eos_bounded=True), ((), 0, ((0, 2), (1, 0)))),
}


def _as_tuple(plan):
    return (tuple((g.sid, g.tokens) for g in plan.prefill),
            plan.decode_steps, tuple((g.sid, g.drafts) for g in plan.spec))


@pytest.mark.parametrize("name", sorted(_PLANNER_CASES))
def test_spec_lane_matches_reference_planner(name):
    rows, kw, want = _PLANNER_CASES[name]
    ours = tsched.plan_step([tsched.SlotView(**r) for r in rows], **kw)
    ref = jsched.plan_step([jsched.SlotView(**r) for r in rows], **kw)
    assert _as_tuple(ours) == _as_tuple(ref)
    assert ours.idle == ref.idle
    if want is not None:
        assert _as_tuple(ours) == want
    else:
        assert ours.spec == () and ours.decode_steps > 0


@pytest.mark.parametrize("seed", range(4))
def test_random_snapshots_plan_as_reference(seed):
    """Random slot snapshots, every knob mix: the same plan."""
    g = np.random.default_rng(seed)
    for _ in range(50):
        n = int(g.integers(1, 6))
        rows = []
        for i in range(n):
            seeded = bool(g.integers(0, 2))
            rows.append(dict(
                sid=i, admit_seq=int(g.integers(0, 100)),
                prompt_remaining=0 if seeded else int(g.integers(0, 60)),
                owed=int(g.integers(-2, 40)) if seeded else 0,
                seeded=seeded, spec_drafts=int(g.integers(0, 6)),
                stale=int(g.integers(0, 3)) * 4))
        kw = dict(total_slots=int(g.integers(n, n + 3)),
                  prefill_budget=int(g.integers(1, 64)),
                  decode_chunk=int(g.integers(1, 8)),
                  max_run_ahead=int(g.integers(1, 64)),
                  prefill_batch=int(g.integers(1, 5)),
                  eos_bounded=bool(g.integers(0, 2)),
                  spec_enabled=bool(g.integers(0, 2)))
        ours = tsched.plan_step([tsched.SlotView(**r) for r in rows], **kw)
        ref = jsched.plan_step([jsched.SlotView(**r) for r in rows], **kw)
        assert _as_tuple(ours) == _as_tuple(ref), (rows, kw)


# ------------------------------------------------------ engine parity


class _Scripted:
    """Proposer seam: proposes a fixed continuation script keyed on how
    many tokens the slot has generated. The oracle scripts the true
    greedy completion, the anti-oracle guaranteed-wrong tokens."""

    def __init__(self, prompt_len, script):
        self.prompt_len = prompt_len
        self.script = script
        self._done = 0

    def sync(self, context):
        self._done = len(context) - self.prompt_len

    def propose(self, k):
        return self.script[self._done:self._done + k]


def _scripted(reference, prompt, n, wrong):
    script = reference(prompt, n)
    if wrong:
        script = [(t + 1) % 256 for t in script]
    return lambda: _Scripted(len(prompt), script)


def _random_prompts():
    g = np.random.default_rng(0)
    return [g.integers(1, 255, size=14).tolist() for _ in range(2)]


# name -> (engine kwargs, waves, new tokens); the proposer and the eos
# are filled in from the reference streams
_SCENARIOS = {
    # repetitive (spec-friendly) and random (spec-hostile) prompts; the
    # first stops at an eos mid-stream, after speculation ran
    "ngram_repetitive_random_eos": (
        dict(max_slots=4, n_pages=64, spec_ngram=2),
        [[[9, 8, 9, 8], REP_PROMPT, REP_PROMPT] + _random_prompts()], 24),
    "oracle_accepts_everything": (
        dict(max_slots=2, n_pages=32), [[[5, 9, 2, 7, 11]]], 16),
    "anti_oracle_full_rejection": (
        dict(max_slots=2, n_pages=32), [[[5, 9, 2, 7, 11]]], 16),
    # each request needs ceil((4+28)/8)=4 pages, 6 usable: preemption
    # while speculation is active
    "preemption_mid_speculation": (
        dict(max_slots=2, n_pages=7, spec_ngram=2),
        [[[1, 2, 1, 2], [9, 8, 9, 8]]], 28),
    # sequential waves: the second admission hits the first prompt's
    # full pages, the third repeats the page-aligned first (fully
    # cached: the copy-on-write path)
    "prefix_cache_hit_cow": (
        dict(max_slots=2, n_pages=32, prefix_cache=True, spec_ngram=2),
        [[REP_PROMPT + [3, 1, 4, 1]], [REP_PROMPT + [4, 2]],
         [REP_PROMPT + [3, 1, 4, 1]]], 16),
    "int8_pool": (
        dict(max_slots=2, n_pages=64, kv_dtype="int8"),
        [[[5, 6, 7, 8] * 5]], 40),
}


def _scenario(name, reference):
    kw, waves, n = _SCENARIOS[name]
    kw = dict(kw, page_size=8, chunk=4, spec_len=4)
    if name.startswith(("oracle", "anti")):
        prompt = waves[0][0]
        kw["spec_proposer"] = _scripted(reference, prompt, n,
                                        wrong=name.startswith("anti"))
    if name == "ngram_repetitive_random_eos":
        # the first id of the second half not seen before it: the first
        # request stops there, mid-stream, after speculation ran
        ref = reference(waves[0][0], n)
        kw["eos_id"] = next(t for i, t in enumerate(ref)
                            if i >= n // 2 and t not in ref[:i])
    return kw, waves, n


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_spec_engine_matches_jax_engine(tiny, name):
    jmodel, params, model, reference = tiny
    kw, waves, n = _scenario(name, reference)
    jeng = JEngine(jmodel, params, overlap=False, **kw)
    want = _serve(jeng, waves, n)
    want_stats = jeng.spec_stats()
    lock = LLMEngine(model, device="cpu", overlap=False, **kw)
    over = LLMEngine(model, device="cpu", overlap=True, **kw)
    assert _serve(lock, waves, n) == want
    assert _serve(over, waves, n) == want
    assert lock.spec_stats() == want_stats
    st = over.spec_stats()
    assert want_stats["rounds"] > 0 and st["rounds"] > 0
    assert (st["accepted_tokens"] + st["rejected_tokens"]
            == st["proposed_tokens"])
    if kw.get("kv_dtype") != "int8":
        # fp32 speculation is exact: the plain greedy stream
        for p, got in zip((p for w in waves for p in w), want):
            full = reference(p, n)
            cut = (full.index(kw["eos_id"]) + 1
                   if kw.get("eos_id") in full else n)
            assert got == full[:cut]
    if name == "oracle_accepts_everything":
        assert want_stats["accept_rate"] == 1.0
        assert want_stats["tokens_per_dispatch"] > 1.0
    elif name == "anti_oracle_full_rejection":
        assert want_stats["proposed_tokens"] > 0
        assert want_stats["accept_rate"] == 0.0
        assert want_stats["tokens_per_dispatch"] == 1.0
    elif name == "ngram_repetitive_random_eos":
        assert want[0][-1] == kw["eos_id"] and len(want[0]) < n
        assert all(len(t) == n for t in want[1:])
    elif name == "preemption_mid_speculation":
        assert lock.stats["preemptions"] > 0
        assert over.stats["preemptions"] > 0
    elif name == "prefix_cache_hit_cow":
        for eng in (lock, over):
            assert eng.stats["cache_hit_admissions"] == 2
            eng.prefix_cache.check_invariants()
    elif name == "int8_pool":
        # self-consistency: int8 rounding must not break the proposer /
        # verify loop (the reference's noise bound)
        fp = LLMEngine(model, device="cpu",
                       **dict(kw, kv_dtype="fp"))
        _serve(fp, waves, n)
        assert (st["accept_rate"]
                >= fp.spec_stats()["accept_rate"] - 0.15)


def test_spec_cancel_mid_speculation(tiny):
    """Cancelling a slot while the spec lane runs frees it at once; the
    survivor stays the greedy stream."""
    _, _, model, reference = tiny
    p1, p2 = list(REP_PROMPT), list(REP_PROMPT[2:])
    eng = LLMEngine(model, device="cpu", max_slots=4, page_size=8,
                    n_pages=64, chunk=2, spec_len=4, spec_ngram=2)
    h1 = eng.submit(p1, max_new_tokens=24)
    h2 = eng.submit(p2, max_new_tokens=24)
    for _ in range(64):
        eng.step()
        if (eng.stats["spec_rounds"] and eng.slots[1] is not None
                and eng.slots[1].req is h2._req):
            break
    else:
        raise AssertionError("spec lane never engaged")
    assert h2.cancel() is True
    assert eng.slots[1] is None
    while eng.step():
        pass
    assert h1.result() == reference(p1, 24)
    with pytest.raises(RequestCancelled):
        h2.result()
    assert len(h2._req.generated) < 24
    assert eng.stats["cancelled"] == 1 and eng.spec_stats()["rounds"] > 0


@pytest.mark.parametrize("kw", [
    dict(), dict(spec_len=4), dict(spec_len=4, temperature=0.8),
    dict(spec_len=4, capture_logprobs=True), dict(spec_len=2,
                                                   spec_ngram=1)])
def test_spec_knobs_resolve_as_reference(tiny, kw):
    """Off by default, silently off under sampling and under logprob
    capture, as in the JAX engine; a sampling engine still serves."""
    jmodel, params, model, _ = tiny
    base = dict(max_slots=2, page_size=8, n_pages=32, chunk=4)
    ours = LLMEngine(model, device="cpu", **base, **kw)
    ref = JEngine(jmodel, params, **base, **kw)
    assert ours.spec_len == ref.spec_len
    assert (ours.spec_stats() is None) == (ref.spec_stats() is None)
    if kw.get("temperature"):
        assert ours.spec_len == 0
        assert len(_serve(ours, [[[5, 9, 2]]], 8)[0]) == 8
        assert ours.stats["spec_rounds"] == 0


@pytest.mark.parametrize("kw", [dict(spec_len=-1),
                                dict(spec_len=2, spec_ngram=0)])
def test_spec_validation_matches_reference(tiny, kw):
    jmodel, params, model, _ = tiny
    with pytest.raises(ValueError):
        LLMEngine(model, device="cpu", **kw)
    with pytest.raises(ValueError):
        JEngine(jmodel, params, **kw)
