"""The port's logprob capture (``LLMEngine(capture_logprobs=True)``,
``RequestHandle.logprobs``) against the JAX package on the CPU.

``llama_tiny(float32)`` with the flax params of ``PRNGKey(0)`` in both
packages. At temperature 0 the captured logprobs must be within 1e-5 of
the JAX engine's on the same submits (the same tokens: greedy). At
temperature 0.7 the sampled tokens differ between ``torch.Generator``
and ``jax.random``, so each captured logprob is held, within 1e-5,
against a teacher-forced recompute of the port's own tokens by the JAX
model: ``log_softmax(logits / 0.7)`` of the dense forward over prompt +
completion (the scenario of
tests/test_rl_rollout.py::test_captured_logprobs_match_teacher_forced_dense).
Both loops run, the overlapped one through the stale seam of
tests/test_torch_overlap.py as well; eos truncation and preemption must
keep the logprobs aligned with the tokens. Every engine ends leak-free.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve.engine import LLMEngine as JEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve.engine import LLMEngine

LOGPROB_TOL = 1e-5
PROMPTS = [[5, 9, 2], [3, 1, 4, 1, 5], [2, 7, 1, 8], [9, 8, 9, 8]]


@pytest.fixture(scope="module")
def tiny():
    """(flax model, flax params, torch model)."""
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    model = tl.build_model(tl.llama_tiny(dtype=torch.float32), sd, "cpu")
    return jmodel, params, model


@pytest.fixture(autouse=True)
def _no_page_leaks(monkeypatch):
    created = []
    orig = LLMEngine.__init__

    def record(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        created.append(self)

    monkeypatch.setattr(LLMEngine, "__init__", record)
    yield
    for eng in created:
        assert eng.alloc.occupancy() == 0, (
            f"engine leaked pages: {sorted(eng.alloc.leak_report())[:16]}")


def _capture(eng, prompts, n):
    hs = [eng.submit(list(p), max_new_tokens=n) for p in prompts]
    while eng.step():
        pass
    return [h.result() for h in hs], [h.logprobs for h in hs]


# name -> engine kwargs. "preempt": each request needs 4 pages of 8 at
# full length and 6 are usable, so the younger is recomputed and its
# logprobs must stay aligned through the recompute.
_CASES = {
    "eos": dict(max_slots=4, n_pages=64, eos_id=206),
    "preempt": dict(max_slots=2, n_pages=7),
}


def _case(case):
    kw = dict(_CASES[case], page_size=8, chunk=4, capture_logprobs=True)
    if case == "eos":
        return kw, PROMPTS, 16
    return kw, PROMPTS[:2], 28


@pytest.fixture(scope="module")
def jax_captures(tiny):
    """case -> (tokens, logprobs) of the JAX engine (lockstep), each
    case run once for every loop of the port."""
    jmodel, params, _ = tiny
    out = {}
    for case in _CASES:
        kw, prompts, n = _case(case)
        out[case] = _capture(JEngine(jmodel, params, overlap=False, **kw),
                             prompts, n)
    return out


@pytest.mark.parametrize("loop", ["lockstep", "overlap", "overlap_stale"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_greedy_logprobs_match_jax_engine(tiny, jax_captures, monkeypatch,
                                          case, loop):
    _, _, model = tiny
    kw, prompts, n = _case(case)
    want_toks, want_lps = jax_captures[case]
    if loop == "overlap_stale":
        monkeypatch.setattr(teng._Readback, "ready", lambda self: False)
    eng = LLMEngine(model, device="cpu", overlap=loop != "lockstep", **kw)
    toks, lps = _capture(eng, prompts, n)
    assert toks == want_toks
    for t, lp, wlp in zip(toks, lps, want_lps):
        assert len(lp) == len(t) == len(wlp)
        np.testing.assert_allclose(lp, wlp, rtol=0, atol=LOGPROB_TOL)
        assert all(x <= 0.0 for x in lp)
    if case == "eos":
        assert any(t[-1] == kw["eos_id"] and len(t) < n for t in toks)
    else:
        assert eng.stats["preemptions"] > 0


@pytest.mark.parametrize("loop", ["lockstep", "overlap_stale"])
def test_sampled_logprobs_match_teacher_forced_jax(tiny, monkeypatch, loop):
    """temperature 0.7: the behaviour policy's logprobs, from the prefill
    (first token) and the decode steps (the rest)."""
    jmodel, params, model = tiny
    temp = 0.7
    if loop == "overlap_stale":
        monkeypatch.setattr(teng._Readback, "ready", lambda self: False)
    eng = LLMEngine(model, device="cpu", max_slots=4, page_size=8,
                    n_pages=64, chunk=4, temperature=temp, seed=3,
                    capture_logprobs=True, overlap=loop != "lockstep")
    toks, lps = _capture(eng, PROMPTS, 8)
    # one causal forward over every prompt + completion, zero-padded at
    # the end (padding after a position never reaches it)
    seqs = [p + c for p, c in zip(PROMPTS, toks)]
    ids = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for r, seq in enumerate(seqs):
        ids[r, :len(seq)] = seq
    logits, _ = jax.jit(jmodel.apply)(params, jnp.asarray(ids))
    ref = np.asarray(jax.nn.log_softmax(
        np.asarray(logits, np.float32) / temp, axis=-1))
    for r, (p, c, lp) in enumerate(zip(PROMPTS, toks, lps)):
        assert len(lp) == len(c) == 8
        want = [float(ref[r, len(p) - 1 + j, t]) for j, t in enumerate(c)]
        np.testing.assert_allclose(lp, want, rtol=0, atol=LOGPROB_TOL)


def test_capture_off_by_default_and_switches_spec_off(tiny):
    jmodel, params, model = tiny
    eng = LLMEngine(model, device="cpu", max_slots=2, page_size=8,
                    n_pages=32, chunk=4)
    h = eng.submit([5, 9, 2], max_new_tokens=4)
    while eng.step():
        pass
    assert len(h.result()) == 4 and h.logprobs is None
    kw = dict(max_slots=2, page_size=8, n_pages=32, spec_len=4,
              capture_logprobs=True)
    ours = LLMEngine(model, device="cpu", **kw)
    assert ours.spec_len == JEngine(jmodel, params, **kw).spec_len == 0
    assert ours.spec_stats() is None
