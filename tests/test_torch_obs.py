"""The port's serving observability (``ray_tpu_torch/serve/obs.py`` and
the engine's event sites) against the JAX package's, on the CPU.

- The pure cases of tests/test_obs.py, each run against both ``obs``
  modules (with each package's ``util/tracing`` and ``util/metrics``),
  and the outputs of the two held equal on the same event tuples:
  ``request_phases``, ``chrome_trace``, ``emit_request_spans``,
  ``event_window`` and a flight bundle's files as
  ``load_flight_bundle`` reads them back.
- Engine event parity: one script (greedy, a prefix-cache hit with
  the copy-on-write path, speculation, a preemption, a cancel, a
  deadline, a contained decode ``EngineFault`` with ``flight_dir``)
  runs through both packages' ``LLMEngine`` (``llama_tiny`` fp32, the
  flax params of PRNGKey(0), ``overlap=False``). The two event logs
  must be equal but for their times, and so must ``sched_trace``, the
  ``serve_phase_*`` histograms' counts and the flight bundle's
  culprit. On the CPU a port readback is ready when its dispatch
  returns; the JAX engine's readiness probe (``_dev_ready``) is made to
  say the same, so both drain their readbacks in the same rounds.
- The reference's own ``sched_trace`` assertions (tests/
  test_llm_engine.py, test_prefix_cache.py, test_spec_decode.py) run
  against the port.
- ``events=False`` records nothing and changes no stream.
"""
import json
import os
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
from ray_tpu.serve import faults as jfaults
from ray_tpu.serve import obs as jobs
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import faults as tfaults
from ray_tpu_torch.serve import obs as tobs
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import tracing as ttracing

DATA, ETYPE, RID, SEQ, SID, T = (tobs.DATA, tobs.ETYPE, tobs.RID,
                                 tobs.SEQ, tobs.SID, tobs.T)
_PKGS = {
    "jax": types.SimpleNamespace(obs=jobs, tracing=jtracing,
                                 metrics=jmetrics),
    "torch": types.SimpleNamespace(obs=tobs, tracing=ttracing,
                                   metrics=tmetrics),
}


@pytest.fixture(params=sorted(_PKGS))
def pkg(request):
    return _PKGS[request.param]


# ---------------------------------------------------------- event log


def test_append_snapshot_order_and_fields(pkg):
    log = pkg.obs.EventLog(16, name="t")
    log.append("submit", rid=1, data={"trace_id": "abc"})
    log.append("admit", rid=1, sid=0)
    log.append("decode", data=3)
    evs = log.snapshot()
    assert [e[ETYPE] for e in evs] == ["submit", "admit", "decode"]
    assert [e[SEQ] for e in evs] == [0, 1, 2]
    assert evs[0][RID] == 1 and evs[0][DATA] == {"trace_id": "abc"}
    assert evs[1][SID] == 0
    assert evs[0][T] <= evs[1][T] <= evs[2][T]


def test_ring_wrap_keeps_newest(pkg):
    log = pkg.obs.EventLog(4)
    for i in range(10):
        log.append("e", rid=i)
    assert log.total == 10
    assert len(log) == 4
    evs = log.snapshot()
    assert [e[RID] for e in evs] == [6, 7, 8, 9]
    assert [e[SEQ] for e in evs] == [6, 7, 8, 9]
    assert log.tail(2) == evs[-2:]


def test_explicit_timestamp_and_clear(pkg):
    log = pkg.obs.EventLog(8)
    log.append("first_token", rid=7, t=123.5, data={"ttft_s": 0.25})
    assert log.snapshot()[0][T] == 123.5
    log.clear()
    assert log.total == 0 and not log.snapshot()


def test_disabled_log_is_a_noop(pkg):
    log = pkg.obs.EventLog(8, enabled=False)
    log.append("submit", rid=1)
    assert log.total == 0 and log.snapshot() == []


def test_capacity_validated(pkg):
    with pytest.raises(ValueError):
        pkg.obs.EventLog(0)


def test_concurrent_appends_never_tear(pkg):
    log = pkg.obs.EventLog(256)
    stop = threading.Event()

    def writer(k):
        i = 0
        while not stop.is_set():
            log.append("w", rid=(k, i))
            i += 1

    threads = [threading.Thread(target=writer, args=(k,), daemon=True)
               for k in range(4)]
    for th in threads:
        th.start()
    deadline = time.time() + 0.2
    while time.time() < deadline:
        evs = log.snapshot()
        assert all(len(e) == 6 for e in evs)
        assert [e[SEQ] for e in evs] == sorted(e[SEQ] for e in evs)
    stop.set()
    for th in threads:
        th.join(timeout=5)


def test_append_cost_is_bounded(pkg):
    """Both arms stay in the microsecond class (a generous bound)."""
    n = 20000
    for enabled in (True, False):
        log = pkg.obs.EventLog(4096, enabled=enabled)
        t0 = time.perf_counter()
        for _ in range(n):
            log.append("decode", sid=0, data=4)
        per = (time.perf_counter() - t0) / n
        assert per < 100e-6, f"append cost {per * 1e6:.1f}us/event"


def test_as_dicts_jsonable(pkg):
    log = pkg.obs.EventLog(8)
    log.append("prefill", rid=(1, 2), data=((0, 4), (1, 4)))
    log.append("fault", rid=3, data={"error": ValueError("boom")})
    d = pkg.obs.as_dicts(log.snapshot())
    json.dumps(d)
    assert d[0]["rid"] == [1, 2]
    assert d[0]["data"] == [[0, 4], [1, 4]]
    assert "ValueError" in d[1]["data"]["error"]
    assert set(d[0]) == {"seq", "t", "type", "rid", "sid", "data"}


# ------------------------------------------------- sched_trace compat


def test_view_renders_exact_legacy_shapes(pkg):
    log = pkg.obs.EventLog(32)
    log.append("prefill", rid=(1,), data=((0, 8),))
    log.append("decode", data=4)
    log.append("spec", sid=2, data=(6, 5))
    log.append("cache_hit", sid=1, data=24)
    assert list(pkg.obs.SchedTraceView(log)) == [
        ("prefill", ((0, 8),)), ("decode", 4), ("spec", 2, 6, 5),
        ("cache_hit", (1, 24))]


def test_view_hides_new_event_kinds(pkg):
    log = pkg.obs.EventLog(32)
    log.append("submit", rid=1)
    log.append("decode", data=2)
    log.append("first_token", rid=1)
    log.append("retire", rid=1)
    view = pkg.obs.SchedTraceView(log)
    assert list(view) == [("decode", 2)]
    assert len(view) == 1 and bool(view)
    assert ("decode", 2) in view and ("submit", 1) not in view
    assert not pkg.obs.SchedTraceView(pkg.obs.EventLog(4))


def test_view_append_round_trips(pkg):
    view = pkg.obs.SchedTraceView(pkg.obs.EventLog(32))
    view.append(("prefill", ((0, 4), (1, 4))))
    view.append(("decode", 3))
    view.append(("spec", 1, 6, 4))
    view.append(("cache_hit", (0, 16)))
    assert list(view) == [("prefill", ((0, 4), (1, 4))), ("decode", 3),
                          ("spec", 1, 6, 4), ("cache_hit", (0, 16))]
    with pytest.raises(ValueError):
        view.append(("nonsense", 1))


# ----------------------------------------------------- request phases


def _lifecycle_log(obs):
    log = obs.EventLog(64)
    log.append("submit", rid=1, t=10.0, data={"trace_id": "t1"})
    log.append("admit", rid=1, sid=0, t=10.1)
    log.append("prefill", rid=(1,), t=10.15, data=((0, 8),))
    log.append("first_token", rid=1, t=10.3, data={"ttft_s": 0.3})
    log.append("emit", rid=1, t=10.3, data={"n": 1})
    log.append("emit", rid=1, t=10.5, data={"n": 3})
    log.append("retire", rid=1, t=10.6)
    log.append("submit", rid=2, t=10.2)
    log.append("shed", rid=2, t=10.25, data={"why": "queue_full"})
    return log


def test_request_phases_derivations(pkg):
    ph = pkg.obs.request_phases(_lifecycle_log(pkg.obs).snapshot())
    r1 = ph[1]
    assert r1["trace_id"] == "t1" and r1["outcome"] == "retire"
    assert r1["queue_wait_s"] == pytest.approx(0.1)
    assert r1["ttft_s"] == pytest.approx(0.3)
    assert r1["prefill_s"] == pytest.approx(0.2)
    assert r1["decode_s"] == pytest.approx(0.3)
    assert r1["total_s"] == pytest.approx(0.6)
    assert r1["n_tokens"] == 4 and r1["n_emits"] == 2
    assert r1["sid"] == 0
    assert ph[2]["outcome"] == "shed" and ph[2]["ttft_s"] is None


def test_request_phases_keeps_first_admit_on_resubmit(pkg):
    log = pkg.obs.EventLog(16)
    log.append("submit", rid=1, t=1.0)
    log.append("admit", rid=1, sid=0, t=1.1)
    log.append("preempt", rid=1, t=1.2)
    log.append("admit", rid=1, sid=1, t=1.5)
    log.append("retire", rid=1, t=2.0)
    r = pkg.obs.request_phases(log.snapshot())[1]
    assert r["queue_wait_s"] == pytest.approx(0.1)
    assert r["sid"] == 1


def test_request_phases_skips_batched_rids(pkg):
    log = pkg.obs.EventLog(8)
    log.append("prefill", rid=(1, 2), t=1.0, data=((0, 4), (1, 4)))
    assert pkg.obs.request_phases(log.snapshot()) == {}


# ------------------------------------------------------- chrome trace


def test_chrome_trace_structure(pkg):
    evs = _lifecycle_log(pkg.obs).snapshot()
    trace = pkg.obs.chrome_trace({"engine": evs})
    json.dumps(trace)
    meta = [e for e in trace if e["ph"] == "M"
            and e["name"] == "process_name"]
    assert {m["args"]["name"] for m in meta} == {"engine", "requests"}
    inst = [e for e in trace if e["ph"] == "i"]
    assert len(inst) == 9 and all(e["s"] == "t" for e in inst)
    assert [e["ts"] for e in inst] == pytest.approx(
        [(ev[T] - 10.0) * 1e6 for ev in evs], abs=0.01)
    assert {e["name"] for e in trace if e["ph"] == "X"} == {
        "request", "queue_wait", "prefill", "decode"}
    req = next(e for e in trace if e["ph"] == "X"
               and e["name"] == "request")
    assert req["dur"] == pytest.approx(0.6e6)
    assert req["args"]["trace_id"] == "t1"


# ----------------------------------------------------- tracing bridge


def test_emit_request_spans_shape_and_emission(pkg, tmp_path):
    spans = pkg.obs.emit_request_spans(_lifecycle_log(pkg.obs).snapshot())
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    assert len(by_name["serve.request"]) == 2
    root = next(s for s in by_name["serve.request"]
                if s["attributes"]["rid"] == 1)
    assert root["trace_id"] == "t1" and root["parent_id"] is None
    for child in ("serve.queue_wait", "serve.prefill", "serve.decode"):
        (c,) = by_name[child]
        assert c["parent_id"] == root["span_id"]
        assert c["trace_id"] == "t1"
        assert c["end_time"] >= c["start_time"]
    shed_root = next(s for s in by_name["serve.request"]
                     if s["attributes"]["rid"] == 2)
    assert shed_root["status"] == "error"
    pkg.tracing.setup_tracing(trace_dir=str(tmp_path / "tr"))
    try:
        pkg.obs.emit_request_spans(_lifecycle_log(pkg.obs).snapshot())
        got = [s for s in pkg.tracing.get_spans()
               if s["name"] == "serve.request"]
        assert len(got) == 2
    finally:
        pkg.tracing.teardown_tracing()


def test_mint_trace_id_shape(pkg):
    a, b = pkg.obs.mint_trace_id(), pkg.obs.mint_trace_id()
    assert a != b
    assert len(a) == 16 and int(a, 16) >= 0


# ---------------------------------------------------- flight recorder


class _FakeAlloc:
    n_pages, n_free = 64, 60

    def occupancy(self):
        return 4 / 64


class _FakeFlightEngine:
    """The probe surface of a wedged engine; the locked accessors
    raise, since the probe must not call them."""

    def __init__(self, obs):
        self.events = obs.EventLog(32)
        self.events.append("decode", sid=0, data=4)
        self.events.append("fault", rid=9,
                           data={"error": "EngineFault('x')"})
        self.stats = {"submitted": 5, "completed": 3, "shed": 1,
                      "spec_proposed": 10, "spec_accepted": 8}
        self.alloc = _FakeAlloc()
        self.prefix_cache = None

    def load_report(self):
        return {"heartbeat_age_s": 2.5, "queue_depth": 1}

    def lifecycle_stats(self):
        raise AssertionError("probe called a LOCKED accessor")

    def spec_stats(self):
        raise AssertionError("probe called a LOCKED accessor")


def test_dump_and_load_flight_bundle(pkg, tmp_path):
    bdir = pkg.obs.dump_flight_bundle(
        str(tmp_path), "wedged-r1", engine=_FakeFlightEngine(pkg.obs),
        extra={"heartbeat_age_s": 2.5, "err": ValueError("x")})
    assert bdir is not None and os.path.isdir(bdir)
    assert os.path.basename(bdir).startswith("wedged-r1-")
    b = pkg.obs.load_flight_bundle(bdir)
    assert b["reason"] == "wedged-r1"
    e = b["engine"]
    assert e["events_total"] == 2
    assert [ev["type"] for ev in e["events"]] == ["decode", "fault"]
    assert e["heartbeat_gap_s"] >= 2.5
    assert e["lifecycle"]["submitted"] == 5
    assert e["spec"] == {"spec_proposed": 10, "spec_accepted": 8}
    assert e["allocator"] == {"n_pages": 64, "n_free": 60,
                              "occupancy": 4 / 64, "page_bytes": None,
                              "bytes_in_use": None, "bytes_total": None}
    assert "ValueError" in b["extra"]["err"]
    with open(os.path.join(bdir, "events.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["stream"] for ln in lines] == ["engine", "engine"]


def test_flight_bundle_tolerates_bare_fakes(pkg, tmp_path):
    class Bare:
        pass

    bdir = pkg.obs.dump_flight_bundle(str(tmp_path), "x", engine=Bare(),
                                      pool=Bare(), watchdog=Bare())
    b = pkg.obs.load_flight_bundle(bdir)
    assert b["engine"] == {} and b["pool"] == {}


def test_flight_bundle_never_raises_on_io_failure(pkg, tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    assert pkg.obs.dump_flight_bundle(
        str(blocker), "x", engine=_FakeFlightEngine(pkg.obs)) is None


def test_default_flight_dir_env_override(pkg, monkeypatch):
    monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", "/tmp/elsewhere")
    assert pkg.obs.default_flight_dir() == "/tmp/elsewhere"
    monkeypatch.delenv("RAY_TPU_FLIGHT_DIR")
    assert f"p{os.getpid()}" in pkg.obs.default_flight_dir()


# ------------------------------------------------------ phase metrics


def test_phase_metrics_singleton_and_rebuild(pkg):
    m1 = pkg.obs.phase_metrics()
    assert pkg.obs.phase_metrics() is m1
    assert set(m1) == {"queue_wait", "plan", "dispatch", "readback",
                       "round_wall", "host_gap", "ttft", "inter_token"}
    m1["ttft"].observe(0.12)
    assert "serve_phase_ttft_s_bucket" in pkg.metrics.prometheus_text()
    pkg.metrics.clear_registry()
    m2 = pkg.obs.phase_metrics()
    assert m2 is not m1
    assert pkg.metrics.registry()["serve_phase_ttft_s"] is m2["ttft"]


def test_event_window_cursor_resume_limit_and_dropped(pkg):
    obs = pkg.obs
    log = obs.EventLog(capacity=8, name="win")
    for i in range(5):
        log.append("e", rid=i)
    win, cur, dropped = obs.event_window(log.snapshot(), log.total, 0,
                                         limit=3)
    assert [e[RID] for e in win] == [0, 1, 2]
    assert cur == 3 and dropped == 0
    win, cur, dropped = obs.event_window(log.snapshot(), log.total, cur,
                                         limit=10)
    assert [e[RID] for e in win] == [3, 4] and cur == 5 and dropped == 0
    win, cur, dropped = obs.event_window(log.snapshot(), log.total, cur,
                                         limit=10)
    assert win == [] and cur == 5 and dropped == 0
    for i in range(5, 13):
        log.append("e", rid=i)
    win, cur, dropped = obs.event_window(log.snapshot(), log.total, 0,
                                         limit=100)
    assert dropped == 5
    assert [e[RID] for e in win] == list(range(5, 13))
    assert cur == 13


def test_load_flight_bundle_torn_final_line(pkg, tmp_path):
    bdir = pkg.obs.dump_flight_bundle(str(tmp_path), "crash",
                                      engine=_FakeFlightEngine(pkg.obs))
    epath = os.path.join(bdir, "events.jsonl")
    with open(epath) as f:
        good = f.read()
    n_good = len(good.splitlines())
    with open(epath, "a") as f:
        f.write('{"stream": "engine", "ty')
    with pytest.warns(RuntimeWarning, match="torn"):
        b = pkg.obs.load_flight_bundle(bdir)
    assert b["events_torn_truncated"] == 1
    assert len(b["events_jsonl"]) == n_good
    with open(epath) as f:
        assert f.read() == good
    assert pkg.obs.load_flight_bundle(bdir).get(
        "events_torn_truncated", 0) == 0
    with open(epath, "w") as f:
        f.write('{"broken": \n' + good)
    with pytest.raises(json.JSONDecodeError):
        pkg.obs.load_flight_bundle(bdir)


# ------------------------------------ the two modules, the same output


def _same_events(obs):
    """A two-request log on fixed stamps, and a ring that wrapped."""
    log = _lifecycle_log(obs)
    log.append("submit", rid=3, t=10.7, data={"trace_id": None})
    log.append("admit", rid=3, sid=1, t=10.8)
    log.append("preempt", rid=3, sid=1, t=10.9)
    log.append("cancelled", rid=3, t=11.0, data={"error": "x"})
    wrapped = obs.EventLog(4)
    for i in range(9):
        wrapped.append("e", rid=i, t=float(i))
    return log, wrapped


def _span_shape(spans):
    """``emit_request_spans`` records without their minted ids and
    wall-clock offsets: names, parents by name, durations, status."""
    names = {s["span_id"]: s["name"] for s in spans}
    return sorted(
        (s["name"], s["trace_id"] if s["trace_id"] == "t1" else "",
         names.get(s["parent_id"], ""), round(s["end_time"]
                                          - s["start_time"], 9),
         s["status"], json.dumps(s["attributes"], sort_keys=True))
        for s in spans)


def test_modules_give_equal_outputs(tmp_path):
    out = {}
    for name, p in _PKGS.items():
        log, wrapped = _same_events(p.obs)
        evs = log.snapshot()
        windows = []
        cur = 0
        while True:
            win, cur, dropped = p.obs.event_window(
                wrapped.snapshot(), wrapped.total, cur, limit=3)
            windows.append(([e[RID] for e in win], cur, dropped))
            if not win:
                break
        out[name] = {
            "phases": p.obs.request_phases(evs),
            "chrome": json.dumps(p.obs.chrome_trace(
                {"engine": evs, "pool": wrapped.snapshot()}),
                sort_keys=True),
            "spans": _span_shape(p.obs.emit_request_spans(evs)),
            "windows": windows,
            "dicts": p.obs.as_dicts(evs),
        }
    assert out["torch"] == out["jax"]


def test_flight_bundle_files_equal(tmp_path):
    read = {}
    for name, p in _PKGS.items():
        eng = _FakeFlightEngine(p.obs)
        bdir = p.obs.dump_flight_bundle(
            str(tmp_path / name), "engine-fault", engine=eng,
            extra={"error": repr(ValueError("x"))})
        b = p.obs.load_flight_bundle(bdir)
        for k in ("t_wall", "t_mono", "pid"):
            b.pop(k)
        b["engine"].pop("event_gap_s")
        b["engine"].pop("last_event_t")
        for ev in b["engine"]["events"] + b["events_jsonl"]:
            ev.pop("t")
        read[name] = b
    assert read["torch"] == read["jax"]


# ------------------------------------------------ engine event parity

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
        kw = {"overlap": False, **kw}
        if pkg == "jax":
            return jeng.LLMEngine(jmodel, params, **kw)
        return teng.LLMEngine(tmodel, device="cpu", **kw)

    return types.SimpleNamespace(engine=engine, want=want)


@pytest.fixture
def ready_readbacks(monkeypatch):
    """The JAX engine's readiness probe answers as the CPU port's
    readbacks do: every dispatch is done when it returns."""
    monkeypatch.setattr(jeng, "_dev_ready", lambda buf: True)


def _drive(eng, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while eng.step():
        if time.monotonic() > deadline:
            raise AssertionError("engine did not quiesce")


def _outcome(h):
    try:
        return ("ok", h.result())
    except Exception as e:  # noqa: BLE001 - the record names the type
        return ("err", type(e).__name__)


def _timeless(data):
    """An event's data without its times (keys ending ``_s``)."""
    if isinstance(data, dict):
        return {k: v for k, v in data.items() if not k.endswith("_s")}
    return data


def _script(eng, name, tmp):
    """Run the named script through ``eng``; returns the handles."""
    if name == "greedy":
        hs = [eng.submit([5, 9, 2, 7], max_new_tokens=12),
              eng.submit(list(range(1, 20)), max_new_tokens=6,
                         trace_id="t-1")]
    elif name == "prefix_cow":
        p = list(range(1, 17))                 # exactly 2 pages
        hs = [eng.submit(p + [30, 31], max_new_tokens=6)]
        _drive(eng)
        hs += [eng.submit(p + [40, 41, 42], max_new_tokens=6),
               eng.submit(p, max_new_tokens=6)]      # fully cached
    elif name == "spec":
        rep = [3, 1, 4, 1, 5, 9, 2, 6] * 3
        hs = [eng.submit(rep, max_new_tokens=20),
              eng.submit(rep[2:], max_new_tokens=20)]
    elif name == "preempt":
        hs = [eng.submit([1, 2, 1, 2], max_new_tokens=28),
              eng.submit([9, 8, 9, 8], max_new_tokens=28)]
    elif name == "cancel":
        hs = [eng.submit([5, 9, 2, 7], max_new_tokens=24),
              eng.submit([4, 4, 2], max_new_tokens=24)]
        for _ in range(3):
            eng.step()
        hs[1].cancel()
    elif name == "deadline":
        hs = [eng.submit([5, 9, 2, 7], max_new_tokens=24),
              eng.submit([4, 4, 2], max_new_tokens=24, deadline_s=60.0),
              eng.submit([7, 7, 1], max_new_tokens=24, deadline_s=60.0)]
        eng.step()
        eng.step()
        # both deadlines pass now, at a known round: one request is
        # slotted, one still queued (max_slots 2)
        for h in hs[1:]:
            h._req.deadline = time.monotonic()
    elif name == "fault":
        hs = [eng.submit(p, max_new_tokens=12)
              for p in ([5, 9, 2, 7], [4, 4, 2], [1, 2, 3, 4, 5])]
    _drive(eng)
    return hs


_SCRIPTS = {
    "greedy": dict(max_slots=2, page_size=8, n_pages=64, chunk=4),
    "prefix_cow": dict(max_slots=2, page_size=8, n_pages=32, chunk=4,
                       prefix_cache=True),
    "spec": dict(max_slots=2, page_size=8, n_pages=32, chunk=4,
                 spec_len=4, spec_ngram=2),
    "preempt": dict(max_slots=2, page_size=8, n_pages=7, chunk=4),
    "cancel": dict(max_slots=2, page_size=8, n_pages=32, chunk=2,
                   eos_id=-1),
    "deadline": dict(max_slots=2, page_size=8, n_pages=32, chunk=2,
                     eos_id=-1),
    "fault": dict(max_slots=4, page_size=8, n_pages=32, chunk=4),
}
_PHASES = ("queue_wait", "plan", "dispatch", "readback", "round_wall",
           "host_gap", "ttft", "inter_token")


def _record(tiny, pkg, name, tmp):
    p = _PKGS[pkg]
    p.metrics.clear_registry()
    kw = dict(_SCRIPTS[name])
    faults = jfaults if pkg == "jax" else tfaults
    if name == "fault":
        inj = faults.FaultInjector()
        inj.inject("dispatch_decode", sid=1, round=3,
                   exc=RuntimeError("decode fault"))
        # no retry backoff: the requeued riders re-admit at a round
        # the wall clock cannot move
        kw.update(fault_injector=inj, flight_dir=str(tmp / pkg),
                  retry_backoff_s=0.0)
    eng = tiny.engine(pkg, **kw)
    hs = _script(eng, name, tmp)
    faults.check_quiesced(eng)
    pm = p.obs.phase_metrics()
    rec = {
        "out": [_outcome(h) for h in hs],
        "events": [(e[ETYPE], e[RID], e[SID], _timeless(e[DATA]))
                   for e in eng.events.snapshot()],
        "sched_trace": list(eng.sched_trace),
        "phase_counts": {k: sum(v["count"] for _t, v in pm[k]._samples())
                         for k in _PHASES},
    }
    if name == "fault":
        (bdir,) = [os.path.join(tmp / pkg, d)
                   for d in os.listdir(tmp / pkg)]
        b = p.obs.load_flight_bundle(bdir)
        faults_seen = [ev for ev in b["engine"]["events"]
                       if ev["type"] == "fault"]
        rec["bundle"] = (b["reason"], faults_seen[-1]["rid"],
                         faults_seen[-1]["sid"],
                         b["engine"]["lifecycle"]["contained_faults"])
    return rec


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_engine_events_equal(tiny, ready_readbacks, tmp_path, name):
    rec = {pkg: _record(tiny, pkg, name, tmp_path)
           for pkg in ("jax", "torch")}
    assert rec["torch"]["out"] == rec["jax"]["out"]
    assert rec["torch"]["events"] == rec["jax"]["events"]
    assert rec["torch"]["sched_trace"] == rec["jax"]["sched_trace"]
    assert rec["torch"]["phase_counts"] == rec["jax"]["phase_counts"]
    r = rec["torch"]
    kinds = [e[0] for e in r["events"]]
    # every rid's events run in lifecycle order
    by_rid = {}
    for kind, rid, _sid, _d in r["events"]:
        if isinstance(rid, int):
            by_rid.setdefault(rid, []).append(kind)
    for rid, ks in by_rid.items():
        assert ks[0] == "submit", (rid, ks)
        if ks[-1] == "retire":
            assert ks.index("admit") < ks.index("first_token"), ks
    if name == "prefix_cow":
        assert ("cache_hit", (0, 16)) in r["sched_trace"]
        assert kinds.count("cache_hit") == 2
    if name == "spec":
        assert any(t[0] == "spec" for t in r["sched_trace"])
    if name == "preempt":
        assert "preempt" in kinds
    if name == "cancel":
        assert r["out"][1] == ("err", "RequestCancelled")
        assert "cancelled" in kinds
    if name == "deadline":
        assert [o[0] for o in r["out"]] == ["ok", "err", "err"]
        assert kinds.count("deadline_exceeded") == 2
    if name == "fault":
        assert r["out"][1] == ("err", "RuntimeError")
        assert rec["torch"]["bundle"] == rec["jax"]["bundle"]
        assert r["bundle"][:2] == ("engine-fault", 1)
        assert "requeue" in kinds
    # survivors' streams equal JAX generate
    prompts_ok = [o for o in r["out"] if o[0] == "ok"]
    assert prompts_ok


def test_greedy_streams_equal_generate(tiny, ready_readbacks, tmp_path):
    eng = tiny.engine("torch", **_SCRIPTS["greedy"])
    hs = _script(eng, "greedy", tmp_path)
    assert hs[0].result() == tiny.want([5, 9, 2, 7], 12)
    assert hs[1].result() == tiny.want(list(range(1, 20)), 6)
    ph = tobs.request_phases(eng.events.snapshot())
    assert ph[1]["trace_id"] == "t-1" and ph[0]["outcome"] == "retire"
    for h, rid in zip(hs, (0, 1)):
        assert ph[rid]["ttft_s"] == pytest.approx(h.ttft_s, abs=1e-3)
        assert ph[rid]["n_tokens"] == len(h.result())


# ------------------------- the reference's sched_trace asserts, on the port


def test_chunked_prefill_interleaves_decode(tiny):
    """tests/test_llm_engine.py: decode dispatches land between a long
    prompt's prefill chunks."""
    eng = tiny.engine("torch", max_slots=2, page_size=8, n_pages=64,
                      chunk=2, prefill_chunk=8, overlap=None)
    h1 = eng.submit([1, 2], max_new_tokens=40)
    for _ in range(3):
        eng.step()
    p2 = list(range(1, 33))
    h2 = eng.submit(p2, max_new_tokens=4)
    _drive(eng)
    assert h1.result() == tiny.want([1, 2], 40)
    assert h2.result() == tiny.want(p2, 4)
    trace = list(eng.sched_trace)
    pf = [i for i, (kind, _) in enumerate(trace) if kind == "prefill"]
    assert len(pf) >= 5
    for a, b in zip(pf, pf[1:]):
        assert any(trace[i][0] == "decode" for i in range(a + 1, b)), \
            trace[a:b + 1]


def test_cache_hit_recorded_in_sched_trace(tiny):
    """tests/test_prefix_cache.py: a 3-page hit shows as
    ("cache_hit", (0, 24))."""
    eng = tiny.engine("torch", max_slots=2, page_size=8, n_pages=32,
                      chunk=4, prefix_cache=True, overlap=None)
    prefix = list(range(1, 25))
    h1 = eng.submit(prefix + [30, 31], max_new_tokens=10)
    _drive(eng)
    h2 = eng.submit(prefix + [40, 41, 42], max_new_tokens=10)
    _drive(eng)
    assert h1.result() == tiny.want(prefix + [30, 31], 10)
    assert h2.result() == tiny.want(prefix + [40, 41, 42], 10)
    assert eng.stats["cache_hit_tokens"] == 24
    assert ("cache_hit", (0, 24)) in list(eng.sched_trace)


class _Scripted:
    """tests/test_spec_decode.py's proposer seam: a fixed continuation
    keyed on how many tokens the slot generated."""

    def __init__(self, prompt_len, script):
        self.prompt_len = prompt_len
        self.script = script
        self._done = 0

    def sync(self, context):
        self._done = len(context) - self.prompt_len

    def propose(self, k):
        return self.script[self._done:self._done + k]


@pytest.mark.parametrize("proposer", ["ngram", "oracle", "sampling"])
def test_spec_markers_in_sched_trace(tiny, proposer):
    """tests/test_spec_decode.py: ("spec", sid, proposed, accepted)
    markers within bounds; an oracle proposer's all accepted; none
    under sampling, where speculation is off."""
    prompt = [5, 9, 2, 7, 11]
    ref = tiny.want(prompt, 16)
    kw = dict(max_slots=4, page_size=8, n_pages=64, chunk=4, spec_len=4,
              spec_ngram=2, overlap=None)
    if proposer == "oracle":
        kw["spec_proposer"] = lambda: _Scripted(len(prompt), ref)
    if proposer == "sampling":
        kw["temperature"] = 0.8
    eng = tiny.engine("torch", **kw)
    hs = [eng.submit(prompt, max_new_tokens=16)]
    if proposer != "oracle":      # the oracle scripts one prompt only
        hs.append(eng.submit([3, 1, 4, 1, 5, 9, 2, 6] * 2,
                             max_new_tokens=16))
    _drive(eng)
    outs = [h.result() for h in hs]
    markers = [t for t in eng.sched_trace if t[0] == "spec"]
    if proposer == "sampling":
        assert eng.spec_len == 0 and not markers
        return
    assert outs[0] == ref
    assert markers, "no ('spec', ...) trace markers"
    for _tag, sid, proposed, accepted in markers:
        assert 0 <= accepted <= proposed <= 4
        assert 0 <= sid < 4
        if proposer == "oracle":
            assert accepted == proposed


def test_spec_cancel_mid_speculation_trace(tiny):
    """tests/test_spec_decode.py: step until the spec lane engaged (read
    off sched_trace) with the victim in flight, cancel it; the survivor
    stays exact and the engine quiesces."""
    rep = [3, 1, 4, 1, 5, 9, 2, 6] * 3
    eng = tiny.engine("torch", max_slots=4, page_size=8, n_pages=64,
                      chunk=2, spec_len=4, spec_ngram=2, overlap=None)
    h1 = eng.submit(rep, max_new_tokens=24)
    h2 = eng.submit(rep[2:], max_new_tokens=24)
    for _ in range(64):
        eng.step()
        if ([t for t in eng.sched_trace if t[0] == "spec"]
                and eng.slots[1] is not None
                and eng.slots[1].req is h2._req):
            break
    else:
        raise AssertionError("spec lane never engaged")
    assert h2.cancel() is True
    _drive(eng)
    assert h1.result() == tiny.want(rep, 24)
    tfaults.check_quiesced(eng)


# ------------------------------------------------------ events=False


def test_events_off_records_nothing(tiny, ready_readbacks, tmp_path):
    tmetrics.clear_registry()
    out = {}
    for events in (True, False):
        eng = tiny.engine("torch", events=events, **_SCRIPTS["spec"])
        hs = _script(eng, "spec", tmp_path)
        out[events] = [h.result() for h in hs]
        if not events:
            assert eng.events.total == 0 and not list(eng.sched_trace)
    assert out[False] == out[True]
    # only the events=True run observed anything
    pm = tobs.phase_metrics()
    ttft = sum(v["count"] for _t, v in pm["ttft"]._samples())
    assert ttft == 2
