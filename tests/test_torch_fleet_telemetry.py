"""The port's fleet telemetry plane (``ray_tpu_torch/serve/fleet/
telemetry.py`` and the agent's and directory's ``rpc_telemetry``)
against the JAX package's, on the CPU.

- The cases of tests/test_fleet_telemetry.py on the port: the clock
  offset estimator over synthetic round trips (t0/t3 the collector's
  send and receive stamps, t1 the member's clock), the cursored scrape
  over a scriptable feed, and the collector over a loopback fleet of
  ``ScriptedEngine`` agents (its directory's leases far longer than any
  test, so no member lapses under load).
- Parity with the JAX package: the estimator fed the same seeded
  sample sequences; ``merge_prometheus_texts``; a cluster bundle dumped
  by either package's collector read by both ``load_cluster_bundle``s
  (a torn tail tolerated, a torn line mid-file raising, in both); the
  telemetry payload of an agent, a primary and a standby directory
  driven through one script on a fake clock.
"""
import json
import os
import time
import types

import numpy as np
import pytest

from ray_tpu.serve.fleet import agent as jagent
from ray_tpu.serve.fleet import directory as jdir
from ray_tpu.serve.fleet import router as jrouter
from ray_tpu.serve.fleet import telemetry as jtel
from ray_tpu.serve.fleet import transport as jtr
from ray_tpu_torch.serve import obs
from ray_tpu_torch.serve.fleet import agent as tagent
from ray_tpu_torch.serve.fleet import directory as tdir
from ray_tpu_torch.serve.fleet import router as trouter
from ray_tpu_torch.serve.fleet import telemetry as ttel
from ray_tpu_torch.serve.fleet import transport as ttr
from ray_tpu_torch.serve.fleet.agent import scripted_completion
from ray_tpu_torch.serve.fleet.telemetry import (ClockOffsetEstimator,
                                                 TelemetryCollector,
                                                 load_cluster_bundle,
                                                 merge_prometheus_texts)
from ray_tpu_torch.serve.fleet.transport import TransportError
from ray_tpu_torch.util import metrics

_PKGS = {
    "jax": types.SimpleNamespace(dir=jdir, agent=jagent, router=jrouter,
                                 tr=jtr, tel=jtel),
    "torch": types.SimpleNamespace(dir=tdir, agent=tagent, router=trouter,
                                   tr=ttr, tel=ttel),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ------------------------------------------------ offset estimator


def test_estimator_skew_ahead_and_behind():
    # member clock 5 s ahead, symmetric 10 ms RTT: the midpoint formula
    # recovers +5 exactly
    ahead = ClockOffsetEstimator()
    ahead.add_sample(t0=100.0, t1=105.005, t3=100.010)
    assert ahead.offset_s == pytest.approx(5.0)
    assert ahead.uncertainty_s == pytest.approx(0.005)
    assert ahead.rtt_s == pytest.approx(0.010)
    assert ahead.to_local(105.005) == pytest.approx(100.005)

    behind = ClockOffsetEstimator()
    behind.add_sample(t0=100.0, t1=95.005, t3=100.010)
    assert behind.offset_s == pytest.approx(-5.0)
    assert behind.to_local(95.005) == pytest.approx(100.005)


def test_estimator_asymmetric_rtt_error_stays_inside_bound():
    # true offset +2 s, a 1 ms request leg and a 9 ms response leg: the
    # midpoint is off by 4 ms, inside the RTT/2 = 5 ms bound
    a, b, true = 0.001, 0.009, 2.0
    est = ClockOffsetEstimator()
    t0 = 50.0
    est.add_sample(t0=t0, t1=t0 + a + true, t3=t0 + a + b)
    assert est.offset_s != pytest.approx(true)
    assert abs(est.offset_s - true) <= est.uncertainty_s
    assert est.uncertainty_s == pytest.approx((a + b) / 2)


def test_estimator_min_rtt_sample_wins():
    est = ClockOffsetEstimator()
    est.add_sample(t0=0.0, t1=1.1, t3=0.2)      # rtt 200 ms
    est.add_sample(t0=10.0, t1=11.0, t3=10.01)  # rtt 10 ms: the best
    est.add_sample(t0=20.0, t1=21.3, t3=20.5)   # rtt 500 ms
    assert est.offset_s == pytest.approx(11.0 - 10.005)
    assert est.uncertainty_s == pytest.approx(0.005)
    assert est.n_samples == 3


def test_estimator_drift_across_scrape_gap():
    est = ClockOffsetEstimator()
    # the offset grows 1 ms per 10 s of local time: 1e-4 s/s
    est.add_sample(t0=0.0, t1=5.0005, t3=0.001)
    assert est.drift_s_per_s is None
    est.add_sample(t0=10.0, t1=15.0015, t3=10.001)
    assert est.drift_s_per_s == pytest.approx(1e-4, rel=0.05)


def test_estimator_drift_gated_below_min_window():
    est = ClockOffsetEstimator(min_drift_window_s=1.0)
    est.add_sample(t0=0.0, t1=5.0, t3=0.001)
    est.add_sample(t0=0.010, t1=5.5, t3=0.011)
    assert est.drift_s_per_s is None


def test_estimator_rejects_backwards_round_trip():
    est = ClockOffsetEstimator()
    with pytest.raises(ValueError):
        est.add_sample(t0=5.0, t1=7.0, t3=4.0)


def test_estimator_bounded_sample_memory():
    est = ClockOffsetEstimator(max_samples=4)
    for i in range(10):
        est.add_sample(t0=float(i), t1=float(i) + 3.0,
                       t3=float(i) + 0.001)
    assert len(est._samples) == 4
    assert est.drift_s_per_s == pytest.approx(0.0, abs=1e-9)


def _sample_runs(seed: int):
    """Seeded round-trip sequences: skew ahead and behind, asymmetric
    legs, a scrape gap (drift), and a backwards round trip last."""
    g = np.random.default_rng(seed)
    runs = {}
    for name, skew in (("ahead", 5.0), ("behind", -5.0)):
        t, rows = 100.0, []
        for _ in range(12):
            a, b = g.uniform(1e-4, 5e-3, 2)
            rows.append((t, t + a + skew, t + a + b))
            t += float(g.uniform(0.1, 0.4))
        runs[name] = rows
    t, rows = 0.0, []
    for _ in range(8):
        a = float(g.uniform(1e-4, 1e-3))
        b = float(g.uniform(5e-3, 2e-2))
        rows.append((t, t + a + 2.0, t + a + b))
        t += 0.25
    runs["asymmetric"] = rows
    rows = []
    for t in (0.0, 0.25, 30.0, 30.25):      # a 30 s gap between scrapes
        a, b = g.uniform(1e-4, 2e-3, 2)
        rows.append((t, t + a + 1.0 + 1e-4 * t, t + a + b))
    runs["gap"] = rows
    runs["backwards"] = runs["ahead"][:3] + [(9.0, 10.0, 8.5)]
    return runs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimator_equals_the_reference(seed):
    for name, rows in _sample_runs(seed).items():
        ests = {"jax": jtel.ClockOffsetEstimator(max_samples=6),
                "torch": ClockOffsetEstimator(max_samples=6)}
        trail = {"jax": [], "torch": []}
        for pkg, est in ests.items():
            for t0, t1, t3 in rows:
                try:
                    est.add_sample(t0, t1, t3)
                except ValueError as e:
                    trail[pkg].append(str(e))
                    continue
                trail[pkg].append((est.offset_s, est.uncertainty_s,
                                   est.rtt_s, est.drift_s_per_s,
                                   est.to_local(t1)))
        assert len(trail["jax"]) == len(trail["torch"]) == len(rows), name
        for j, p in zip(trail["jax"], trail["torch"]):
            if isinstance(j, str):
                assert p == j, name
                continue
            for x, y in zip(j, p):
                assert (x is None) == (y is None), name
                if x is not None:
                    assert abs(x - y) <= 1e-12, (name, j, p)
        assert ests["torch"].as_dict() == ests["jax"].as_dict(), name
    assert trail["torch"][-1].startswith("receive time")


# --------------------------------------- cursored scrape + restarts


class _FakeMemberFeed:
    """A scriptable telemetry endpoint: one incarnation at a time, each
    with its own pid, generation, seq space and clock base."""

    def __init__(self):
        self.pid = 1000
        self.generation = 0
        self.clock_base = 1000.0
        self.events = []

    def restart(self, clock_base):
        self.pid += 1
        self.generation += 1
        self.clock_base = clock_base
        self.events = []

    def append(self, etype, **data):
        self.events.append(
            {"seq": len(self.events),
             "t": self.clock_base + 0.001 * len(self.events),
             "type": etype, "rid": data.pop("rid", None), "data": data})

    def telemetry(self, cursor=0, limit=256):
        window = [e for e in self.events if e["seq"] >= cursor][:limit]
        nxt = (window[-1]["seq"] + 1) if window \
            else max(cursor, len(self.events))
        return {"role": "agent", "replica_id": "m",
                "generation": self.generation, "pid": self.pid,
                "clock": {"mono": self.clock_base, "wall": 0.0},
                "metrics_text": "", "events": window,
                "cursor": nxt, "events_total": len(self.events),
                "dropped": max(0, min((e["seq"] for e in self.events),
                                      default=0) - cursor)}


def _bare_collector(**kw):
    class _NoRouter:
        pass
    return TelemetryCollector(_NoRouter(), **kw)


def test_scrape_cursor_resume_never_rereads():
    col = _bare_collector()
    st = col._state("m", "agent")
    feed = _FakeMemberFeed()
    for i in range(5):
        feed.append("submit", rid=f"r{i}")
    assert len(col._scrape_remote(st, feed.telemetry)) == 5
    assert col._scrape_remote(st, feed.telemetry) == []
    feed.append("retire", rid="r0")
    new = col._scrape_remote(st, feed.telemetry)
    assert [e["type"] for e in new] == ["retire"]
    assert col.counters["events_ingested"] == 6


def test_member_restart_resets_monotonic_base_and_cursor():
    col = _bare_collector()
    st = col._state("m", "agent")
    feed = _FakeMemberFeed()
    for _ in range(8):
        feed.append("submit")
    col._scrape_remote(st, feed.telemetry)
    old_offset = st.estimator.offset_s
    assert st.cursor == 8
    # the process restarts: its seqs and its monotonic base reset
    feed.restart(clock_base=10.0)
    feed.append("self_fence")
    feed.append("submit")
    new = col._scrape_remote(st, feed.telemetry)
    assert [e["type"] for e in new] == ["self_fence", "submit"]
    assert st.incarnations == 2
    assert st.cursor == 2
    assert st.estimator.n_samples == 1
    assert st.estimator.offset_s != pytest.approx(old_offset)
    t_scrape = time.monotonic()
    for ev in new:
        assert abs(ev["local_t"] - t_scrape) < 5.0


def test_scrape_counts_ring_overwrite_as_dropped():
    col = _bare_collector()
    st = col._state("m", "agent")
    feed = _FakeMemberFeed()
    for _ in range(4):
        feed.append("submit")
    col._scrape_remote(st, feed.telemetry)
    # the member's ring overwrote seqs 4..9 before the next scrape
    feed.events = [{"seq": s, "t": feed.clock_base + s, "type": "submit",
                    "rid": None, "data": {}} for s in range(10, 13)]
    new = col._scrape_remote(st, feed.telemetry)
    assert [e["seq"] for e in new] == [10, 11, 12]
    assert st.dropped == 6


# ------------------------------------------- collector over loopback


def _loopback_fleet(p=_PKGS["torch"], n=2, token_delay_s=0.0005, seed=7,
                    wrap_transport=None, **router_kw):
    d = p.dir.FleetDirectory(lease_ttl_s=60.0)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    agents = {}

    def tf(addr):
        t = p.tr.LoopbackTransport(agents[addr[1]].handle)
        return wrap_transport(addr[1], t) if wrap_transport else t

    for i in range(n):
        rid = f"a{i}"
        agents[rid] = p.agent.ReplicaAgent(
            rid, lambda g, _d=token_delay_s: p.agent.ScriptedEngine(
                token_delay_s=_d), dc, renew_period_s=0.05).start()
    kw = dict(seed=seed, snapshot_ttl_s=0.01, poll_interval_s=0.002)
    kw.update(router_kw)
    return d, dc, agents, p.router.FleetRouter(dc, tf, **kw)


def _close(r, agents):
    r.shutdown()
    for a in agents.values():
        a.shutdown()


def test_collector_loopback_scrape_trace_and_metrics(tmp_path):
    metrics.clear_registry()
    d, dc, agents, r = _loopback_fleet()
    col = TelemetryCollector(r, cluster_dir=str(tmp_path),
                             offset_bound_s=0.5).attach()
    try:
        assert r.telemetry_collector is col
        first = col.scrape_once()
        assert set(first) == {"router", "directory", "a0", "a1"}
        assert all(v is not None for v in first.values())
        tid = obs.mint_trace_id()
        h = r.submit([3, 1, 4], max_new_tokens=6, trace_id=tid)
        assert h.result() == scripted_completion([3, 1, 4], 6)
        col.scrape_once()
        # idempotent: nothing new, nothing ingested
        assert all(v == 0 for v in col.scrape_once().values())
        members = col.members()
        # the router member is the collector's own process: exact sample
        assert members["router"]["offset_s"] == 0.0
        assert members["router"]["uncertainty_s"] == 0.0
        for m in members.values():
            assert m["up"] is True
            assert m["uncertainty_s"] <= 0.5
        ph = col.request_phases()[tid]
        assert h.replica_idx in ph["members"] and "router" in ph["members"]
        # one OS process: spans per member, one pid
        assert ph["n_processes"] == 1 and ph["stitched"] is False
        for span in ph["spans"]:
            assert span["end_s"] >= span["start_s"]
            assert span["offset_uncertainty_s"] <= 0.5
        trace = col.chrome_trace()
        assert "process_name" in {ev.get("name") for ev in trace
                                  if ev.get("ph") == "M"}
        assert any(ev.get("ph") == "X"
                   and ev["args"].get("trace_id") == tid for ev in trace)
        text = col.metrics_text()
        assert 'member="' in text and "serve_fleet_members" in text
        health = col.health()
        assert health["members_up"] == 4
        assert health["offset_within_bound"] is True
        assert health["counters"]["scrapes"] >= 3
    finally:
        _close(r, agents)


def test_collector_fault_bundle_roundtrip(tmp_path):
    metrics.clear_registry()
    d, dc, agents, r = _loopback_fleet()
    col = TelemetryCollector(r, cluster_dir=str(tmp_path)).attach()
    try:
        r.submit([2, 7], max_new_tokens=4, trace_id="t-bundle").result()
        col.scrape_once()
        bdir = col.on_fault("unit-fault", trigger={"kind": "test", "x": 1})
        assert bdir is not None and os.path.isdir(bdir)
        assert col.bundles[-1]["reason"] == "unit-fault"
        cb = load_cluster_bundle(bdir)
        assert cb["reason"] == "unit-fault"
        assert cb["trigger"] == {"kind": "test", "x": 1}
        assert set(cb["members"]) == {"router", "directory", "a0", "a1"}
        assert cb["coverage"]["unreachable"] == []
        assert cb["events_torn_truncated"] == 0
        assert cb["member_payloads"]
        ts = [e["local_t"] for e in cb["events"] if e["local_t"] is not None]
        assert ts == sorted(ts)
        assert any((e.get("data") or {}).get("trace_id") == "t-bundle"
                   for e in cb["events"])
    finally:
        _close(r, agents)


def test_collector_auto_bundles_on_scraped_fault_event(tmp_path):
    metrics.clear_registry()
    d, dc, agents, r = _loopback_fleet()
    col = TelemetryCollector(r, cluster_dir=str(tmp_path)).attach()
    try:
        col.scrape_once()
        agents["a0"].events.append("self_fence",
                                   data={"lease_overdue_s": 0.4})
        col.scrape_once()
        reasons = [b["reason"] for b in col.bundles]
        assert "self_fence-a0" in reasons
        trig = [b for b in col.bundles
                if b["reason"] == "self_fence-a0"][0]["trigger"]
        assert trig["kind"] == "self_fence"
        assert trig["data"]["lease_overdue_s"] == 0.4
        # the SAME event never fires twice
        col.scrape_once()
        assert [b["reason"] for b in col.bundles] == reasons
    finally:
        _close(r, agents)


def test_cluster_bundle_torn_tail_tolerated_midfile_raises(tmp_path):
    metrics.clear_registry()
    d, dc, agents, r = _loopback_fleet(n=1)
    col = TelemetryCollector(r, cluster_dir=str(tmp_path)).attach()
    try:
        r.submit([5], max_new_tokens=3).result()
        col.scrape_once()
        bdir = col.dump_cluster_bundle("torn-check")
        epath = os.path.join(bdir, "events.jsonl")
        with open(epath) as f:
            n_events = sum(1 for _ in f)
        with open(epath, "a") as f:
            f.write('{"member": "a0", "ty')
        cb = load_cluster_bundle(bdir)
        assert cb["events_torn_truncated"] == 1
        assert len(cb["events"]) == n_events
        with open(epath) as f:
            lines = f.read().splitlines(keepends=True)
        lines[0] = '{"broken": \n'
        with open(epath, "w") as f:
            f.writelines(lines)
        with pytest.raises(json.JSONDecodeError):
            load_cluster_bundle(bdir)
    finally:
        _close(r, agents)


def test_collector_marks_unreachable_member_down(tmp_path):
    metrics.clear_registry()
    down = set()

    class _Gate:
        def __init__(self, rid, inner):
            self.rid, self.inner = rid, inner

        def call(self, *a, **kw):
            if self.rid in down:
                raise TransportError(f"{self.rid} unreachable")
            return self.inner.call(*a, **kw)

    d, dc, agents, r = _loopback_fleet(n=2, wrap_transport=_Gate)
    col = TelemetryCollector(r, cluster_dir=str(tmp_path)).attach()
    try:
        col.scrape_once()
        down.add("a0")
        assert col.scrape_once()["a0"] is None
        m = col.members()["a0"]
        assert m["up"] is False and m["last_error"]
        cb = load_cluster_bundle(col.dump_cluster_bundle("with-down-member"))
        assert "a0" in cb["coverage"]["unreachable"]
        assert "a1" in cb["coverage"]["scraped"]
        down.clear()
        assert col.scrape_once()["a0"] is not None
        assert col.members()["a0"]["up"] is True
    finally:
        _close(r, agents)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cluster_bundles_read_across_the_packages(tmp_path, writer):
    """A bundle dumped by ``writer``'s collector over its own loopback
    fleet reads back identically through both packages'
    ``load_cluster_bundle``; both truncate a torn tail and both raise on
    a torn line mid-file."""
    p = _PKGS[writer]
    metrics.clear_registry()
    d, dc, agents, r = _loopback_fleet(p)
    col = p.tel.TelemetryCollector(r, cluster_dir=str(tmp_path)).attach()
    try:
        r.submit([4, 2], max_new_tokens=5, trace_id="t-x").result()
        col.scrape_once()
        bdir = col.on_fault("x-fault", trigger={"kind": "test"})
    finally:
        _close(r, agents)
    got = {pkg: q.tel.load_cluster_bundle(bdir) for pkg, q in _PKGS.items()}
    assert got["torch"] == got["jax"]
    assert set(got["torch"]["members"]) == {"router", "directory", "a0",
                                            "a1"}
    assert got["torch"]["offset_table"].keys() == got["torch"][
        "members"].keys()
    epath = os.path.join(bdir, "events.jsonl")
    with open(epath, "a") as f:
        f.write('{"member": "a1", "se')
    for q in _PKGS.values():
        cb = q.tel.load_cluster_bundle(bdir)
        assert cb["events_torn_truncated"] == 1
        assert cb["events"] == got["torch"]["events"]
    with open(epath) as f:
        lines = f.read().splitlines(keepends=True)
    lines[1] = '{"torn": \n'
    with open(epath, "w") as f:
        f.writelines(lines)
    for q in _PKGS.values():
        with pytest.raises(json.JSONDecodeError):
            q.tel.load_cluster_bundle(bdir)


# --------------------------------------------- prometheus merging


def test_merge_prometheus_texts_labels_and_sorts():
    a = ("# HELP serve_qps queries\n"
         "# TYPE serve_qps gauge\n"
         "serve_qps 3.0\n"
         'serve_qps{route="/v1"} 2.0\n')
    b = ("# HELP serve_qps queries\n"
         "# TYPE serve_qps gauge\n"
         "serve_qps 5.0\n")
    out = merge_prometheus_texts({"b": b, "a": a})
    lines = out.splitlines()
    assert lines[0] == "# HELP serve_qps queries"
    assert lines[1] == "# TYPE serve_qps gauge"
    assert 'serve_qps{member="a"} 3.0' in lines
    assert 'serve_qps{member="a",route="/v1"} 2.0' in lines
    assert 'serve_qps{member="b"} 5.0' in lines
    assert lines.index('serve_qps{member="a"} 3.0') \
        < lines.index('serve_qps{member="b"} 5.0')
    esc = merge_prometheus_texts({'we"ird\\': a})
    assert 'member="we\\"ird\\\\"' in esc


def test_merge_prometheus_texts_empty():
    assert merge_prometheus_texts({}) == ""
    assert merge_prometheus_texts({"m": ""}) == ""


def test_merge_prometheus_texts_equals_the_reference():
    g = np.random.default_rng(3)
    texts = {}
    for m in ("b", "a", 'q"x', "c\\d"):
        lines = []
        for fam in g.permutation(["f_one", "f_two", "f_three"])[:2]:
            lines += [f"# HELP {fam} help of {fam}", f"# TYPE {fam} gauge"]
            for k in range(int(g.integers(1, 4))):
                tag = f'{{k="{k}"}}' if k else ""
                lines.append(f"{fam}{tag} {float(g.normal()):.6f}")
        lines += ["", "stray_sample_outside_a_family 1.0", "no_value"]
        texts[m] = "\n".join(lines[-3:] + lines[:-3]) + "\n"
    texts["empty"] = ""
    out = merge_prometheus_texts(texts)
    assert out == jtel.merge_prometheus_texts(texts)
    assert out == jtel.merge_prometheus_texts(texts, label="member")
    assert merge_prometheus_texts(texts, label="m2") \
        == jtel.merge_prometheus_texts(texts, label="m2")


# ----------------------------------------- telemetry payload parity


def _payload_record(resp):
    """A telemetry payload without what is the process's own (pid,
    clock, exposition, event times)."""
    out = {k: v for k, v in resp.items()
           if k not in ("pid", "clock", "metrics_text", "events")}
    out["events"] = [{k: e[k] for k in ("seq", "type", "rid", "sid",
                                        "data")} for e in resp["events"]]
    out["keys"] = sorted(resp)
    return out


def _agent_telemetry_script(p):
    """An agent through admissions, a duplicate, a partition, a
    self-fence and its rejoin on a fake clock; its telemetry scraped
    while fenced, after the rejoin, then through a cursor in windows of
    3."""
    clock = FakeClock()
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    a = p.agent.ReplicaAgent(
        "r0", lambda g: p.agent.ScriptedEngine(token_delay_s=0), dc,
        renew_period_s=3600.0, time_fn=clock)
    a.engine = a._factory(0)
    a._register(min_fence=0)
    a.engine.token_delay_s = 30.0
    a.rpc_submit(key="k0", prompt_ids=[1, 2], max_new_tokens=4,
                 deadline_s=None, fence=a.fence, trace_id="t0")
    a.rpc_submit(key="k0", prompt_ids=[1, 2], max_new_tokens=4,
                 deadline_s=None, fence=a.fence, trace_id="t0")
    a.rpc_inject_partition(duration_s=2.0)
    clock.advance(1.5)
    a.renew_once()
    rec = [_payload_record(a.handle("telemetry", {}))]   # while FENCED
    clock.advance(1.0)
    a.renew_once()
    rec.append(_payload_record(a.rpc_telemetry()))
    cursor = 0
    while True:
        resp = a.rpc_telemetry(cursor=cursor, limit=3)
        rec.append(_payload_record(resp))
        if not resp["events"]:
            break
        cursor = resp["cursor"]
    a.shutdown()
    return rec


def _directory_telemetry_script(p):
    """A primary through registers, renewals, a lapse and a tombstone;
    a standby through a replicated member and its promotion; each one's
    telemetry scraped whole and from a cursor."""
    clock = FakeClock()
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    f0 = dc.register("r0", ["loopback", "r0"], generation=0)["fence"]
    dc.register("r1", ["loopback", "r1"], generation=0)
    dc.renew("r0", f0, digest=[11, 22])
    clock.advance(1.5)
    dc.confirm_dead("r1", 2)
    rec = [_payload_record(d.handle("telemetry", {})),
           _payload_record(d.rpc_telemetry(cursor=2, limit=2))]
    sb = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock,
                              role=p.dir.STANDBY)
    sb.rpc_repl_apply(epoch=0, seq=1,
                      record={"op": "member", "replica_id": "r0",
                              "addr": ["loopback", "r0"], "generation": 3,
                              "fence": 7})
    rec.append(_payload_record(sb.rpc_telemetry()))
    sb.rpc_promote(reason="test")
    rec += [_payload_record(sb.rpc_telemetry()),
            _payload_record(sb.rpc_telemetry(cursor=1, limit=1))]
    return rec


@pytest.mark.parametrize("script", [_agent_telemetry_script,
                                    _directory_telemetry_script])
def test_rpc_telemetry_equals_the_reference(script):
    rec = {pkg: script(p) for pkg, p in _PKGS.items()}
    assert rec["torch"] == rec["jax"]
    assert rec["torch"][0]["events"]
    kinds = {e["type"] for r in rec["torch"] for e in r["events"]}
    if script is _agent_telemetry_script:
        assert {"self_fence", "partitioned"} <= kinds
        assert rec["torch"][0]["state"] == "fenced"
        assert rec["torch"][1]["state"] == "active"
        assert rec["torch"][1]["generation"] == 1
    else:
        assert {"promote", "fence_issued"} <= kinds
        assert rec["torch"][-2]["replica_id"] == "directory-primary"
