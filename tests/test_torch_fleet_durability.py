"""The port's durable, replicated directory and its capacity providers
(``ray_tpu_torch/serve/fleet``: ``wal``, ``replication``, ``provider``,
the directory's durable and standby half, the router's autoscaler
surface, ``LlamaDeployment(fleet=, autoscale=True)``) against the JAX
package's, on the CPU.

- The cases of tests/test_fleet_durability.py but its gate of the
  reference's committed artifacts (the port's campaign artifact is held
  to that gate in tests/test_torch_fleet_chaos.py). The deterministic
  ones run one script on fake clocks through both packages and compare
  the records: the answers, the counters and the directory's events
  without their times. The threaded ones run on both packages and compare what the
  threads cannot reorder.
- A data directory written by one package's directory and recovered by
  the other's, both ways; each package's torn tail truncated by the
  other's ``load``; a JAX primary replicating over sockets to a port
  standby that then promotes, no fencing token regressing.
- The replicated records and the snapshot payload are JSON of Python
  scalars.
- A marker audit of tests/test_torch_fleet*.py: every test that starts
  processes is ``slow``-marked or runs under its own time budget.
The fleet's processes (a failover list, the provider) are
tests/test_torch_fleet_procs.py's.
"""
import ast
import json
import os
import threading
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import llm as jllm
from ray_tpu.serve.fleet import agent as jagent
from ray_tpu.serve.fleet import directory as jdir
from ray_tpu.serve.fleet import provider as jprov
from ray_tpu.serve.fleet import replication as jrepl
from ray_tpu.serve.fleet import router as jrouter
from ray_tpu.serve.fleet import transport as jtr
from ray_tpu.serve.fleet import wal as jwal
from ray_tpu_torch.autoscaler import node_provider as tnp_provider
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.fleet import agent as tagent
from ray_tpu_torch.serve.fleet import directory as tdir
from ray_tpu_torch.serve.fleet import provider as tprov
from ray_tpu_torch.serve.fleet import replication as trepl
from ray_tpu_torch.serve.fleet import router as trouter
from ray_tpu_torch.serve.fleet import transport as ttr
from ray_tpu_torch.serve.fleet import wal as twal

_PKGS = {
    "jax": types.SimpleNamespace(dir=jdir, agent=jagent, router=jrouter,
                                 tr=jtr, wal=jwal, repl=jrepl, prov=jprov),
    "torch": types.SimpleNamespace(dir=tdir, agent=tagent, router=trouter,
                                   tr=ttr, wal=twal, repl=trepl, prov=tprov),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _both(case, *args):
    """``case(pkg, *args)`` for both packages; the records must be
    equal."""
    rec = {name: case(_PKGS[name], *args) for name in ("jax", "torch")}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def _raised(fn):
    """The type name ``fn()`` raises, or its result."""
    try:
        return fn()
    except Exception as e:   # noqa: BLE001 - the record names the type
        return type(e).__name__


def _events(d):
    """The directory's events without their times."""
    return [{k: v for k, v in e.items() if k != "t"} for e in d.events]


def _python_scalars(obj, where="payload"):
    """``obj`` is JSON of Python scalars: no numpy or torch number, and
    ``json.dumps`` needs no fallback."""
    json.dumps(obj)
    if isinstance(obj, dict):
        for k, v in obj.items():
            assert type(k) is str, (where, k)
            _python_scalars(v, f"{where}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _python_scalars(v, f"{where}[{i}]")
    else:
        assert type(obj) in (int, float, str, bool, type(None)), (
            where, type(obj))


class _DeadTransport:
    """Every call is a connection failure (of the package's type)."""

    def __init__(self, p):
        self.calls = 0
        self._err = p.tr.TransportError

    def call(self, method, args, *, timeout_s=None, trace_id=None):
        self.calls += 1
        raise self._err("injected dead endpoint")


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


# --------------------------------------------------------- WAL units


def _restart_script(p, root):
    root = os.path.join(root, p.dir.__name__.split(".")[0])
    clock = FakeClock()
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock, data_dir=root)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    f0 = dc.register("r0", ["loopback", "r0"], generation=0,
                     page_size=8)["fence"]
    f1 = dc.register("r1", ["loopback", "r1"], generation=2)["fence"]
    dc.deregister("r1", f1)
    payload = d._durable_payload()
    clock.advance(0.9)             # r0's lease almost dead at the crash
    d._wal.close()
    d2 = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=FakeClock(1000.0),
                              data_dir=root)
    dc2 = p.dir.DirectoryClient(p.tr.LoopbackTransport(d2.handle))
    rec = [f0, f1, payload, dc2.stats(), dc2.snapshot(),
           dc2.renew("r0", f0),
           _raised(lambda: dc2.register("r1", ["loopback", "r1"],
                                        generation=2)),
           _events(d), _events(d2), p.wal.wal_record_count(root)]
    d2._wal.close()
    return rec


def test_wal_acknowledged_mutations_survive_restart(tmp_path):
    """Register and deregister land in the WAL before the RPC answers; a
    fresh directory over the same data_dir recovers membership,
    tombstones and the fence high-water, with leases re-armed to a FULL
    TTL."""
    f0, f1, payload, st, snap, renew, zombie, _, ev2, _ = _both(
        _restart_script, str(tmp_path))
    _python_scalars(payload)
    _python_scalars(st)
    assert st["counters"]["recovered_members"] == 1
    assert st["tombstones"] == {"r1": 2}
    assert st["fence_counter"] >= max(f0, f1)
    assert st["wal"]["appends"] == 0
    members = snap["members"]
    assert [m["replica_id"] for m in members] == ["r0"]
    assert members[0]["lease_remaining_s"] == pytest.approx(1.0)
    assert members[0]["page_size"] == 8
    assert renew == {"lease_ttl_s": 1.0}
    assert zombie == "StaleFencingToken"
    assert [e["kind"] for e in ev2] == ["recover"]


def _torn_script(p, root):
    root = os.path.join(root, p.dir.__name__.split(".")[0])
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, data_dir=root)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    dc.register("r0", ["loopback", "r0"], generation=0)
    dc.register("r1", ["loopback", "r1"], generation=0)
    intact = p.wal.wal_record_count(root)
    d._wal.close()
    p.wal.inject_torn_tail(root)
    d2 = p.dir.FleetDirectory(lease_ttl_s=1.0, data_dir=root)
    st = d2.rpc_stats()
    with open(os.path.join(root, "wal.log"), "rb") as fh:
        clean = fh.read().endswith(b"\n")
    d2._wal.close()
    return [intact, st["counters"], st["wal"],
            p.wal.wal_record_count(root), clean]


def test_wal_torn_tail_truncated_never_replayed(tmp_path):
    intact, counters, wal, after, clean = _both(_torn_script, str(tmp_path))
    assert counters["recovered_members"] == 2
    assert counters["wal_torn_truncated"] >= 1
    assert wal["torn_records_truncated"] == 1
    assert after == intact == 2 and clean     # truncated IN PLACE


def _mid_log_script(p, root):
    root = os.path.join(root, p.dir.__name__.split(".")[0])
    w = p.wal.DirectoryWAL(root, snapshot_every=1000)
    for i in range(5):
        w.append({"op": "member", "replica_id": f"r{i}",
                  "addr": ["loopback", f"r{i}"], "generation": 0,
                  "fence": i + 1})
    w.close()
    with open(os.path.join(root, "wal.log"), "r+b") as fh:
        lines = fh.read().split(b"\n")
        lines[2] = lines[2][:-3] + b"!" + lines[2][-2:]   # flip a byte
        fh.seek(0)
        fh.write(b"\n".join(lines))
        fh.truncate()
    w2 = p.wal.DirectoryWAL(root)
    snap, records = w2.load()
    return [snap, records, dict(w2.stats), p.wal.wal_record_count(root)]


def test_wal_mid_log_corruption_truncates_everything_after(tmp_path):
    """The FIRST bad record marks the torn tail: the records after it
    rode a corrupted region and are dropped too."""
    snap, records, stats, left = _both(_mid_log_script, str(tmp_path))
    assert snap is None
    assert [r["replica_id"] for r in records] == ["r0", "r1"]
    assert stats["torn_records_truncated"] == 3
    assert left == 2


def _compaction_script(p, root):
    root = os.path.join(root, p.dir.__name__.split(".")[0])
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, data_dir=root,
                             snapshot_every=4)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    fences = {f"r{i}": dc.register(f"r{i}", ["loopback", f"r{i}"],
                                   generation=0)["fence"]
              for i in range(6)}
    rec = [fences, dict(d._wal.stats), p.wal.wal_record_count(root)]
    d._wal.close()
    d2 = p.dir.FleetDirectory(lease_ttl_s=1.0, data_dir=root)
    rec.append(d2.rpc_stats())
    d2._wal.close()
    return rec


def test_wal_snapshot_compaction_and_replay_equivalence(tmp_path):
    """``snapshot_every`` appends compact the WAL into the snapshot, and
    recovery from snapshot + suffix equals recovery from the full log."""
    fences, stats, left, st = _both(_compaction_script, str(tmp_path))
    assert stats["snapshots"] >= 1
    assert left == 2
    assert st["counters"]["recovered_members"] == 6
    assert st["fence_counter"] >= max(fences.values())


def _corrupt_snapshot_script(p, root):
    root = os.path.join(root, p.dir.__name__.split(".")[0])
    w = p.wal.DirectoryWAL(root, snapshot_every=1000)
    w.snapshot({"members": [{"replica_id": "ghost",
                             "addr": ["loopback", "ghost"],
                             "generation": 0, "fence": 9}],
                "fence_counter": 9})
    w.append({"op": "member", "replica_id": "r0",
              "addr": ["loopback", "r0"], "generation": 0, "fence": 10})
    w.close()
    with open(os.path.join(root, "snapshot.json"), "r+b") as fh:
        head = fh.readline()
        body = fh.read()
        fh.seek(len(head))
        fh.write(body[:-2] + b"XX")
    w2 = p.wal.DirectoryWAL(root)
    snap, records = w2.load()
    return [snap, records, dict(w2.stats)]


def test_wal_corrupt_snapshot_rejected_wal_suffix_survives(tmp_path):
    snap, records, stats = _both(_corrupt_snapshot_script, str(tmp_path))
    assert snap is None
    assert stats["snapshot_checksum_rejects"] == 1
    assert [r["replica_id"] for r in records] == ["r0"]


def _replay_idempotence_script(p, root):
    """A crash between the snapshot's rename and the WAL's truncation:
    every record of the log is already in the snapshot, and replaying
    it over the snapshot gives the same table."""
    root = os.path.join(root, p.dir.__name__.split(".")[0])
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, data_dir=root,
                             snapshot_every=1000)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    f = {rid: dc.register(rid, ["loopback", rid], generation=1)["fence"]
         for rid in ("r0", "r1", "r2")}
    dc.deregister("r1", f["r1"])
    dc.register("r0", ["loopback", "r0"], generation=2)
    with open(os.path.join(root, "wal.log"), "rb") as fh:
        log = fh.read()
    d._wal.snapshot(d._durable_payload())
    d._wal.close()
    with open(os.path.join(root, "wal.log"), "wb") as fh:
        fh.write(log)              # the truncation never happened
    d2 = p.dir.FleetDirectory(lease_ttl_s=1.0, data_dir=root)
    st = d2.rpc_stats()
    snap = d2.rpc_snapshot()
    d2._wal.close()
    return [st["fence_counter"], st["tombstones"],
            sorted((m["replica_id"], m["generation"], m["fence"])
                   for m in snap["members"]),
            sorted((m["replica_id"], m["generation"], m["fence"])
                   for m in d.rpc_snapshot()["members"]),
            d.rpc_stats()["fence_counter"]]


def test_wal_replay_over_its_own_snapshot_is_idempotent(tmp_path):
    fence, tombs, recovered, before, fence_before = _both(
        _replay_idempotence_script, str(tmp_path))
    assert recovered == before and fence == fence_before
    assert tombs == {"r1": 1}
    assert [m[:2] for m in recovered] == [("r0", 2), ("r2", 1)]


# ---------------------------------------- replication + promotion


def _standby_script(p):
    clock = FakeClock()
    sb = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock,
                              role=p.dir.STANDBY)
    sc = p.dir.DirectoryClient(p.tr.LoopbackTransport(sb.handle))
    rec = [_raised(lambda: sc.register("r0", ["loopback", "r0"],
                                       generation=0)),
           _raised(lambda: sc.renew("r0", 1)),
           _raised(lambda: sc.deregister("r0", 1)),
           _raised(lambda: sc.confirm_dead("r0", 1)),
           _raised(lambda: sc.snapshot()),
           sb.counters["not_primary_rejects"],
           sb.rpc_repl_apply(epoch=0, seq=1,
                             record={"op": "member", "replica_id": "r0",
                                     "addr": ["loopback", "r0"],
                                     "generation": 3, "fence": 7})]
    clock.advance(0.9)             # the replicated lease nearly stale
    rec += [sc.promote(reason="test"), sb.role, sc.snapshot(),
            sc.promote(),
            sc.register("r1", ["loopback", "r1"], generation=0)["fence"],
            _raised(lambda: sb.rpc_repl_apply(
                epoch=0, seq=2, record={"op": "tombstone",
                                        "replica_id": "r0",
                                        "generation": 3})),
            dict(sb.counters), _events(sb)]
    return rec


def test_standby_refuses_adjudication_and_promotion_folds_fence():
    rec = _both(_standby_script)
    assert rec[:5] == ["NotPrimary"] * 5    # snapshot is adjudication too
    assert rec[5] == 5
    out, role, snap, again, fence, stale = rec[7:13]
    assert out["promoted"] is True and out["epoch"] == 1
    assert out["fence_counter"] >= 7 + tdir.FENCE_EPOCH_STRIDE
    assert role == tdir.PRIMARY
    # promotion re-armed the replicated member with a FULL lease
    assert snap["members"][0]["lease_remaining_s"] == pytest.approx(1.0)
    assert again["promoted"] is False and again["epoch"] == 1
    assert fence > 7 + tdir.FENCE_EPOCH_STRIDE
    assert stale == "StaleFencingToken"      # the old primary is fenced


class _Recording:
    """Wraps a transport and keeps every (method, args) it carried."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def call(self, method, args, *, timeout_s=None, trace_id=None):
        self.calls.append((method, args))
        return self.inner.call(method, args, timeout_s=timeout_s,
                               trace_id=trace_id)


def _replicator_script(p):
    sb = p.dir.FleetDirectory(lease_ttl_s=1.0, role=p.dir.STANDBY)
    link = p.tr.FaultyTransport(p.tr.LoopbackTransport(sb.handle), seed=3)
    rec_link = _Recording(link)
    repl = p.repl.Replicator([rec_link], timeout_s=0.5)
    prim = p.dir.FleetDirectory(lease_ttl_s=1.0, replicator=repl)
    repl.attach(prim).start()
    pc = p.dir.DirectoryClient(p.tr.LoopbackTransport(prim.handle))
    rec = []
    try:
        f0 = pc.register("r0", ["loopback", "r0"], generation=0)["fence"]
        assert _wait(lambda: "r0" in sb._members)
        rec += [sb._members["r0"].fence == f0, repl.stats["syncs"]]
        link.partition()           # outage: deltas bounce
        pc.register("r1", ["loopback", "r1"], generation=0)
        assert _wait(lambda: repl.stats["errors"] >= 1)
        rec.append("r1" in sb._members)
        link.heal()                # one more delta: a full-state repair
        pc.register("r2", ["loopback", "r2"], generation=0)
        assert _wait(lambda: len(sb._members) == 3)
        assert _wait(lambda: repl.stats["applied"] == 2)
        rec += [sorted(sb._members), dict(repl.stats),
                {k: sb.counters[k] for k in ("repl_syncs", "repl_applied",
                                             "repl_gaps")},
                sb._fence_counter == prim._fence_counter]
    finally:
        repl.stop()
    return rec, rec_link.calls


def test_replicator_streams_deltas_and_full_sync_repair():
    """Every delta reaches the standby; an unreachable standby is
    repaired with a FULL repl_sync on the next contact instead of a
    replayed gap. What crossed the link is JSON of Python scalars."""
    rec = {}
    for name in ("jax", "torch"):
        rec[name], calls = _replicator_script(_PKGS[name])
        if name == "torch":
            # the delta lost to the partition, then a full repair
            assert [m for m, _ in calls] == ["repl_sync", "repl_apply",
                                             "repl_apply", "repl_sync",
                                             "repl_apply"]
            _python_scalars([a for _, a in calls])
    assert rec["torch"] == rec["jax"]
    same_fence, syncs0, r1_seen, members, stats, counters, hw = rec["torch"]
    assert same_fence and syncs0 == 1 and not r1_seen
    assert members == ["r0", "r1", "r2"]
    assert stats["syncs"] == 2 and counters["repl_syncs"] == 2
    assert hw


def _monitor_script(p):
    prim = p.dir.FleetDirectory(lease_ttl_s=1.0)
    sb = p.dir.FleetDirectory(lease_ttl_s=1.0, role=p.dir.STANDBY)
    up = threading.Event()
    err = p.tr.TransportError

    class _GatedPing:
        def __init__(self):
            self._inner = p.tr.LoopbackTransport(prim.handle)

        def call(self, method, args, *, timeout_s=None, trace_id=None):
            if not up.is_set():
                raise err("primary not up")
            return self._inner.call(method, args, timeout_s=timeout_s,
                                    trace_id=trace_id)

    mon = p.repl.StandbyMonitor(sb, _GatedPing(), promote_after_s=0.08,
                                poll_s=0.01).start()
    try:
        # never seen alive: no promotion however long it is unreachable
        time.sleep(0.3)
        rec = [sb.role, mon.stats["promoted"]]
        up.set()                   # the primary appears ...
        assert _wait(lambda: mon.stats["pings_ok"] > 0)
        up.clear()                 # ... and dies for good
        assert _wait(lambda: sb.role == p.dir.PRIMARY)
        rec += [sb.role, sb.epoch, mon.stats["promoted"],
                [e["kind"] for e in sb.events]]
    finally:
        mon.stop()
    return rec


def test_standby_monitor_promotes_only_after_seen_alive():
    rec = _both(_monitor_script)
    assert rec == [tdir.STANDBY, 0, tdir.PRIMARY, 1, 1, ["promote"]]


def _failover_script(p):
    prim = p.dir.FleetDirectory(lease_ttl_s=1.0)
    sb = p.dir.FleetDirectory(lease_ttl_s=1.0, role=p.dir.STANDBY)
    dead = _DeadTransport(p)
    fdc = p.repl.FailoverDirectoryClient(
        [dead, p.tr.LoopbackTransport(sb.handle),
         p.tr.LoopbackTransport(prim.handle)], timeout_s=0.5)
    r = fdc.register("r0", ["loopback", "r0"], generation=0)
    rec = [r, fdc.active_index, dict(fdc.counters)]
    dials = dead.calls
    fdc.renew("r0", r["fence"])
    rec.append(dead.calls == dials)    # the dead one is never dialled again
    # a typed refusal from the REAL primary is an answer
    rec += [_raised(lambda: fdc.renew("r0", r["fence"] + 99)),
            fdc.active_index]
    sb2 = p.dir.FleetDirectory(lease_ttl_s=1.0, role=p.dir.STANDBY)
    refusers = p.repl.FailoverDirectoryClient(
        [_DeadTransport(p), p.tr.LoopbackTransport(sb2.handle)])
    rec += [_raised(refusers.snapshot),
            _raised(lambda: fdc.not_a_directory_method()),
            _raised(lambda: p.repl.FailoverDirectoryClient([])),
            dict(fdc.counters)]
    return rec


def test_failover_client_walks_endpoints_but_typed_answers_stand():
    rec = _both(_failover_script)
    r, active, counters, not_redialled, typed, still, last, attr, empty, \
        _ = rec
    assert r["fence"] >= 1 and active == 2
    assert counters == {"calls": 1, "failovers": 1, "not_primary_skips": 1,
                        "transport_skips": 1}
    assert not_redialled
    assert typed == "StaleFencingToken" and still == 2
    assert last == "NotPrimary"               # every endpoint refused
    assert attr == "AttributeError" and empty == "ValueError"


# ----------------------------- delayed duplicates + clock skew


def _replay_script(p):
    clock = FakeClock()
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock)
    net = p.tr.FaultyTransport(p.tr.LoopbackTransport(d.handle), seed=5)
    dc = p.dir.DirectoryClient(net)
    f0 = dc.register("r0", ["loopback", "r0"], generation=0)["fence"]
    dc.renew("r0", f0)             # the frame the network holds
    clock.advance(0.3)
    rec = [net.replay_last(timeout_s=0.5)]   # same incarnation: harmless
    clock.advance(1.5)
    rec.append(d.rpc_confirm_dead(replica_id="r0", fence=f0)["dead"])
    clean = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    f1 = clean.register("r0", ["loopback", "r0"], generation=1,
                        min_fence=f0)["fence"]
    rec.append(f1 > f0)
    clock.advance(0.5)             # the held frame lands past the boundary
    expires = d._members["r0"].lease_expires
    rec += [_raised(lambda: net.replay_last(timeout_s=0.5)),
            net.stats["replayed"], d._members["r0"].lease_expires == expires,
            d.counters["stale_fence_rejects"], _events(d)]
    return rec


def test_replay_last_renew_across_reregistration_is_fenced():
    """A renew frame held across the agent's re-registration quotes the
    SUPERSEDED fence: refused typed, the new lease not extended."""
    rec = _both(_replay_script)
    assert rec[:7] == [{"lease_ttl_s": 1.0}, True, True,
                       "StaleFencingToken", 2, True, 1]


def _skewed_pair(p, agent_clock, dir_clock, ttl=1.0):
    d = p.dir.FleetDirectory(lease_ttl_s=ttl, time_fn=dir_clock)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    a = p.agent.ReplicaAgent(
        "r0", lambda g: p.agent.ScriptedEngine(token_delay_s=0), dc,
        renew_period_s=3600.0, time_fn=agent_clock)
    a.engine = a._factory(0)
    a._register(min_fence=0)
    return d, dc, a


def _fast_directory_script(p):
    aclk, dclk = FakeClock(), FakeClock()
    d, dc, a = _skewed_pair(p, aclk, dclk)
    fence0 = a.fence
    rec = []
    for _ in range(6):
        aclk.advance(1.0 / 3.0)
        dclk.advance(4.0 / 3.0)
        rec.append(a.renew_once())
    rec += [a.state, a.fence == fence0, dict(a.counters),
            dict(d.counters), dc.confirm_dead("r0", fence0)["dead"]]
    a.shutdown()
    return rec


def test_clock_skew_fast_directory_late_renewals_revive():
    """The directory's clock runs 4x the agent's: every renewal lands
    late, and a late renewal before confirm_dead REVIVES the lease, so
    the member never flaps."""
    rec = _both(_fast_directory_script)
    assert rec[:6] == [True] * 6
    state, same, acount, dcount, dead = rec[6:]
    assert state == "active" and same
    assert acount["self_fences"] == 0 and acount["reregisters"] == 0
    assert dcount["late_renewals"] == 6 and dcount["confirmed_dead"] == 0
    assert dead is False


def _fast_agent_script(p):
    aclk, dclk = FakeClock(), FakeClock()
    d, dc, a = _skewed_pair(p, aclk, dclk)
    fence0 = a.fence
    rec = []
    for _ in range(6):
        aclk.advance(4.0 / 3.0)
        dclk.advance(1.0 / 3.0)
        rec.append(a.renew_once())
    rec += [a.state, a.counters["self_fences"], d.counters["late_renewals"]]
    a.rpc_inject_partition(duration_s=10_000.0)   # the directory is gone
    aclk.advance(1.2)              # past the agent's deadline
    dclk.advance(0.3)              # the directory's lease still live
    a.renew_once()
    v = d.rpc_confirm_dead(replica_id="r0", fence=fence0)
    rec += [a.state, v["dead"], v["lease_remaining_s"] > 0]
    a.shutdown()
    return rec


def test_clock_skew_fast_agent_fences_before_directory_expiry():
    """The agent's clock runs 4x the directory's: with the directory
    gone the agent self-fences STRICTLY before the directory's lease
    runs out."""
    rec = _both(_fast_agent_script)
    assert rec == [True] * 6 + ["active", 0, 0, "fenced", False, True]


# ------------------------------------------------ router cache + ETA


def _cache_fleet(p, n=3):
    d = p.dir.FleetDirectory(lease_ttl_s=5.0)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    agents = {}
    for i in range(n):
        rid = f"a{i}"
        agents[rid] = p.agent.ReplicaAgent(
            rid, lambda g: p.agent.ScriptedEngine(token_delay_s=0.0005),
            dc, renew_period_s=0.05).start()
    r = p.router.FleetRouter(
        dc, lambda addr: p.tr.LoopbackTransport(agents[addr[1]].handle),
        seed=7, snapshot_ttl_s=60.0, poll_interval_s=0.002)
    return d, agents, r


def _surgery_script(p):
    d, agents, r = _cache_fleet(p)
    want = p.agent.scripted_completion
    try:
        h = r.submit([1, 2, 3], max_new_tokens=4)
        rec = [h.result() == want([1, 2, 3], 4)]
        misses0 = r.counters["snapshot_misses"]
        victim = h.replica_idx
        r._invalidate_member(victim)
        live = r._members(set())
        rec += [misses0 >= 1, r.counters["member_invalidations"],
                victim not in live, len(live)]
        ok = True
        for i in range(6):
            hh = r.submit([i], max_new_tokens=2)
            ok &= hh.replica_idx != victim and hh.result() == want([i], 2)
        hits, misses = (r.counters["snapshot_hits"],
                        r.counters["snapshot_misses"])
        rec += [ok, misses == misses0, hits >= 7, hits / (hits + misses)
                > 0.7]
        r._invalidate_snapshot()   # a full refresh restores the victim
        rec.append(victim in r._members(set()))
    finally:
        r.shutdown()
        for a in agents.values():
            a.shutdown()
    return rec


def test_router_member_invalidation_is_surgical():
    """Evicting one suspect costs no one else a directory round-trip:
    the rest of the snapshot stays cached and routing skips the evicted
    member until the next refresh."""
    assert _both(_surgery_script) == [True, True, 1, True, 2, True, True,
                                      True, True, True]


def _eta_script(p):
    d = p.dir.FleetDirectory(lease_ttl_s=1.0)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    f = dc.register("a0", ["loopback", "a0"], generation=0)["fence"]
    # a saturated replica: queue full, a tiny shed hint
    dc.renew("a0", f, load={"max_queued": 1, "queue_depth": 3,
                            "free_slots": 0, "total_slots": 4,
                            "shed_retry_after_s": 0.05})
    r = p.router.FleetRouter(dc, lambda addr: p.tr.LoopbackTransport(
        lambda *a: None), snapshot_ttl_s=0.0)
    rec = []

    def hint():
        try:
            r.submit([1], max_new_tokens=2)
        except Exception as e:   # noqa: BLE001 - the record names it
            return [type(e).__name__, e.retry_after_s]
        return None

    rec.append(hint())             # no autoscaler: the shed hint
    r.capacity_hint_fn = lambda: 7.5
    rec += [hint(), r.counters["all_shed"]]
    dc.deregister("a0", f)
    rec.append(hint())             # empty fleet: max(lease TTL, ETA)
    r.capacity_hint_fn = lambda: (_ for _ in ()).throw(RuntimeError)
    rec.append(hint())             # a broken hint: the lease-TTL floor
    r.shutdown()
    return rec


def test_capacity_eta_joins_all_shed_and_no_member_hints():
    """While an autoscaler provisions, its ETA rides the Retry-After of
    both refusals, so no client is invited back before capacity can
    exist."""
    rec = _both(_eta_script)
    assert rec == [["EngineOverloaded", 0.05], ["EngineOverloaded", 7.5], 2,
                   ["EngineShutdown", 7.5], ["EngineShutdown", 1.0]]


# --------------------------------------------- provider + deployment


def _loopback_provider_script(p):
    clock = FakeClock()
    built, downed = [], []

    class _Agent:
        def __init__(self, rid):
            self.rid = rid
            built.append(rid)

        def shutdown(self):
            downed.append(self.rid)

    pr = p.prov.LoopbackAgentProvider(_Agent, provision_delay_s=5.0,
                                      rid_prefix="t", max_agents=2,
                                      time_fn=clock)
    t1 = pr.request()
    rec = [t1, pr.ready(t1), pr.eta_s(t1)]
    clock.advance(2.0)
    rec += [pr.eta_s(t1), list(built)]
    clock.advance(3.0)
    rec += [pr.ready(t1), list(built), pr.ready(t1), list(built),
            pr.eta_s(t1), pr.request(), _raised(pr.request),
            dict(pr.stats)]
    pr.release(t1)
    rec.append(list(downed))
    pr.release(t1)                 # idempotent
    rec += [dict(pr.stats), pr.eta_s("t-404"), pr.ready("t-404")]
    return rec


def test_loopback_agent_provider_ticket_lifecycle():
    rec = _both(_loopback_provider_script)
    assert rec[:5] == ["t-1", False, pytest.approx(5.0), pytest.approx(3.0),
                       []]
    assert rec[5:10] == [True, ["t-1"], True, ["t-1"], 0.0]   # one build
    assert rec[10:12] == ["t-2", "CapacityUnavailable"]
    assert rec[12]["denied"] == 1
    assert rec[13] == ["t-1"] and rec[14]["released"] == 1
    assert rec[15:] == [0.0, False]
    assert tprov.CapacityUnavailable is tnp_provider.CapacityUnavailable


@pytest.fixture(scope="module")
def jax_tiny():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    return params, sd


def _deployment_script(dep, ref):
    want = ref([1, 2, 3])
    rec = [dep([1, 2, 3]) == want]
    auto = dep.autoscaler()
    rec += [type(auto).__name__, type(auto.provider).__name__,
            auto.policy.min_replicas, auto.policy.max_replicas,
            dep._engine.active_count()]
    # one provisioning round by hand: ticket -> loopback agent ->
    # a registered member the router routes to
    t = auto.provider.request()
    rec.append(auto.provider.ready(t))
    idx = dep._engine.add_replica_for_ticket(t)
    rec += [dep._engine.active_count(), t in dep._fleet_agents]
    served = {dep({"prompt_ids": [9, 9], "echo_replica": True})
              ["replica"].split(":")[0] for _ in range(16)}
    rec += [t in served, dep({"prompt_ids": [1, 2, 3]}) == want]
    # retire it through the router: drain, tombstone, evict
    rec.append(dep._engine.scale_down(1, rids=[t]) == [idx])
    auto.provider.release(t)
    rec += [dep._engine.active_count(),
            dep._fleet_directory.rpc_stats()["tombstones"], want]
    return rec


def test_llm_deployment_fleet_autoscale_serves_and_scales(jax_tiny):
    """``fleet=`` with ``autoscale=True`` attaches a PoolAutoscaler
    driving the router through a LoopbackAgentProvider, and the stack
    still answers with the single engine's greedy tokens: the JAX
    package's for the same weights."""
    params, sd = jax_tiny
    kw = dict(fleet=1, autoscale=True, autoscale_max_replicas=3,
              autoscale_interval_s=3600.0, max_new_tokens=4, max_slots=4)
    cfg = tl.llama_tiny(dtype=torch.float32)
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    deps = {"torch": (tllm.LlamaDeployment(cfg, sd, device="cpu", **kw),
                      tllm.LlamaDeployment(cfg, sd, device="cpu",
                                           max_new_tokens=4, max_slots=4)),
            "jax": (jllm.LlamaDeployment(jcfg, params, **kw),
                    jllm.LlamaDeployment(jcfg, params, max_new_tokens=4,
                                         max_slots=4))}
    rec = {}
    try:
        for name, (dep, ref) in deps.items():
            rec[name] = _deployment_script(dep, ref)
    finally:
        for name, (dep, ref) in deps.items():
            if dep._autoscaler is not None:
                dep._autoscaler.stop()
            if dep._engine is not None:
                dep._engine.shutdown()
            for a in dep._fleet_agents.values():
                a.shutdown()
            if ref._engine is not None:
                ref._engine.shutdown()
    assert rec["torch"] == rec["jax"]
    assert rec["torch"][:-1] == [True, "PoolAutoscaler",
                                 "LoopbackAgentProvider", 1, 3, 1, True, 2,
                                 True, True, True, True, 1, {"auto-1": 0}]


# ------------------------------------------------ across the packages


def _write_dir(p, root):
    """A directory's life on disk: a standby takes two replicated
    members, promotes (epoch 1, the fence folded), then registers,
    deregisters and confirms a death; a torn tail ends the log."""
    clock = FakeClock()
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock, data_dir=root,
                             role=p.dir.STANDBY, snapshot_every=5)
    for seq, (rid, fence) in enumerate((("r0", 3), ("r1", 4)), 1):
        d.rpc_repl_apply(epoch=0, seq=seq,
                         record={"op": "member", "replica_id": rid,
                                 "addr": ["loopback", rid],
                                 "generation": 1, "fence": fence,
                                 "page_size": 8, "role": "unified"})
    d.rpc_promote(reason="test")
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    f2 = dc.register("r2", ["loopback", "r2"], generation=0)["fence"]
    dc.deregister("r2", f2)
    dc.register("r3", ["loopback", "r3"], generation=4)
    clock.advance(2.0)
    dc.renew("r0", 3)
    dc.confirm_dead("r1", 4)
    d._wal.close()
    return d


def _recovered(p, root):
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, data_dir=root)
    st = d.rpc_stats()
    out = {"members": sorted((m["replica_id"], m["generation"], m["fence"],
                              m["page_size"], m["role"])
                             for m in d.rpc_snapshot()["members"]),
           "tombstones": st["tombstones"], "fence": st["fence_counter"],
           "epoch": st["epoch"], "role": st["role"],
           "recovered": st["counters"]["recovered_members"],
           "torn": st["counters"]["wal_torn_truncated"]}
    d._wal.close()
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_data_dir_recovers_across_the_packages(tmp_path, writer):
    """A data directory written by one package's directory is recovered
    by the other's with the same members, fences, tombstones and epoch:
    the on-disk format is one."""
    w = _PKGS[writer]
    src = str(tmp_path / "src")
    d = _write_dir(w, src)
    want = {"members": sorted((m.replica_id, m.generation, m.fence,
                               m.page_size, m.role)
                              for m in d._members.values()),
            "tombstones": dict(d._tombstones), "fence": d._fence_counter,
            "epoch": d.epoch, "role": d.role}
    w.wal.inject_torn_tail(src)
    got = {}
    for reader in ("jax", "torch"):
        copy = tmp_path / f"copy-{reader}"
        copy.mkdir()
        for name in os.listdir(src):
            (copy / name).write_bytes((Path(src) / name).read_bytes())
        got[reader] = _recovered(_PKGS[reader], str(copy))
    assert got["torch"] == got["jax"]
    assert {k: got["torch"][k] for k in want} == want
    assert want["epoch"] == 1 and want["tombstones"] == {"r1": 1, "r2": 0}
    assert want["fence"] > 4 + tdir.FENCE_EPOCH_STRIDE
    assert got["torch"]["torn"] == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_torn_tail_is_truncated_by_the_other_package(tmp_path, writer):
    w = _PKGS[writer]
    reader = _PKGS["torch" if writer == "jax" else "jax"]
    root = str(tmp_path)
    log = w.wal.DirectoryWAL(root, snapshot_every=1000)
    for i in range(3):
        log.append({"op": "member", "replica_id": f"r{i}",
                    "addr": ["loopback", f"r{i}"], "generation": 0,
                    "fence": i + 1})
    log.close()
    with open(os.path.join(root, "wal.log"), "rb") as fh:
        intact = fh.read()
    w.wal.inject_torn_tail(root)
    snap, records = (r := reader.wal.DirectoryWAL(root)).load()
    assert snap is None and [x["fence"] for x in records] == [1, 2, 3]
    assert r.stats["torn_records_truncated"] == 1
    with open(os.path.join(root, "wal.log"), "rb") as fh:
        assert fh.read() == intact          # truncated in place
    assert w.wal.wal_record_count(root) == \
        reader.wal.wal_record_count(root) == 3


def test_jax_primary_replicates_to_a_port_standby_that_promotes():
    """A JAX primary streams over sockets to a port standby, which then
    promotes: no fencing token regresses, the old primary's next delta
    is refused and its replicator stands down."""
    sb = tdir.FleetDirectory(lease_ttl_s=1.0, role=tdir.STANDBY)
    srv = ttr.SocketServer(sb.handle)
    repl = jrepl.Replicator([jtr.SocketTransport(srv.addr)], timeout_s=2.0)
    prim = jdir.FleetDirectory(lease_ttl_s=1.0, replicator=repl)
    repl.attach(prim).start()
    jc = jdir.DirectoryClient(jtr.LoopbackTransport(prim.handle))
    try:
        fences = [jc.register(f"r{i}", ["loopback", f"r{i}"],
                              generation=0)["fence"] for i in range(3)]
        jc.deregister("r1", fences[1])
        assert _wait(lambda: repl.stats["applied"] == 4)
        assert sorted(sb._members) == ["r0", "r2"]
        assert sb._tombstones == {"r1": 0}
        assert sb.counters["repl_gaps"] == 0
        _python_scalars(sb._durable_payload())
        out = tdir.DirectoryClient(ttr.SocketTransport(srv.addr)).promote(
            reason="failover")
        assert out["promoted"] is True and out["epoch"] == 1
        tc = tdir.DirectoryClient(ttr.LoopbackTransport(sb.handle))
        f_new = tc.register("r3", ["loopback", "r3"], generation=0)["fence"]
        # the primary may have issued tokens the standby never saw
        assert f_new > max(fences) + tdir.FENCE_EPOCH_STRIDE
        assert tc.renew("r0", fences[0]) == {"lease_ttl_s": 1.0}
        jc.register("r4", ["loopback", "r4"], generation=0)   # the zombie
        assert _wait(lambda: repl.stats["superseded"] == 1)
        assert "r4" not in sb._members
        assert sb.counters["repl_stale_epoch_rejects"] == 1
    finally:
        repl.stop()
        srv.stop()


# ---------------------------------------------------- marker audit

# process-spawning surfaces of the port's fleet tests; the reference's
# audit (tests/test_fleet_durability.py) reads every test file for its
# own list, which budgets a test naming one of them at 5 s or less
_HEAVY = ("_FleetProcs", "FleetCapacityProvider", "subprocess",
          "phase_fleet_path", "Popen", "run_fleet_chaos",
          "phase_fleet_chaos")
_REF_HEAVY = ("run_fleet_chaos", "FleetCapacityProvider",
              "_spawn_fleet_proc", "subprocess.Popen", "run_fleet_autoscale")
_BUDGET_S = 300.0
_REF_BUDGET_S = 5.0


def _slow_marked(fn: ast.FunctionDef) -> bool:
    return any("slow" in ast.dump(dec) for dec in fn.decorator_list)


def _budgets(fn: ast.FunctionDef) -> list:
    """The constant ``duration_s=`` budgets of the calls in ``fn``."""
    return [kw.value.value for node in ast.walk(fn)
            if isinstance(node, ast.Call) for kw in node.keywords
            if kw.arg == "duration_s" and isinstance(kw.value, ast.Constant)
            and isinstance(kw.value.value, (int, float))]


def test_marker_audit_process_spawning_fleet_tests():
    """Every test of tests/test_torch_fleet*.py whose body starts
    processes is ``slow``-marked or runs under its own time budget (a
    constant ``duration_s=`` of at most 300 s; at most 5 s where it
    names a surface of the reference's audit)."""
    offenders = []
    for path in sorted(Path(__file__).resolve().parent.glob(
            "test_torch_fleet*.py")):
        src = path.read_text(encoding="utf-8")
        for fn in ast.walk(ast.parse(src)):
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name.startswith("test_")):
                continue
            body = ast.get_source_segment(src, fn) or ""
            if not any(ind in body for ind in _HEAVY) or _slow_marked(fn):
                continue
            cap = (_REF_BUDGET_S if any(ind in body for ind in _REF_HEAVY)
                   else _BUDGET_S)
            if not any(b <= cap for b in _budgets(fn)):
                offenders.append(f"{path.name}::{fn.name}")
    assert not offenders, (
        f"process-spawning tests must be @pytest.mark.slow or run under a "
        f"duration_s budget: {offenders}")
