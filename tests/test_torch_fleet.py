"""The port's fleet control plane (``ray_tpu_torch/serve/fleet``:
directory, agent, router, and ``LlamaDeployment(fleet=)``) against the
JAX package's, on the CPU.

- The cases of tests/test_fleet.py, on the reference's fake clocks.
  The deterministic ones (the directory's fencing, tombstones, prefix
  index; the agent's self-fence) run one script through both packages
  and compare records; the threaded loopback ones run on the port and
  hold every completion to ``scripted_completion``, which equals the
  reference's. The end-to-end cases run on loopback and on socket
  transports.
- The router's seeded routes equal the reference's for the same seed
  and snapshots; routes since an advertisement count as load (the
  port's repair of the reference's herding).
- ``LlamaDeployment(fleet=2)`` at ``llama_tiny`` fp32 gives the single
  engine's greedy tokens, and the JAX package's for the same weights.
- Everything on the wire is JSON of Python scalars.
- The fleet's processes are tests/test_torch_fleet_procs.py's; the
  telemetry plane is tests/test_torch_fleet_telemetry.py's and the
  reference's campaign cases (tests/test_fleet.py:616, :637) are
  tests/test_torch_fleet_chaos.py's.
"""
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import errors as jerr
from ray_tpu.serve import llm as jllm
from ray_tpu.serve.fleet import agent as jagent
from ray_tpu.serve.fleet import directory as jdir
from ray_tpu.serve.fleet import router as jrouter
from ray_tpu.serve.fleet import transport as jtr
from ray_tpu.serve.fleet import wire as jwire
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.fleet import agent as tagent
from ray_tpu_torch.serve.fleet import directory as tdir
from ray_tpu_torch.serve.fleet import router as trouter
from ray_tpu_torch.serve.fleet import transport as ttr
from ray_tpu_torch.serve.fleet import wire as twire
from ray_tpu_torch.serve.fleet.agent import (ReplicaAgent, ScriptedEngine,
                                             scripted_completion)
from ray_tpu_torch.serve.fleet.directory import (DirectoryClient,
                                                 FleetDirectory)
from ray_tpu_torch.serve.fleet.router import FleetRouter
from ray_tpu_torch.serve.fleet.transport import (FaultyTransport,
                                                 LoopbackTransport,
                                                 SocketServer,
                                                 SocketTransport, Transport,
                                                 TransportError,
                                                 TransportTimeout)
from ray_tpu_torch.serve.fleet.wire import (AgentFenced, StaleFencingToken,
                                            UnknownMember)

EngineDraining = terr.EngineDraining
EngineOverloaded = terr.EngineOverloaded
EngineShutdown = terr.EngineShutdown

_PKGS = {
    "jax": types.SimpleNamespace(dir=jdir, agent=jagent, router=jrouter,
                                 tr=jtr, wire=jwire, errors=jerr),
    "torch": types.SimpleNamespace(dir=tdir, agent=tagent, router=trouter,
                                   tr=ttr, wire=twire, errors=terr),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _both(case):
    """``case(pkg)`` for both packages; the two records must be equal."""
    rec = {pkg: case(_PKGS[pkg]) for pkg in ("jax", "torch")}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def _raised(fn):
    """The type name ``fn()`` raises, or its result."""
    try:
        return fn()
    except Exception as e:   # noqa: BLE001 - the record names the type
        return type(e).__name__


# ---------------------------------------------------------- directory


def _fencing_script(p):
    clock = FakeClock()
    d = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock)
    dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
    rec = []
    r = dc.register("r0", ["loopback", "r0"], generation=0)
    fence0 = r["fence"]
    rec.append(r)
    rec.append(_raised(lambda: dc.renew("r0", fence0 + 99)))
    rec.append(_raised(lambda: dc.renew("nope", 1)))
    rec.append(dc.renew("r0", fence0))
    rec.append(dc.confirm_dead("r0", fence0))
    clock.advance(1.5)
    rec.append(dc.snapshot())
    rec.append(dc.confirm_dead("r0", fence0))
    rec.append(_raised(lambda: dc.register("r0", ["loopback", "r0"],
                                           generation=0)))
    rec.append(dc.register("r0", ["loopback", "r0"], generation=1,
                           min_fence=fence0))
    rec.append(dc.confirm_dead("r0", fence0))
    rec.append(dc.stats())
    rec.append(dc.events())
    rec.append(dc.role())
    rec.append(dc.ping())
    return rec


def test_directory_fencing_and_tombstones():
    rec = _both(_fencing_script)
    r, stale, unknown, renew, alive, snap, dead, zombie, r2, sup = rec[:10]
    assert r["lease_ttl_s"] == 1.0
    assert (stale, unknown) == ("StaleFencingToken", "UnknownMember")
    assert renew == {"lease_ttl_s": 1.0}
    # a live lease is NOT dead, however the transport looked
    assert alive["dead"] is False and alive["lease_remaining_s"] > 0
    assert snap["members"][0]["expired"] is True
    assert dead["dead"] is True and dead["reason"] == "lease_expired"
    assert zombie == "StaleFencingToken"
    assert r2["fence"] > r["fence"]
    assert sup["dead"] is True and sup["reason"] == "superseded"
    stats = rec[10]
    assert stats["tombstones"] == {"r0": 0}
    assert stats["counters"]["zombie_register_rejects"] == 1


def test_directory_restart_fence_monotonic_via_min_fence():
    def case(p):
        d = p.dir.FleetDirectory(lease_ttl_s=1.0)
        dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
        return dc.register("r0", ["loopback", "r0"], generation=3,
                           min_fence=42)

    r = _both(case)
    assert r["fence"] == 43 and r["generation"] == 3


def test_directory_deregister_tombstones():
    def case(p):
        d = p.dir.FleetDirectory(lease_ttl_s=1.0)
        dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
        f = dc.register("r1", ["loopback", "r1"], generation=2)["fence"]
        return [f, _raised(lambda: dc.deregister("r1", f + 1)),
                dc.deregister("r1", f),
                _raised(lambda: dc.register("r1", ["loopback", "r1"],
                                            generation=2)),
                dc.register("r1", ["loopback", "r1"], generation=3),
                d.rpc_stats()]

    f, stale, ok, zombie, again, _ = _both(case)
    assert stale == "StaleFencingToken" and ok == {"ok": True}
    assert zombie == "StaleFencingToken" and again["fence"] > f


def test_directory_prefix_holders_ranked_and_lease_filtered():
    """Digests piggyback on renewals, holders rank by matched contiguous
    prefix, and lapsed, wedged or superseded incarnations never appear."""
    def case(p):
        clock = FakeClock()
        d = p.dir.FleetDirectory(lease_ttl_s=1.0, time_fn=clock)
        dc = p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))
        f = {rid: dc.register(rid, ["loopback", rid], generation=0)["fence"]
             for rid in ("r0", "r1", "r2")}
        chain = [11, 22, 33, 44]
        dc.renew("r0", f["r0"], digest=chain)
        dc.renew("r1", f["r1"], digest=chain[:2])
        dc.renew("r2", f["r2"], digest=[11, 33, 44])
        rec = [dc.prefix_holders(chain), dc.prefix_holders(chain, limit=1),
               dc.prefix_holders([999])]
        dc.renew("r1", f["r1"], digest=chain[:2], wedged=True)
        rec.append(dc.prefix_holders(chain))
        clock.advance(1.5)
        rec.append(dc.prefix_holders(chain))
        dc.confirm_dead("r0", f["r0"])
        f2 = dc.register("r0", ["loopback", "r0"], generation=1,
                         min_fence=f["r0"])["fence"]
        rec.append(dc.prefix_holders(chain))
        dc.renew("r0", f2, digest=chain)
        rec += [dc.prefix_holders(chain), f, f2, dc.stats()]
        return rec

    rec = _both(case)
    first, one, none, wedged, lapsed, ghost, back, f, f2 = rec[:9]
    assert [h["replica_id"] for h in first["holders"]] == ["r0", "r1", "r2"]
    assert [h["n_matched"] for h in first["holders"]] == [4, 2, 1]
    assert first["holders"][0]["fence"] == f["r0"]
    assert [h["replica_id"] for h in one["holders"]] == ["r0"]
    assert none["holders"] == []
    assert "r1" not in [h["replica_id"] for h in wedged["holders"]]
    assert lapsed["holders"] == [] and ghost["holders"] == []
    assert back["holders"][0]["generation"] == 1
    assert back["holders"][0]["fence"] == f2


def test_directory_later_slices_raise_not_implemented():
    """What still waits: the fleet's fourth slice, the in-process pool
    campaign of ``serve/chaos.py``. The third slice's telemetry scrape of
    the directory and of the agent answers now (held against the
    reference in tests/test_torch_fleet_telemetry.py), and the second
    slice's surface (``data_dir``, the standby role, ``replicator``, the
    ``repl_*`` and ``promote`` RPCs) builds and answers: see
    tests/test_torch_fleet_durability.py."""
    from ray_tpu_torch.serve import chaos
    d = FleetDirectory()
    assert d.handle("telemetry", {})["role"] == "directory"
    a = ReplicaAgent("r0", lambda g: ScriptedEngine(token_delay_s=0),
                     DirectoryClient(LoopbackTransport(d.handle)))
    assert a.handle("telemetry", {})["replica_id"] == "r0"
    with pytest.raises(NotImplementedError, match="fourth slice"):
        chaos.ChaosInjector(None, [])
    with pytest.raises(UnknownMember):
        d.handle("no_such_method", {})
    for method, args in (("promote", {}),
                         ("repl_sync", {"epoch": 1, "seq": 1, "state": {}}),
                         ("repl_apply", {"epoch": 1, "seq": 1,
                                         "record": {}})):
        # a primary takes no replication and is promoted already
        if method == "promote":
            assert d.handle(method, args)["promoted"] is False
        else:
            with pytest.raises(StaleFencingToken):
                d.handle(method, args)


# ---------------------------------------------------------- transport


def test_wire_envelope_and_typed_errors():
    req = twire.request("submit", {"key": "k"}, trace_id="t1")
    assert twire.decode(twire.encode(req)) == req
    assert twire.encode(req) == jwire.encode(req)
    e = EngineOverloaded("full")
    e.retry_after_s = 0.25
    with pytest.raises(EngineOverloaded) as ei:
        twire.raise_error(twire.err(e)["error"])
    assert ei.value.retry_after_s == 0.25
    with pytest.raises(twire.WireError):
        twire.raise_error({"type": "SomethingElse", "msg": "x"})
    assert issubclass(StaleFencingToken, EngineShutdown)
    assert issubclass(UnknownMember, EngineShutdown)
    assert issubclass(AgentFenced, EngineDraining)


def test_socket_transport_roundtrip_and_gate():
    """``SocketServer(gate=)``: a closed gate drops the connection with
    no answer, so the client sees a ``TransportError``, never a typed
    refusal; the reference's client sees the same of the port's server."""
    open_gate = {"open": True}

    def handler(method, args, trace_id):
        if method == "boom":
            raise StaleFencingToken("zombie write")
        if method == "sleep":
            time.sleep(args["s"])
        return {"method": method, "args": args, "trace_id": trace_id}

    srv = SocketServer(handler, gate=lambda: open_gate["open"])
    try:
        t = SocketTransport(srv.addr)
        out = t.call("echo", {"a": 1}, trace_id="tid")
        assert out == {"method": "echo", "args": {"a": 1},
                       "trace_id": "tid"}
        assert jtr.SocketTransport(srv.addr).call(
            "echo", {"a": 1}, trace_id="tid") == out
        with pytest.raises(StaleFencingToken):
            t.call("boom", {})
        with pytest.raises(TransportTimeout):
            t.call("sleep", {"s": 1.0}, timeout_s=0.05)
        open_gate["open"] = False
        with pytest.raises(TransportError) as ei:
            t.call("echo", {}, timeout_s=5.0)
        assert not isinstance(ei.value, twire.WireError)
        with pytest.raises(jtr.TransportError):
            jtr.SocketTransport(srv.addr).call("echo", {}, timeout_s=5.0)
        open_gate["open"] = True
        assert t.call("echo", {})["method"] == "echo"
        dead = SocketTransport(("127.0.0.1", srv.addr[1]))
        srv.stop()
        with pytest.raises(TransportError):
            dead.call("echo", {}, timeout_s=5.0)
    finally:
        srv.stop()


def test_frame_rejects_oversized_announcement():
    import socket as _socket
    import struct

    from ray_tpu_torch.serve.fleet.transport import MAX_FRAME, recv_frame
    a, b = _socket.socketpair()
    try:
        a.sendall(struct.pack(">I", MAX_FRAME + 1))
        with pytest.raises(TransportError):
            recv_frame(b)
    finally:
        a.close()
        b.close()


# ----------------------------------------------------- agent fencing


def _loopback_directory(p, clock=None):
    d = p.dir.FleetDirectory(lease_ttl_s=1.0,
                             **({"time_fn": clock} if clock else {}))
    return d, p.dir.DirectoryClient(p.tr.LoopbackTransport(d.handle))


def _self_fence_script(p):
    """The fencing state machine on a fake clock: a partitioned agent's
    lease lapses, it self-fences no later than the directory could
    confirm it dead, and after the heal it re-joins as generation + 1
    with an empty request table."""
    clock = FakeClock()
    d, dc = _loopback_directory(p, clock)
    a = p.agent.ReplicaAgent(
        "r0", lambda g: p.agent.ScriptedEngine(token_delay_s=0), dc,
        renew_period_s=3600.0, time_fn=clock)
    a.engine = a._factory(0)
    a._register(min_fence=0)
    fence0 = a.fence
    a.engine.token_delay_s = 30.0
    sub = a.rpc_submit(key="k0", prompt_ids=[1, 2], max_new_tokens=4,
                       deadline_s=None, fence=fence0)
    rec = [sub, a.state]
    a.rpc_inject_partition(duration_s=100.0)
    clock.advance(0.5)
    rec += [a.renew_once(), a.state]
    clock.advance(1.0)
    rec += [a.renew_once(), a.state, dict(a.counters),
            d.rpc_confirm_dead(replica_id="r0", fence=fence0)]
    rec.append(_raised(lambda: a.rpc_submit(
        key="k1", prompt_ids=[3], max_new_tokens=1, deadline_s=None,
        fence=fence0)))
    rec.append(a.rpc_poll(rid=sub["rid"])["error"]["type"])
    rec += [a.renew_once(), a.state]
    clock.advance(200.0)
    a.renew_once()
    rec += [a.state, a.generation, a.fence > fence0, dict(a.counters),
            _raised(lambda: a.rpc_poll(rid=sub["rid"])),
            _raised(lambda: dc.renew("r0", fence0)),
            [e[2] for e in a.events.snapshot()]]
    a.shutdown()
    return rec


def test_agent_lease_lapse_self_fences_and_recovers():
    rec = _both(_self_fence_script)
    assert rec[0]["dedup"] is False and rec[1] == "active"
    assert rec[2:4] == [False, "active"]           # inside the lease
    assert rec[4:6] == [False, "fenced"]           # lapsed: self-fenced
    assert rec[6]["self_fences"] == 1
    assert rec[7]["dead"] is True
    assert rec[8] == "AgentFenced" and rec[9] == "AgentFenced"
    assert rec[10:12] == [False, "fenced"]         # still partitioned
    assert rec[12:15] == ["active", 1, True]       # re-joined, gen + 1
    assert rec[15]["reregisters"] == 1 and rec[15]["refused_fenced"] == 1
    assert rec[16] == "EngineShutdown" and rec[17] == "StaleFencingToken"


def test_agent_reregisters_after_directory_restart_same_generation():
    """A directory restart is invisible to clients: the agent sees
    UnknownMember on renewal and re-registers under the same generation,
    keeping its request table."""
    p = _PKGS["torch"]
    clock = FakeClock()
    d, dc = _loopback_directory(p, clock)
    a = ReplicaAgent("r0", lambda g: ScriptedEngine(token_delay_s=0), dc,
                     renew_period_s=3600.0, time_fn=clock)
    a.engine = a._factory(0)
    a._register(min_fence=0)
    fence0 = a.fence
    sub = a.rpc_submit(key="k0", prompt_ids=[1], max_new_tokens=2,
                       deadline_s=None, fence=fence0)
    d._members.clear()
    clock.advance(0.3)
    assert a.renew_once() is False
    assert a.state == "active" and a.generation == 0
    assert a.fence > fence0
    deadline = time.monotonic() + 30
    while not a.rpc_poll(rid=sub["rid"])["done"]:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    assert a.rpc_poll(rid=sub["rid"])["tokens"] == scripted_completion([1], 2)
    a.shutdown()


def test_agent_dedups_a_duplicate_submit_and_drains():
    """The router-minted key: a second delivery of one submit returns
    the same request; ``rpc_drain`` of an idle agent deregisters it,
    clean, and its generation is retired; a drained agent still answers
    the telemetry scrape."""
    d, dc = _loopback_directory(_PKGS["torch"])
    a = ReplicaAgent("r0", lambda g: ScriptedEngine(token_delay_s=0), dc,
                     renew_period_s=3600.0).start()
    try:
        first = a.rpc_submit(key="k", prompt_ids=[4, 2], max_new_tokens=3)
        again = a.rpc_submit(key="k", prompt_ids=[4, 2], max_new_tokens=3)
        assert again == dict(first, dedup=True)
        assert a.counters["submits"] == 1 and a.counters["dup_submits"] == 1
        assert a.rpc_drain(timeout_s=30.0) == {"clean": True}
        assert d.rpc_stats()["tombstones"] == {"r0": 0}
        with pytest.raises(EngineDraining):
            a.rpc_submit(key="k2", prompt_ids=[1], max_new_tokens=1)
        tel = a.handle("telemetry", {})
        assert "drained" in [e["type"] for e in tel["events"]]
    finally:
        a.shutdown()


def test_scripted_completion_equals_the_reference():
    g = np.random.default_rng(3)
    for n in (1, 5, 40):
        prompt = g.integers(0, 50000, int(g.integers(1, 30))).tolist()
        assert scripted_completion(prompt, n) == \
            jagent.scripted_completion(prompt, n)


# ------------------------------------------------- loopback fleet e2e


class _Fleet:
    """A directory and ``n`` ScriptedEngine agents behind loopback or
    socket transports, and a router over them."""

    def __init__(self, transport, n=3, token_delay_s=0.0005, seed=7,
                 wrap_transport=None, lease_ttl_s=1.0, **router_kw):
        self.d = FleetDirectory(lease_ttl_s=lease_ttl_s)
        self.dc = DirectoryClient(LoopbackTransport(self.d.handle))
        self.agents, self.servers = {}, []
        for i in range(n):
            rid = f"a{i}"
            a = ReplicaAgent(rid, lambda g, _d=token_delay_s:
                             ScriptedEngine(token_delay_s=_d), self.dc,
                             renew_period_s=0.05)
            if transport == "socket":
                srv = SocketServer(a.handle, gate=a.reachable)
                self.servers.append(srv)
                a.addr = ["tcp", srv.addr[0], srv.addr[1]]
            self.agents[rid] = a.start()

        def tf(addr):
            if addr[0] == "tcp":
                t = SocketTransport((addr[1], int(addr[2])))
            else:
                t = LoopbackTransport(self.agents[addr[1]].handle)
            return wrap_transport(addr, t) if wrap_transport else t

        kw = dict(seed=seed, snapshot_ttl_s=0.01, poll_interval_s=0.002)
        kw.update(router_kw)
        self.r = FleetRouter(self.dc, tf, **kw)

    def close(self):
        self.r.shutdown()
        for a in self.agents.values():
            a.shutdown()
        for srv in self.servers:
            srv.stop()


@pytest.mark.parametrize("transport", ["loopback", "socket"])
def test_fleet_end_to_end(transport):
    f = _Fleet(transport)
    r = f.r
    try:
        h = r.submit([3, 1, 4, 1, 5], max_new_tokens=12)
        assert h.result() == scripted_completion([3, 1, 4, 1, 5], 12)
        assert h.replica_idx in f.agents
        assert h.replica_tag == f"{h.replica_idx}:0"
        hs = [r.submit([i, i + 1], max_new_tokens=8, session_id="s1")
              for i in range(6)]
        assert len({x.replica_idx for x in hs}) == 1
        for i, x in enumerate(hs):
            assert x.result() == scripted_completion([i, i + 1], 8)
        assert r.load_report()["replicas"] == 3
        assert r.pool_stats()["counters"]["routed"] >= 7
        assert set(r.member_stats()) == set(f.agents)
        assert r.stats["routed"] >= 7
        assert r.active_count() == 3
        # the autoscaler's surface: an adopted member that is not in the
        # directory is no scale-down candidate; the static floor never is
        assert r.add_replica_for_ticket("r9") == 1
        assert r.scale_down(1) == []
        assert r.active_count() == 3
    finally:
        f.close()


def _consume(h, res, key):
    try:
        res[key] = h.result()
    except BaseException as e:   # noqa: BLE001
        res[key] = e


@pytest.mark.parametrize("transport", ["loopback", "socket"])
def test_fleet_zero_delivery_resubmit_exactly_once(transport):
    """Fence the serving agent before its first token: the router
    resubmits token-identically to another replica exactly once; a fence
    after delivery fails typed instead."""
    f = _Fleet(transport, token_delay_s=0.05)
    r = f.r
    try:
        res = {}
        h = r.submit([9, 9, 9], max_new_tokens=6)
        victim = h.replica_idx
        f.agents[victim].rpc_fence(reason="test")   # nothing delivered
        t = threading.Thread(target=_consume, args=(h, res, "out"))
        t.start()
        t.join(timeout=60)
        assert res.get("out") == scripted_completion([9, 9, 9], 6), res
        assert h.resubmits == 1 and h.replica_idx != victim
        assert f.agents[victim].counters["cancelled_on_fence"] == 1
        h2 = r.submit([4, 4], max_new_tokens=8)
        t2 = threading.Thread(target=_consume, args=(h2, res, "out2"))
        t2.start()
        deadline = time.monotonic() + 60
        while not h2._generated:
            assert time.monotonic() < deadline, "no token delivered"
            time.sleep(0.005)
        f.agents[h2.replica_idx].rpc_fence(reason="mid-stream")
        t2.join(timeout=60)
        assert isinstance(res.get("out2"), EngineShutdown), res
        assert h2.resubmits == 0
    finally:
        f.close()


@pytest.mark.parametrize("transport", ["loopback", "socket"])
def test_fleet_faulty_transport_never_double_delivers(transport):
    """Seeded drop/dup/delay on every router -> agent call: request keys
    dedupe duplicate submits, poll cursors make duplicate polls harmless,
    so every completion is token-identical, while the fault stats show
    that duplicates and drops happened."""
    faulty = []

    def wrap(addr, t):
        # seeded by the replica id on both transports (a socket's port is
        # the kernel's pick, and some ports' seeds injected no fault)
        rid = addr[1] if addr[0] == "loopback" else next(
            r for r, a in f.agents.items() if list(a.addr) == list(addr))
        fl = FaultyTransport(t, seed=sum(map(ord, rid)), drop_p=0.08,
                             dup_p=0.25, delay_p=0.2, delay_s=0.001)
        faulty.append(fl)
        return fl

    f = _Fleet(transport, n=2, wrap_transport=wrap,
               transport_patience_s=60.0, submit_retries=6,
               retry_backoff_s=0.001)
    try:
        prompts = [[i, i + 1, i + 2] for i in range(24)]
        hs = [f.r.submit(p, max_new_tokens=6) for p in prompts]
        for p, h in zip(prompts, hs):
            assert h.result() == scripted_completion(p, 6), p
        stats = [fl.stats for fl in faulty]
        assert sum(s["duplicated"] for s in stats) > 0
        assert sum(s["dropped"] for s in stats) > 0
        admitted = sum(a.counters["submits"] for a in f.agents.values())
        assert admitted == len(prompts) + sum(h.resubmits for h in hs)
    finally:
        f.close()


class _GatedLoopback(Transport):
    """Loopback that honours the agent's partition gate."""

    def __init__(self, agent):
        self._agent = agent
        self._inner = LoopbackTransport(agent.handle)

    def call(self, method, args, *, timeout_s=None, trace_id=None):
        if not self._agent.reachable():
            raise TransportError(f"{self._agent.replica_id} unreachable")
        return self._inner.call(method, args, timeout_s=timeout_s,
                                trace_id=trace_id)


def test_fleet_three_way_race():
    """Lease expiry (a partition) vs a graceful drain vs a hard kill in
    one 3-agent fleet under client load: every admitted request completes
    token-identically or fails typed, the drained agent deregisters, the
    killed one is confirmed dead, the partitioned one self-fences and
    re-joins as generation + 1 (the reference's timings)."""
    d = FleetDirectory(lease_ttl_s=0.3)
    dc = DirectoryClient(LoopbackTransport(d.handle))
    agents = {}
    for i in range(3):
        rid = f"a{i}"
        agents[rid] = ReplicaAgent(
            rid, lambda g: ScriptedEngine(token_delay_s=0.002), dc,
            renew_period_s=0.05).start()
    r = FleetRouter(dc, lambda addr: _GatedLoopback(agents[addr[1]]),
                    seed=13, snapshot_ttl_s=0.02, poll_interval_s=0.002,
                    call_timeout_s=0.5, transport_patience_s=0.4)
    results = {"ok": 0, "typed": 0, "lost": 0, "mismatched": 0}
    rlock = threading.Lock()
    stop = threading.Event()

    def client(cseed):
        i = 0
        while not stop.is_set():
            i += 1
            p = [cseed, i % 50]
            try:
                got = r.submit(p, max_new_tokens=4).result()
                with rlock:
                    results["ok" if got == scripted_completion(p, 4)
                            else "mismatched"] += 1
            except (EngineShutdown, EngineDraining, EngineOverloaded):
                with rlock:
                    results["typed"] += 1
            except BaseException:        # noqa: BLE001
                with rlock:
                    results["lost"] += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.15)
        agents["a0"].rpc_inject_partition(duration_s=0.8)
        threading.Thread(target=lambda: agents["a1"].rpc_drain(timeout_s=2.0),
                         daemon=True).start()
        agents["a2"].engine.force_kill(EngineShutdown("simulated SIGKILL"))
        agents["a2"]._stop.set()
        agents["a2"]._partition_until = float("inf")
        time.sleep(1.6)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    try:
        assert results["lost"] == 0, results
        assert results["mismatched"] == 0, results
        assert results["ok"] > 0, results
        assert agents["a0"].counters["self_fences"] >= 1
        assert agents["a0"].generation >= 1
        assert agents["a0"].state == "active"
        st = d.rpc_stats()
        assert st["counters"]["deregisters"] == 1
        assert "a1" in st["tombstones"]
        assert r.counters["deaths_confirmed"] >= 1
        snap = {m["replica_id"] for m in d.rpc_snapshot()["members"]}
        assert "a2" not in snap and "a1" not in snap and "a0" in snap
        h = r.submit([7, 7], max_new_tokens=4)
        assert h.result() == scripted_completion([7, 7], 4)
        assert h.replica_idx == "a0"
    finally:
        r.shutdown()
        for a in agents.values():
            a.shutdown()


# ------------------------------------------------------ router routes


class _Snapshots:
    """A directory client serving scripted snapshots: every member's
    lease just renewed (a fresh advertisement), loads from ``loads``."""

    def __init__(self, members):
        self.members = members

    def snapshot(self):
        return {"members": [dict(m) for m in self.members],
                "fence_counter": 9, "lease_ttl_s": 1.0, "epoch": 0}

    def confirm_dead(self, rid, fence):
        return {"dead": False, "lease_remaining_s": 1.0}

    def stats(self):
        return {}


class _Admit(Transport):
    def __init__(self, rid):
        self.rid, self.n = rid, 0

    def call(self, method, args, *, timeout_s=None, trace_id=None):
        assert method == "submit"
        self.n += 1
        return {"rid": f"{self.rid}.{self.n}", "dedup": False,
                "generation": 0}


def _members(g):
    out = []
    for i in range(4):
        digest = sorted({int(x) for x in g.integers(0, 50, 6)})
        out.append({"replica_id": f"m{i}", "addr": ["loopback", f"m{i}"],
                    "generation": 0, "fence": i + 1,
                    "lease_remaining_s": 1.0, "expired": False,
                    "wedged": False, "digest": digest, "page_size": 4,
                    "role": "unified",
                    "load": {"outstanding_tokens": int(g.integers(0, 3)),
                             "queue_depth": 0}})
    return out


def test_seeded_routes_equal_the_reference():
    """The same seed and the same fresh snapshots (one per route): both
    routers pick the same members, by the same rule, with the same pull
    hints, over equal loads (P2C), digests (affinity) and sessions."""
    from ray_tpu_torch.serve.prefix_cache import path_hashes
    g = np.random.default_rng(5)
    members = _members(g)
    # one member holds the first two pages of prompt 0
    prompt0 = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    members[2]["digest"] = path_hashes(prompt0, 4)[:2]
    prompts = [prompt0] + [g.integers(0, 50, 9).tolist() for _ in range(31)]
    sessions = [None if i % 3 else f"s{i % 5}" for i in range(32)]

    def case(p):
        r = p.router.FleetRouter(_Snapshots(members), _Admit, seed=11,
                                 snapshot_ttl_s=0.0)
        picks = []
        for prompt, sid in zip(prompts, sessions):
            h = r.submit(prompt, max_new_tokens=4, session_id=sid)
            picks.append(h.replica_idx)
        kinds = [(e[4], e[5]["kind"], e[5]["pages"])
                 for e in r.events.snapshot() if e[2] == "route"]
        return {"picks": picks, "kinds": kinds,
                "pull_hints": r.counters["pull_hints"]}

    rec = _both(case)
    assert len(set(rec["picks"])) > 1
    assert {k for _, k, _ in rec["kinds"]} >= {"p2c", "sticky"}


def test_routes_since_an_advertisement_count_as_load():
    """One stale snapshot (a report as old as the last renewal), a burst
    of 8 concurrent submits: the port's router counts the routes it made
    since the advertisement and spreads the burst 4 / 4; the reference
    reads the stale reports alone and sends all 8 to one member."""
    members = _members(np.random.default_rng(1))[:2]
    for m in members:
        m["digest"] = []
        m["load"] = {"outstanding_tokens": 0, "queue_depth": 0}

    def burst(p):
        r = p.router.FleetRouter(_Snapshots(members), _Admit, seed=3,
                                 snapshot_ttl_s=3600.0)
        hs = []
        threads = [threading.Thread(target=lambda i=i: hs.append(
            r.submit([i, i + 1], max_new_tokens=8)))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        return sorted(h.replica_idx for h in hs)

    assert burst(_PKGS["torch"]) == ["m0"] * 4 + ["m1"] * 4
    assert burst(_PKGS["jax"]) == ["m0"] * 8


# ---------------------------------------------------------- the wire


def test_the_wire_carries_python_ints_only():
    """An agent over a real llama_tiny fp32 engine behind a socket: the
    polls, the load report, the stats and the renewals are JSON of Python
    scalars (``json.dumps`` with no fallback), token ids are ``int``;
    ``_json_safe`` turns numpy and torch scalars into Python numbers."""
    from ray_tpu_torch.serve.fleet.agent import AgentClient, _json_safe
    safe = _json_safe({"a": np.int64(3), "b": torch.tensor(2.5),
                       "c": [np.float32(1.5), torch.tensor([7])],
                       "d": frozenset({np.int64(4)}), "e": torch.device("cpu"),
                       "f": None, "g": True})
    assert safe == {"a": 3, "b": 2.5, "c": [1.5, 7], "d": [4], "e": "cpu",
                    "f": None, "g": True}
    assert type(safe["a"]) is int and type(safe["c"][1]) is int
    d = FleetDirectory(lease_ttl_s=60.0)
    dsrv = SocketServer(d.handle)
    dc = DirectoryClient(SocketTransport(dsrv.addr))
    factory = tagent.model_engine_factory("tiny", device="cpu")
    a = ReplicaAgent("r0", factory, dc, renew_period_s=3600.0)
    srv = SocketServer(a.handle, gate=a.reachable)
    a.addr = ["tcp", srv.addr[0], srv.addr[1]]
    try:
        a.start()
        c = AgentClient(SocketTransport(srv.addr), timeout_s=60.0)
        prompt = list(np.arange(20, dtype=np.int64))   # numpy ids in
        rid = c.submit("k", prompt, np.int64(6))["rid"]
        deadline = time.monotonic() + 60
        while not (r := c.poll(rid))["done"]:
            assert r["error"] is None and time.monotonic() < deadline
            time.sleep(0.01)
        assert len(r["tokens"]) == 6
        assert all(type(t) is int for t in r["tokens"])
        assert a.renew_once() is True
        for payload in (a.rpc_poll(rid=rid), a.rpc_load_report(),
                        a.rpc_stats(), a._renew_payload(),
                        d.rpc_snapshot()):
            json.dumps(payload)
        assert d.rpc_snapshot()["members"][0]["digest"]   # ints advertised
    finally:
        a.shutdown()
        srv.stop()
        dsrv.stop()


# ----------------------------------------------- deployment integration


@pytest.fixture(scope="module")
def jax_tiny():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, sd


def test_llm_deployment_fleet_knob(jax_tiny):
    """``LlamaDeployment(fleet=N)`` serves through a loopback fleet: the
    single-engine deployment's greedy tokens, and the JAX package's
    deployment's for the same weights; ``echo_replica``; the fleet
    aggregate in ``serve_stats``; the reference's refusals."""
    jmodel, params, sd = jax_tiny
    cfg = tl.llama_tiny(dtype=torch.float32)
    for kw in (dict(fleet=-1), dict(fleet=2, num_engine_replicas=2),
               dict(fleet=2, autoscale=True, autoscale_provider=object()),
               dict(fleet=3, autoscale=True, autoscale_max_replicas=2),
               dict(fleet=2, disaggregate=True, prefix_cache=True)):
        with pytest.raises(ValueError):
            tllm.LlamaDeployment(cfg, sd, device="cpu", **kw)
        with pytest.raises(ValueError):
            jllm.LlamaDeployment(jl.llama_tiny(dtype=jnp.float32), params,
                                 **kw)
    # the fleet's autoscaling builds (tests/test_torch_fleet_durability.py
    # drives it)
    tllm.LlamaDeployment(cfg, sd, fleet=2, autoscale=True, device="cpu")
    kw = dict(max_new_tokens=6, max_slots=4, page_size=8)
    d = tllm.LlamaDeployment(cfg, sd, fleet=2, device="cpu", **kw)
    ref = tllm.LlamaDeployment(cfg, sd, device="cpu", **kw)
    jd = jllm.LlamaDeployment(jl.llama_tiny(dtype=jnp.float32), params,
                              fleet=2, **kw)
    try:
        prompts = [[1, 2, 3], list(range(5, 17)), [7] * 9]
        for prompt in prompts:
            want = ref(prompt)
            assert d(prompt) == want == jd(prompt)
        out = d({"prompt_ids": prompts[0], "echo_replica": True})
        assert out["ids"] == ref(prompts[0])
        rid, gen = out["replica"].split(":")
        assert rid in ("r0", "r1") and gen == "0"
        streamed = list(d.stream({"prompt_ids": prompts[1],
                                  "echo_replica": True,
                                  "session_id": "u1"}))
        assert streamed[0]["replica"] in ("r0:0", "r1:0")
        assert streamed[1:] == ref(prompts[1])[len(prompts[1]):]
        assert d.generate_batch(prompts) == jd.generate_batch(prompts)
        ss = d.serve_stats()["engine"]
        assert ss["replicas"] == 2
        assert "fleet" in ss and ss["consistent"] is False
        assert ref({"prompt_ids": [5], "echo_replica": True})["replica"] \
            == "0:0"
        pool = tllm.LlamaDeployment(cfg, sd, num_engine_replicas=2,
                                    device="cpu", **kw)
        assert pool({"prompt_ids": [5], "echo_replica": True})[
            "replica"] in ("0:0", "1:0")
        pool.shutdown()
    finally:
        d.shutdown()
        ref.shutdown()
        jd._engine.shutdown()
        for a in jd._fleet_agents.values():
            a.shutdown()
    assert all(a._stop.is_set() for a in d._fleet_agents.values())


def test_llm_deployment_echo_generation(jax_tiny):
    """``"echo_generation": true`` names the weights that served a
    request (``generation:weights_id``) on one engine, a pool and a
    fleet, in the JAX deployment's form, beside ``echo_replica`` and in
    the stream's first yield."""
    jmodel, params, sd = jax_tiny
    cfg = tl.llama_tiny(dtype=torch.float32)
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    kw = dict(max_new_tokens=4, max_slots=2, page_size=8)
    prompt = [3, 1, 4, 1]
    for knob in (dict(), dict(num_engine_replicas=2), dict(fleet=2)):
        d = tllm.LlamaDeployment(cfg, sd, device="cpu", **knob, **kw)
        jd = jllm.LlamaDeployment(jcfg, params, **knob, **kw)
        try:
            got = d({"prompt_ids": prompt, "echo_generation": True})
            want = jd({"prompt_ids": prompt, "echo_generation": True})
            assert got == want, knob
            assert set(got) == {"ids", "generation"}
            both = d({"prompt_ids": prompt, "echo_generation": True,
                      "echo_replica": True})
            assert both["generation"] == got["generation"]
            assert both["ids"] == got["ids"] and "replica" in both
            first = next(iter(d.stream({"prompt_ids": prompt,
                                        "echo_generation": True})))
            jfirst = next(iter(jd.stream({"prompt_ids": prompt,
                                          "echo_generation": True})))
            assert first == jfirst == {"generation": got["generation"]}
            assert d(prompt) == got["ids"]
        finally:
            d.shutdown()
            eng = jd._engine
            if eng is not None:
                eng.shutdown()
            for a in getattr(jd, "_fleet_agents", {}).values():
                a.shutdown()
