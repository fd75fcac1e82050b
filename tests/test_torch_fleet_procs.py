"""The port's fleet as processes (``python -m
ray_tpu_torch.serve.fleet.directory`` and ``...agent``), on the CPU:

- a directory process and two ``--model fake`` agent processes, started
  as chip_smoke's phase 4j starts them (``_FleetProcs``): a SIGKILL and
  its resubmission, every child reaped;
- a primary and a standby directory process and a ``--model fake``
  agent given both endpoints: the primary's SIGKILL, the standby's
  promotion, the agent renewing with it;
- ``FleetCapacityProvider`` starting a ``--model fake`` agent: ready,
  adopted by a router, serving, scaled down and reaped;
- chip_smoke's phase 4j rehearsed with ``llama_tiny`` fp32 agent
  processes, its own checks (the telemetry collector's among them), its
  children reaped.

Each test runs under its own time budget (``_budget(duration_s=...)``),
which tests/test_torch_fleet_durability.py's marker audit requires of a
test that starts processes.
"""
import contextlib
import importlib.util
import pathlib
import time

import pytest
import torch

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.errors import EngineShutdown
from ray_tpu_torch.serve.fleet.agent import AgentClient, scripted_completion
from ray_tpu_torch.serve.fleet.directory import (DirectoryClient,
                                                 FleetDirectory)
from ray_tpu_torch.serve.fleet.provider import FleetCapacityProvider
from ray_tpu_torch.serve.fleet.replication import FailoverDirectoryClient
from ray_tpu_torch.serve.fleet.router import FleetRouter
from ray_tpu_torch.serve.fleet.transport import SocketServer, SocketTransport

ROOT = pathlib.Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _budget(duration_s: float):
    """The block must end within ``duration_s`` seconds."""
    t0 = time.monotonic()
    yield
    took = time.monotonic() - t0
    assert took <= duration_s, f"{took:.1f} s over a {duration_s} s budget"


def _wait(pred, timeout_s: float = 60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if pred():
                return True
        except Exception:   # noqa: BLE001 - not answering yet
            pass
        time.sleep(0.05)
    return False


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_fleet_cross_process_kill_and_resubmit(tmp_path):
    """A directory process and two ``--model fake`` agent processes,
    started as chip_smoke's phase 4j starts them: a few requests, a
    SIGKILL of the agent serving some of them, the zero-delivery ones
    resubmitted to the survivor token-identically, the partly streamed
    one failed typed, the death confirmed; every child reaped."""
    procs = _smoke()._FleetProcs(str(tmp_path))
    with _budget(duration_s=120.0):
        _kill_and_resubmit(procs)
    assert procs.alive() == []


def _kill_and_resubmit(procs):
    router = None
    try:
        procs.start("directory", "ray_tpu_torch.serve.fleet.directory",
                    ["--lease-ttl-s", 2.0])
        dport, _ = procs.ready("directory", timeout_s=120)
        for name in ("a0", "a1"):
            procs.start(name, "ray_tpu_torch.serve.fleet.agent",
                        ["--replica-id", name, "--directory-port", dport,
                         "--model", "fake", "--token-delay-s", 0.02])
        for name in ("a0", "a1"):
            procs.ready(name, timeout_s=120)
        dc = DirectoryClient(SocketTransport(("127.0.0.1", dport)),
                             timeout_s=30.0)
        router = FleetRouter(
            dc, lambda addr: SocketTransport((addr[1], int(addr[2]))),
            seed=0, call_timeout_s=30.0, transport_patience_s=120.0,
            poll_interval_s=0.005)
        prompts = [[i, i + 1, i + 2] for i in range(8)]
        hs = [router.submit(p, max_new_tokens=10, session_id=f"s{i}")
              for i, p in enumerate(prompts)]
        victim = hs[0].replica_idx
        survivor = "a1" if victim == "a0" else "a0"
        # one of the victim's streams partly delivered, the rest untouched
        partial = hs[0].stream()
        first = [next(partial), next(partial)]
        procs.kill(victim)
        outs = {}
        for i, h in enumerate(hs[1:], 1):
            try:
                outs[i] = h.result()
            except Exception as e:   # noqa: BLE001
                outs[i] = e
        with pytest.raises(EngineShutdown):
            list(partial)
        assert first == scripted_completion(prompts[0], 10)[:2]
        on_victim = [i for i in outs if hs[i].resubmits]
        assert on_victim, "no untouched request on the victim"
        for i, got in outs.items():
            assert got == scripted_completion(prompts[i], 10), (i, got)
            assert hs[i].replica_idx == survivor
            assert hs[i].resubmits == (1 if i in on_victim else 0)
        assert router.counters["deaths_confirmed"] == 1
        assert dc.stats()["counters"]["confirmed_dead"] == 1
        assert {m["replica_id"] for m in dc.snapshot()["members"]} == {
            survivor}
    finally:
        if router is not None:
            router.shutdown()
        procs.reap()


def test_agent_main_fails_over_to_the_promoted_standby(tmp_path):
    """A ``--model fake`` agent given a primary and a standby directory
    (started as chip_smoke's phase 4j starts them) registers with the
    primary, and the registration reaches the standby; after the
    primary's SIGKILL the standby promotes itself (epoch 1, the fence
    counter folded past the primary's) and the agent keeps its
    incarnation by renewing with it, so a router over both endpoints
    serves through the promoted directory. Every child is reaped."""
    smoke = _smoke()
    procs = smoke._FleetProcs(str(tmp_path))
    router = None
    with _budget(duration_s=120.0):
        try:
            dport, sport = smoke._start_directory_pair(procs,
                                                       str(tmp_path))
            procs.start("a0", "ray_tpu_torch.serve.fleet.agent",
                        ["--replica-id", "a0", "--model", "fake",
                         "--directory", f"127.0.0.1:{dport}",
                         "--directory", f"127.0.0.1:{sport}"])
            aport, _ = procs.ready("a0", timeout_s=60)
            pc = DirectoryClient(SocketTransport(("127.0.0.1", dport)))
            sc = DirectoryClient(SocketTransport(("127.0.0.1", sport)))
            fence0 = pc.stats()["fence_counter"]
            member = pc.snapshot()["members"][0]
            assert _wait(lambda: sc.role()["members"] == 1)
            procs.kill("directory")
            assert _wait(lambda: sc.role()["role"] == "primary")
            role = sc.role()
            assert role["epoch"] == 1
            assert role["fence_counter"] >= fence0 + 1024
            # the agent renews with the promoted standby: its load report
            # (which replication does not carry) reappears there
            assert _wait(lambda: sc.snapshot()["members"][0]["load"])
            after = sc.snapshot()["members"][0]
            assert (after["replica_id"], after["generation"],
                    after["fence"]) == ("a0", member["generation"],
                                        member["fence"])
            counters = AgentClient(SocketTransport(("127.0.0.1", aport))
                                   ).stats()["counters"]
            assert counters["self_fences"] == counters["reregisters"] == 0
            router = FleetRouter(
                FailoverDirectoryClient(
                    [SocketTransport(("127.0.0.1", p))
                     for p in (dport, sport)]),
                lambda addr: SocketTransport((addr[1], int(addr[2]))),
                call_timeout_s=30.0, transport_patience_s=60.0)
            h = router.submit([4, 5, 6], max_new_tokens=5)
            assert h.result() == scripted_completion([4, 5, 6], 5)
            assert sc.stats()["counters"]["renews"] >= 1
        except BaseException:
            print(procs.tails())
            raise
        finally:
            if router is not None:
                router.shutdown()
            procs.reap()
    assert procs.alive() == []


def test_fleet_capacity_provider_spawns_serves_and_retires():
    """``FleetCapacityProvider`` over a directory: a ticket starts a
    ``--model fake`` agent process that is ready once registered; a
    router adopts it (``add_replica_for_ticket``), routes to it, and
    ``scale_down`` drains it and tombstones its generation; ``release``
    reaps the process and nothing is left running."""
    d = FleetDirectory(lease_ttl_s=5.0)
    srv = SocketServer(d.handle)
    provider = FleetCapacityProvider([srv.addr], model="fake",
                                     spawn_timeout_s=120.0,
                                     initial_eta_s=3.0)
    router = FleetRouter(
        DirectoryClient(SocketTransport(srv.addr)),
        lambda addr: SocketTransport((addr[1], int(addr[2]))),
        call_timeout_s=30.0, transport_patience_s=60.0)
    try:
        ticket = provider.request()
        assert ticket == "auto-1" and provider.live_count() == 1
        assert 0.25 <= provider.eta_s(ticket) <= 3.0
        assert _wait(lambda: provider.ready(ticket), timeout_s=120.0)
        assert provider.eta_s(ticket) == 0.0
        proc = provider._agents[ticket]["proc"]
        with _budget(duration_s=5.0):
            idx = router.add_replica_for_ticket(ticket)
            assert router.active_count() == 1
            hs = [router.submit([i, i + 1], max_new_tokens=6)
                  for i in range(4)]
            assert [h.result() for h in hs] == [
                scripted_completion([i, i + 1], 6) for i in range(4)]
            assert {h.replica_idx for h in hs} == {ticket}
            assert router.scale_down(1, rids=[ticket]) == [idx]
        assert d.rpc_stats()["tombstones"] == {ticket: 0}
        assert router.active_count() == 0
        provider.release(ticket)
        assert proc.poll() is not None and provider.live_count() == 0
        assert provider.stats == {"spawned": 1, "ready": 1, "released": 1,
                                  "denied": 0, "spawn_failures": 0}
    finally:
        router.shutdown()
        provider.stop_all()
        srv.stop()


def test_chip_smoke_fleet_phase_rehearses_on_the_cpu():
    """chip_smoke phase 4j with the CPU standing in for the card and
    ``llama_tiny`` fp32 agent processes: its own checks hold (both
    members served, the agents' warm-up tokens equal this process's
    engine's, no request lost or served twice, the kill mid-wave
    resubmitted and failed as it must, the death confirmed; the
    collector scraped every member, ingested no event twice, wrote the
    death's and the promotion's cluster bundles, and read a resubmitted
    request as one timeline over three processes), and every child is
    reaped."""
    smoke = _smoke()
    from ray_tpu_torch.ops import paged_attention as pa
    pool = {"tok_s": 0.0, "ttft_p50_s": 0.0, "one_engine_tok_s": 0.0,
            "one_engine_ttft_p50_s": 0.0}
    with _budget(duration_s=300.0):
        res = smoke.phase_fleet_path(
            tl, pa, 0, "cpu", pool, cfg=tl.llama_tiny(dtype=torch.float32),
            device="cpu", agent_model="tiny",
            sizes=dict(system=16, turn=8, n_new=8, kill_new=40, max_slots=2,
                       page_size=8, n_pages=64, chunk=4))
    p = res["processes"]
    assert sorted(res["loopback"]["routes"]) == ["r0", "r1"]
    assert sorted(p["routes"]) == ["a0", "a1"]
    assert 1 <= p["resubmitted"] < p["on_victim"]
    assert p["streamed_failed"] >= 1
    assert p["confirm_dead_s"] > 0
    c, d = res["provider"], res["failover"]
    assert c["ready_s"] > 0 and c["routes"].get("auto-1", 0) >= 1
    assert d["promoted_s"] > 0 and d["fence_after"] >= d["fence_before"] + 1024
    assert d["completed"] + d["failed_typed"] == 8
    tel = res["telemetry"]
    assert tel["checks"] and all(tel["checks"].values()), tel["checks"]
    assert set(tel["members"]) >= {"router", "directory-0", "directory-1",
                                   "a0", "a1", "auto-1"}
    assert all(m["dropped"] == 0 for m in tel["members"].values())
    [order] = tel["timeline"].values()
    assert order[:3] == ["router", p["victim"],
                         "a0" if p["victim"] == "a1" else "a1"]
    assert {f"agent-dead-{p['victim']}", "promote-directory-1"} <= {
        r for r, _ in tel["bundle_ms"]}
    assert 0 < res["directory_ready_s"]["primary"] < smoke.FLEET_READY_S
