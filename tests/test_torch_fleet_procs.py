"""The port's fleet as processes (``python -m
ray_tpu_torch.serve.fleet.directory`` and ``...agent``), on the CPU:

- a directory process and two ``--model fake`` agent processes, started
  as chip_smoke's phase 4j starts them (``_FleetProcs``): a SIGKILL and
  its resubmission, every child reaped;
- the agent's refusal of a failover directory list (the fleet's second
  slice);
- chip_smoke's phase 4j rehearsed with ``llama_tiny`` fp32 agent
  processes, its own checks, its children reaped.
"""
import importlib.util
import pathlib
import subprocess
import sys

import pytest
import torch

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.errors import EngineShutdown
from ray_tpu_torch.serve.fleet.agent import scripted_completion
from ray_tpu_torch.serve.fleet.directory import DirectoryClient
from ray_tpu_torch.serve.fleet.router import FleetRouter
from ray_tpu_torch.serve.fleet.transport import SocketTransport

ROOT = pathlib.Path(__file__).resolve().parent.parent


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
    assert procs.alive() == []


def test_agent_main_refuses_two_directories():
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.serve.fleet.agent",
         "--replica-id", "r0", "--directory", "127.0.0.1:1",
         "--directory", "127.0.0.1:2"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "second slice" in out.stderr and "READY" not in out.stdout


def test_chip_smoke_fleet_phase_rehearses_on_the_cpu():
    """chip_smoke phase 4j with the CPU standing in for the card and
    ``llama_tiny`` fp32 agent processes: its own checks hold (both
    members served, the agents' warm-up tokens equal this process's
    engine's, no request lost or served twice, the kill mid-wave
    resubmitted and failed as it must, the death confirmed), and every
    child is reaped."""
    smoke = _smoke()
    from ray_tpu_torch.ops import paged_attention as pa
    pool = {"tok_s": 0.0, "ttft_p50_s": 0.0, "one_engine_tok_s": 0.0,
            "one_engine_ttft_p50_s": 0.0}
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
