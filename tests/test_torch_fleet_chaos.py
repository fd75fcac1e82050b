"""The port's cross-process fleet campaign
(``tools/torch_chaos_serve.run_fleet_chaos``) on the CPU: the
counterparts of tests/test_fleet.py's two campaign cases, with the
reference's own calls and asserts, their artifacts held to the
reference's schema gate (``tools/check_bench_schema.check_fleet_chaos``),
chip_smoke's phase 4k rehearsed with ``llama_tiny`` agents, and the
campaign's near-tie rule. Every child process of a campaign is reaped,
whatever its outcome."""
import importlib.util
import os
import pathlib

import pytest
import torch

from tools import check_bench_schema as cbs
from tools.torch_chaos_serve import (ENGINE_KNOBS, _near_tie_gap,
                                     _reference_engine, run_fleet_chaos)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _children() -> list:
    """Pids of this process's living children (from /proc)."""
    me, out = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.append(int(entry))
    return out


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _schema_problems(art) -> list:
    problems = []
    cbs.check_fleet_chaos(art, "SERVE_FLEET_CHAOS_port", problems)
    return problems


def test_fleet_mini_campaign_cross_process(tmp_path):
    """2 agent processes and a primary and a standby directory process
    under the seeded schedule (fake engines): the run's own gates hold,
    its artifact passes the reference's schema gate, and no child is
    left."""
    before = set(_children())
    art = run_fleet_chaos(seed=11, agents=2, duration_s=3.0,
                          clients=2, model="fake",
                          lease_ttl_s=0.6, token_delay_s=0.002,
                          flight_dir=str(tmp_path))
    assert art["requests"]["lost"] == 0
    assert art["requests"]["mismatched"] == 0
    assert art["requests"]["near_tie"] == 0
    assert art["requests"]["resubmitted_ok"] >= 1
    assert art["topology"]["agents"] == 2
    assert art["topology"]["transport"] == "tcp-json-v1"
    assert art["quiesced"] is True
    assert art["flight_recorder"]["faults_explained"] is True
    for kind in ("kill_agent", "partition", "directory_restart",
                 "primary_kill", "torn_wal_restart", "autoscale_churn"):
        assert art["injected"][kind] >= 1, art["injected"]
    assert _schema_problems(art) == []
    assert set(_children()) <= before


@pytest.mark.slow
def test_fleet_full_campaign_tiny_model(tmp_path):
    """The reference's full recipe: 3 ``llama_tiny`` fp32 agent processes
    on the CPU under the whole campaign; the artifact passes the schema
    gate and no child is left."""
    before = set(_children())
    art = run_fleet_chaos(seed=47, agents=3, duration_s=4.0,
                          model="tiny", device="cpu", lease_ttl_s=1.0,
                          flight_dir=str(tmp_path))
    assert _schema_problems(art) == []
    assert art["requests"]["near_tie"] == 0
    assert set(_children()) <= before


@pytest.mark.slow
def test_chip_smoke_fleet_chaos_phase_rehearses_on_the_cpu():
    """chip_smoke phase 4k with the CPU standing in for the card and
    ``llama_tiny`` fp32 agent processes: all six faults, every gate, the
    recovery seconds printed, decode steps on every live agent."""
    smoke = _smoke()
    before = set(_children())
    res = smoke.phase_fleet_chaos(0, "cpu", device="cpu", model="tiny")
    assert set(res["injected"]) == {"kill_agent", "partition",
                                    "directory_restart", "primary_kill",
                                    "torn_wal_restart", "autoscale_churn"}
    assert res["requests"]["lost"] == res["requests"]["mismatched"] == 0
    rec = res["recovery"]
    assert rec["primary_kill_promoted_s"] > 0
    assert all(s is not None and s > 0
               for s in rec["kill_agent_confirmed_dead_s"]
               + rec["partition_self_fence_s"])
    assert set(_children()) <= before


def test_near_tie_gap_is_the_teacher_forced_gap():
    """The campaign's near-tie rule: where a completion parts from the
    lone engine's, the larger gap to the top logit of the two tokens
    there, teacher-forced over the prompt and the lone engine's tokens,
    as chip_smoke's ``_teacher_forced_logits`` reads it."""
    eng = _reference_engine("tiny", 2, 0, "cpu", ENGINE_KNOBS["tiny"])
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 10, 20]
    try:
        want = eng.submit(prompt, max_new_tokens=10).result()
    finally:
        eng.shutdown()
    rows = _smoke()._teacher_forced_logits(eng.model, prompt, want, "fp",
                                           "cpu")
    for j in (0, 4, 9):
        second = int(torch.topk(rows[j], 2).indices[1])
        got = want[:j] + [second] + want[j + 1:]
        gap = _near_tie_gap(eng.model, prompt, want, got)
        assert abs(gap - float(rows[j].max() - rows[j][second])) < 1e-5
    assert _near_tie_gap(eng.model, prompt, want, list(want)) == float("inf")
