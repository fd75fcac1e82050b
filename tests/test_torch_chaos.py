"""The port's ``serve/chaos.py`` against the JAX package's, on the CPU:
the seeded schedules, the fleet campaign's injector on a fake clock, and
the in-process campaign's names, which wait for the fleet's fourth
slice."""
import random

import pytest

from ray_tpu.serve import chaos as jchaos
from ray_tpu_torch.serve import chaos as tchaos

_MODS = {"jax": jchaos, "torch": tchaos}


@pytest.mark.parametrize("duration_s", [3.0, 4.0, 20.0])
def test_schedules_equal_the_reference(duration_s):
    for seed in range(32):
        for extra in (0, 2):
            got = {name: [e.as_dict() for e in m.make_schedule(
                seed, duration_s, extra=extra)] for name, m in _MODS.items()}
            assert got["torch"] == got["jax"], (seed, extra)
            assert {e["kind"] for e in got["torch"]} == set(tchaos.KINDS)
            fleet = {name: [e.as_dict() for e in m.make_fleet_schedule(
                seed, duration_s, extra=extra, partition_s=2.5)]
                for name, m in _MODS.items()}
            assert fleet["torch"] == fleet["jax"], (seed, extra)
            assert [e["duration_s"] for e in fleet["torch"]
                    if e["kind"] == "partition"][0] == 2.5
    assert tchaos.KINDS == jchaos.KINDS
    assert tchaos.FLEET_KINDS == jchaos.FLEET_KINDS


def test_too_short_a_schedule_raises_as_the_reference():
    msgs = {}
    for name, m in _MODS.items():
        with pytest.raises(ValueError) as e:
            m.make_fleet_schedule(1, 0.0)
        msgs[name] = str(e.value)
        with pytest.raises(ValueError):
            m.make_schedule(1, -1.0)
    assert msgs["torch"] == msgs["jax"]


class _StepClock:
    """A fake clock that moves ``dt`` each time it is read: the
    injector's own polls drive it, so its run is deterministic."""

    def __init__(self, dt: float = 0.05):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def _injector_run(m):
    """The fleet schedule of seed 5 over 6 s through ``m``'s injector:
    ``partition`` answers None twice (cannot fire yet) before it fires,
    ``torn_wal_restart`` raises once, each op names a target drawn from
    the injector's seeded rng; returns the log, the counts and the order
    the ops were called in."""
    calls = []
    state = {"partition": 2, "torn_wal_restart": 1}

    def op(kind):
        def fire(ev, rng):
            calls.append(kind)
            if state.get(kind, 0) > 0:
                state[kind] -= 1
                if kind == "torn_wal_restart":
                    raise RuntimeError("directory busy")
                return None
            return f"{kind}-{rng.randrange(100)}"
        return fire

    schedule = m.make_fleet_schedule(5, 6.0)
    inj = m.FleetChaosInjector(schedule,
                               {k: op(k) for k in m.FLEET_KINDS},
                               seed=9, poll_s=0.0, time_fn=_StepClock())
    inj.start()
    inj._thread.join(timeout=30)
    assert not inj._thread.is_alive() and inj.done()
    inj.stop()
    return {"log": inj.log, "counts": inj.injected_counts(),
            "calls": calls,
            "schedule": [e.as_dict() for e in inj.schedule]}


def test_fleet_injector_equals_the_reference_on_a_fake_clock():
    rec = {name: _injector_run(m) for name, m in _MODS.items()}
    assert rec["torch"] == rec["jax"]
    r = rec["torch"]
    assert r["counts"] == {k: 1 for k in tchaos.FLEET_KINDS}
    # fired in schedule order, each at or after its planned time
    fired = [e["kind"] for e in r["log"]]
    assert fired == [e["kind"] for e in r["schedule"]]
    for e in r["log"]:
        assert e["fired"] and e["fired_at_s"] >= e["at_s"]
        assert e["target"].startswith(e["kind"] + "-")
    # the op that answered None was retried, the one that raised too,
    # and the injector kept firing after it
    assert r["calls"].count("partition") == 3
    assert r["calls"].count("torn_wal_restart") == 2
    rng = random.Random(9)
    assert [int(e["target"].rsplit("-", 1)[1]) for e in r["log"]] == [
        rng.randrange(100) for _ in r["log"]]


def test_the_in_process_campaign_waits_for_the_fourth_slice():
    with pytest.raises(NotImplementedError, match="fourth slice"):
        tchaos.ChaosInjector(object(), [])
    with pytest.raises(NotImplementedError, match="fourth slice"):
        tchaos.StockoutCapacityProvider(object())
    with pytest.raises(NotImplementedError, match="fourth slice"):
        tchaos.release_all_hangs(object())


def test_the_tool_without_fleet_exits_2_naming_the_fourth_slice(capsys):
    from tools.torch_chaos_serve import main
    assert main([]) == 2
    assert "fourth slice" in capsys.readouterr().err
