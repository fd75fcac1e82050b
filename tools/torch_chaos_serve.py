"""Port of ``tools/chaos_serve.py``'s cross-process campaign
(``run_fleet_chaos``): a seeded fault campaign against the port's fleet,
every replica an agent process.

    python3 tools/torch_chaos_serve.py --fleet [--model fake|tiny|tinyllama]
        [--layers L] [--device cuda|cpu] [--replicas N] [--duration S]
        [--clients C] [--lease-ttl S] [--seed N] [--out FILE]

Runs from the root of a checkout of the repo (it imports
``ray_tpu_torch``; no JAX). The topology is the reference's: a WAL-backed
primary directory process replicating to a hot standby process, agent
processes (``python -m ray_tpu_torch.serve.fleet.agent``) holding the
ordered endpoint list, a ``FleetRouter`` over sockets in this process
with a ``TelemetryCollector`` attached, a supervisor restarting killed
agents under bumped generations, and a ``FleetCapacityProvider`` for the
churn. ``serve/chaos.py``'s ``make_fleet_schedule`` fires its six kinds
(agent SIGKILL, a partition longer than the lease, a primary crash and
restart from its WAL, a torn WAL tail, a permanent primary kill, and
autoscaler churn) while client threads send the reference's traffic:
8 prompts behind a shared 8-token prefix, greedy.

``--model fake`` agents serve ``scripted_completion``; ``tiny``
(``llama_tiny`` fp32) and ``tinyllama`` (TinyLlama-1.1B's widths at
``--layers`` layers, bf16) agents serve ``init_params(cfg, seed)``
weights on ``--device`` (the card unless ``cpu``), and the ground truth
is the lone greedy completion of each prompt by an engine of this
process built as the agents build theirs. On the card, where a batch
may round a bf16 product otherwise than a lone request, a completion
that parts from the ground truth at a near-tie (teacher-forced, both
tokens within ``NEAR_TIE_GAP`` of the top logit at the first differing
token) is counted apart as ``near_tie`` and never as completed; on the
CPU every parting is a mismatch.

The gates are the reference's: no admitted request lost or mismatched,
at least one completed through a resubmission, fencing tokens monotonic
across the failover (from the surviving directory's own event log),
every fault explained by a flight bundle and a cluster bundle, the live
agents quiesced. The artifact has the reference's ``SERVE_FLEET_CHAOS``
shape (``tools/check_bench_schema.check_fleet_chaos`` accepts it), with
a ``recovery`` block of each fault's seconds from injection to recovery.
Every child process is reaped on every exit path.

Without ``--fleet`` it exits 2: the in-process pool campaign
(``run_chaos``) waits for the fleet's fourth slice (ROADMAP.md, queue
1, item 9).
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ATTAINMENT_FLOOR = 0.5
NEAR_TIE_GAP = 0.1          # chip_smoke phase 3's near-tie, in logits
READY_TIMEOUT_S = 180.0     # a cold model agent: torch, weights, warm-up
# a model agent's engine knobs: llama_tiny at the agent command line's
# defaults; TinyLlama's widths with the card's 64-token pages
ENGINE_KNOBS = {"tiny": dict(max_slots=2, page_size=8, n_pages=64, chunk=4),
                "tinyllama": dict(max_slots=8, page_size=64, n_pages=64,
                                  chunk=8)}


def _spawn_fleet_proc(module_args, log_path):
    """``python -m <module_args>`` from the repo root, its stdout and
    stderr into ``log_path`` (a pipe nobody drains would block the child)
    and never forked from this process, which may hold a CUDA context."""
    with open(log_path, "ab") as out:
        return subprocess.Popen(
            [sys.executable, "-u", "-m"] + [str(a) for a in module_args],
            cwd=ROOT, stdin=subprocess.DEVNULL, stdout=out,
            stderr=subprocess.STDOUT)


def _tail(log_path, n=20):
    try:
        with open(log_path, "rb") as f:
            return "\n".join(
                f.read().decode(errors="replace").splitlines()[-n:])
    except OSError:
        return ""


def _wait_ready(proc, log, tag, timeout_s=READY_TIMEOUT_S):
    """Block until ``proc`` printed ``READY <port>`` into ``log``, a
    (path, offset) pair: a restarted child appends to its predecessor's
    file, so only what follows ``offset`` counts. Raises if the child
    exits or stalls first."""
    path, offset = log
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with open(path, "rb") as f:
            f.seek(offset)
            m = re.search(rb"^READY (\d+)\s*$", f.read(), re.M)
        if m:
            return int(m.group(1))
        if proc.poll() is not None:
            raise RuntimeError(f"{tag} exited rc={proc.returncode} before "
                               f"READY; output:\n{_tail(path)}")
        time.sleep(0.02)
    raise RuntimeError(f"{tag} not READY after {timeout_s}s")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference_engine(model, layers, seed, device, knobs):
    """An engine of this process built as the agents build theirs."""
    from ray_tpu_torch.serve.fleet.agent import model_engine_factory
    return model_engine_factory(model, layers=layers, seed=seed,
                                device=device, **knobs)(0)


def _near_tie_gap(model, prompt, want, got):
    """At the first token where ``got`` parts from ``want``: the larger
    teacher-forced gap (top logit - logit) of the two tokens there, one
    fp32 forward over prompt + want in a fresh pool (gather path); inf
    where they part in length."""
    import torch

    from ray_tpu_torch.models.kv_cache import init_kv_pool, kv_layer_view
    j = next((k for k, (x, y) in enumerate(zip(want, got)) if x != y),
             None)
    if j is None:
        return float("inf")
    dev = model.tok_embeddings.device
    ids = prompt + want[:j]
    pg = 16
    n = -(-len(ids) // pg)
    with torch.no_grad():
        pool = init_kv_pool(model.cfg, n + 1, pg, device=dev)
        pt = torch.arange(1, n + 1, dtype=torch.int32, device=dev)[None]
        row = model(torch.tensor([ids], device=dev),
                    [kv_layer_view(layer, pt) for layer in pool],
                    torch.zeros(1, dtype=torch.int32, device=dev))[0][-1]
        row = row.float()
    top = float(row.max())
    return max(top - float(row[want[j]]), top - float(row[got[j]]))


def run_fleet_chaos(seed=47, agents=3, duration_s=4.0, clients=3,
                    max_new_tokens=10, lease_ttl_s=1.0,
                    partition_s=None, model="tiny", layers=22, device=None,
                    token_delay_s=0.004,
                    attainment_floor=ATTAINMENT_FLOOR,
                    promote_after_s=None, poll_interval_s=0.004,
                    flight_dir=None):
    """One seeded cross-process campaign (see the module docstring).
    Returns the artifact after asserting every gate; raises
    ``AssertionError`` naming the first gate that failed. ``device``
    (model agents only) defaults to the card; the agents and the
    reference engine take ``ENGINE_KNOBS[model]``."""
    from ray_tpu_torch.serve import chaos, obs
    from ray_tpu_torch.serve.fleet.agent import (AgentClient,
                                                 scripted_completion)
    from ray_tpu_torch.serve.fleet.directory import DirectoryClient
    from ray_tpu_torch.serve.fleet.provider import FleetCapacityProvider
    from ray_tpu_torch.serve.fleet.replication import (
        FailoverDirectoryClient)
    from ray_tpu_torch.serve.fleet.router import FleetRouter
    from ray_tpu_torch.serve.fleet.telemetry import (TelemetryCollector,
                                                     load_cluster_bundle)
    from ray_tpu_torch.serve.fleet.transport import (SocketTransport,
                                                     TransportError)
    from ray_tpu_torch.serve.fleet.wal import inject_torn_tail

    if partition_s is None:
        partition_s = 2.5 * lease_ttl_s
    if partition_s <= lease_ttl_s:
        raise ValueError("the partition must outlive the lease, or the "
                         "victim never fences")
    if promote_after_s is None:
        # must outlive a directory's restart, or a routine crash and
        # recovery would trigger a failover
        promote_after_s = max(3.0, 3.0 * lease_ttl_s)
    if flight_dir is None:
        flight_dir = tempfile.mkdtemp(prefix="fleet-chaos-flight-")
    knobs = ENGINE_KNOBS.get(model)
    work = tempfile.mkdtemp(prefix="fleet-chaos-")

    shared = [3, 1, 4, 1, 5, 9, 2, 6]
    prompts = [shared + [10 + i, 20 + i] for i in range(8)]
    ref_model = None
    cuda = False
    agent_args = []      # a model agent's engine arguments
    if model == "fake":
        want = {tuple(p): scripted_completion(p, max_new_tokens)
                for p in prompts}
    else:
        from ray_tpu_torch._device import resolve_device
        dev = resolve_device(device)
        cuda = dev.type == "cuda"
        if cuda:
            # an agent on the card never compiles: build K1 here first
            from ray_tpu_torch.ops import _build
            from ray_tpu_torch.ops import paged_attention as pa
            _build.compile_all([pa._SOURCE])
        eng = _reference_engine(model, layers, seed, dev.type, knobs)
        try:
            want = {tuple(p): eng.submit(p, max_new_tokens=max_new_tokens)
                    .result() for p in prompts}
        finally:
            eng.shutdown()
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in eng.model.state_dict().values())
        ref_model = eng.model if cuda and model == "tinyllama" else None
        agent_args = ["--layers", layers, "--seed", seed,
                      "--device", dev.type,
                      "--max-slots", knobs["max_slots"],
                      "--page-size", knobs["page_size"],
                      "--n-pages", knobs["n_pages"],
                      "--chunk", knobs["chunk"]]
    near_ties_allowed = ref_model is not None
    mem0 = None
    if cuda:
        import torch
        torch.cuda.empty_cache()
        mem0 = torch.cuda.mem_get_info()[0]

    state_lock = threading.Lock()
    stop_all = threading.Event()
    procs = {}           # rid -> {"proc", "port", "generation"}
    spawned = []         # every Popen ever (teardown + counts)
    killed = []          # {"rid", "member", "port", "generation", "t"}
    partitions = []      # {"rid", "port", "t", probe results...}
    dir_restarts = []    # current-primary crash/restart (WAL proof)
    torn_restarts = []   # torn-tail crash/restart (truncation proof)
    churns = []          # autoscale_churn lifecycle records
    failover = {}        # the (single) permanent primary kill
    canaries = []        # {"kind", "rid", "handle", "prompt"}
    churn_threads = []
    sup = router = provider = collector = injector = None
    threads = []
    stop_load = threading.Event()
    try:
        dport, sport = _free_port(), _free_port()
        dirs = {
            "d1": {"port": dport, "data_dir": os.path.join(work, "d1"),
                   "flags": ["--standby", f"127.0.0.1:{sport}"]},
            "d2": {"port": sport, "data_dir": os.path.join(work, "d2"),
                   "flags": ["--role", "standby",
                             "--peer", f"127.0.0.1:{dport}",
                             "--promote-after-s", promote_after_s]},
        }
        endpoints = [f"127.0.0.1:{dport}", f"127.0.0.1:{sport}"]

        def spawn(tag, module_args):
            log = os.path.join(work, f"{tag}.log")
            offset = os.path.getsize(log) if os.path.exists(log) else 0
            p = _spawn_fleet_proc(module_args, log)
            spawned.append(p)
            return p, (log, offset)

        def start_directory(name):
            rec = dirs[name]
            t0 = time.monotonic()
            p, log = spawn(name, [
                "ray_tpu_torch.serve.fleet.directory",
                "--port", rec["port"], "--lease-ttl-s", lease_ttl_s,
                "--data-dir", rec["data_dir"]] + rec["flags"])
            rec["proc"] = p
            _wait_ready(p, log, f"directory-{name}")
            rec.setdefault("ready_s", []).append(
                round(time.monotonic() - t0, 4))
            return p

        # the standby FIRST: its monitor promotes only after it has seen
        # the primary alive, so the boot order cannot steal the throne
        start_directory("d2")
        start_directory("d1")

        def dir_client(name, timeout_s=2.0):
            return DirectoryClient(SocketTransport(
                ("127.0.0.1", dirs[name]["port"])), timeout_s)

        def current_primary():
            """Which directory process adjudicates (None mid-failover)."""
            for name in ("d1", "d2"):
                if dirs[name]["proc"].poll() is not None:
                    continue
                try:
                    if dir_client(name).ping()["role"] == "primary":
                        return name
                except Exception:   # noqa: BLE001 - not answering
                    continue
            return None

        def spawn_agent(rid, generation):
            cmd = ["ray_tpu_torch.serve.fleet.agent", "--replica-id", rid,
                   "--generation", generation, "--model", model,
                   "--flight-dir", flight_dir] + agent_args
            if model == "fake":
                cmd += ["--token-delay-s", token_delay_s]
            for ep in endpoints:
                cmd += ["--directory", ep]
            return spawn(rid, cmd)

        def start_agent(rid, generation):
            p, log = spawn_agent(rid, generation)
            port = _wait_ready(p, log, rid)
            with state_lock:
                procs[rid] = {"proc": p, "port": port,
                              "generation": generation}

        # the initial fleet boots in parallel
        t_boot = time.monotonic()
        boot = [(f"r{i}", spawn_agent(f"r{i}", 0)) for i in range(agents)]
        for rid, (p, log) in boot:
            port = _wait_ready(p, log, rid)
            with state_lock:
                procs[rid] = {"proc": p, "port": port, "generation": 0}
        boot_s = time.monotonic() - t_boot
        mem1 = None
        if cuda:
            mem1 = torch.cuda.mem_get_info()[0]

        dc = FailoverDirectoryClient(
            [SocketTransport(("127.0.0.1", dport)),
             SocketTransport(("127.0.0.1", sport))])
        sup_errors = collections.deque(maxlen=32)

        def supervisor():
            """Restart SIGKILLed agents under a bumped generation (the
            tombstoned old generation can never rejoin)."""
            while not stop_all.is_set():
                with state_lock:
                    dead = [(rid, info) for rid, info in procs.items()
                            if info["proc"].poll() is not None]
                for rid, info in dead:
                    # the dead incarnation may have bumped its own
                    # generation (self-fence, rejoin) past the one it
                    # was spawned with: ask the directory's tombstone
                    gen = info["generation"] + 1
                    try:
                        tomb = dc.stats()["tombstones"].get(rid)
                        if tomb is not None:
                            gen = max(gen, int(tomb) + 1)
                    except Exception:   # noqa: BLE001 - mid-restart
                        pass
                    try:
                        start_agent(rid, gen)
                    except Exception as e:   # noqa: BLE001 - the
                        sup_errors.append(   # directory may be down
                            f"{rid} gen{gen}: {type(e).__name__}: {e}")
                        time.sleep(0.1)
                stop_all.wait(0.05)

        sup = threading.Thread(target=supervisor, name="fleet-supervisor",
                               daemon=True)
        sup.start()

        router = FleetRouter(
            dc, lambda addr: SocketTransport((addr[1], int(addr[2]))),
            seed=seed, snapshot_ttl_s=0.05, call_timeout_s=2.0,
            poll_interval_s=poll_interval_s, flight_dir=flight_dir)
        # the cluster flight recorder: one cluster bundle per fault (a
        # confirmed death through the router's hook; a self-fence, a
        # promotion or a recovery from the scraped streams)
        cluster_dir = os.path.join(flight_dir, "cluster")
        collector = TelemetryCollector(
            router, events_per_scrape=512, cluster_dir=cluster_dir,
            offset_bound_s=0.25).attach().run(interval_s=0.25)

        def router_member(rid):
            try:
                return router._snapshot().get(rid)
            except Exception:   # noqa: BLE001 - directory down
                return None

        reserved = set()     # rids already targeted by kill/partition

        def _pick_victim(kind, tries=25):
            """Plant one canary request through the router and make the
            agent it landed on the fault's victim (skipping targeted or
            last-alive agents). With no token delivered, the canary
            must come back token-identically from another agent through
            the resubmit path."""
            for _ in range(tries):
                with state_lock:
                    alive = sorted(rid for rid, info in procs.items()
                                   if info["proc"].poll() is None)
                eligible = [r for r in alive if r not in reserved]
                if len(alive) < 2 or not eligible:
                    return None
                prompt = prompts[len(canaries) % len(prompts)]
                try:
                    h = router.submit(prompt, max_new_tokens=max_new_tokens,
                                      trace_id=f"canary-{kind}")
                except Exception:   # noqa: BLE001 - shed under load
                    time.sleep(0.02)
                    continue
                rid = h.replica_idx
                if rid in eligible:
                    canaries.append({"kind": kind, "rid": rid,
                                     "incarnation": h.replica_tag,
                                     "handle": h, "prompt": prompt})
                    return rid
                h.cancel()
                time.sleep(0.01)
            return None

        def op_kill(ev, rng):
            rid = _pick_victim("kill_agent")
            if rid is None:
                return None          # retry next tick
            mem = router_member(rid) or canaries[-1]["handle"]._member
            with state_lock:
                info = procs[rid]
            reserved.add(rid)
            info["proc"].kill()
            killed.append({"rid": rid, "member": mem, "port": info["port"],
                           "generation": info["generation"],
                           "t": time.monotonic()})
            return rid

        def _probe_fence(rec):
            """Admission attempts at the partitioned agent until it
            heals: while FENCED it must answer ``AgentFenced``."""
            from ray_tpu_torch.serve.fleet.wire import AgentFenced
            client = AgentClient(
                SocketTransport(("127.0.0.1", rec["port"]),
                                connect_timeout_s=0.25), timeout_s=0.25)
            deadline = time.monotonic() + partition_s + 3 * lease_ttl_s
            n = 0
            while time.monotonic() < deadline:
                n += 1
                try:
                    r = client.submit(f"fence-probe-{rec['rid']}-{n}",
                                      prompts[0], 1, fence=None)
                    # admitted: the agent rejoined (a generation bump)
                    # before a probe landed in the fenced window
                    try:
                        client.cancel(r["rid"])
                    except Exception:   # noqa: BLE001
                        pass
                    rec["probe"] = "readmitted"
                    return
                except AgentFenced:
                    rec["probe"] = "refused_fenced"
                    rec["probe_attempts"] = n
                    return
                except Exception:   # noqa: BLE001 - partitioned: retry
                    time.sleep(0.005)
            rec["probe"] = "timeout"

        def op_partition(ev, rng):
            rid = _pick_victim("partition")
            if rid is None:
                return None
            with state_lock:
                info = procs[rid]
            try:
                AgentClient(SocketTransport(
                    ("127.0.0.1", info["port"]))).inject_partition(
                        ev.duration_s)
            except Exception:   # noqa: BLE001 - raced another fault:
                canaries.pop()["handle"].cancel()   # withdraw the canary
                return None
            reserved.add(rid)
            rec = {"rid": rid, "port": info["port"],
                   "generation_before": info["generation"],
                   "probe": "pending", "t": time.monotonic()}
            partitions.append(rec)
            threading.Thread(target=_probe_fence, args=(rec,),
                             name=f"fence-probe-{rid}", daemon=True).start()
            return rid

        def _checkpoint_collector():
            # the restarted process's "recover" (or "promote") event
            # lives only in its memory, and the next op may kill it
            # before the periodic scrape lands
            try:
                collector.scrape_once()
            except Exception:   # noqa: BLE001 - a member may be down
                pass

        def op_directory_restart(ev, rng):
            """Crash and same-port, same-data-dir restart of the CURRENT
            primary: membership must recover from the WAL at once, with
            no agent re-advertisement."""
            name = current_primary()
            if name is None:
                return None          # mid-failover: retry next tick
            rec = dirs[name]
            rec["proc"].kill()
            rec["proc"].wait(timeout=10)
            t_down = time.monotonic()
            start_directory(name)
            gap_s = time.monotonic() - t_down
            with state_lock:
                expect = {rid for rid, info in procs.items()
                          if info["proc"].poll() is None}
            cl = dir_client(name)
            stats_after = cl.stats()
            got = {m["replica_id"] for m in cl.snapshot()["members"]}
            row = {
                "directory": name,
                "gap_s": round(gap_s, 3),
                # counted by the NEW process's recovery, before any
                # agent could have re-registered
                "recovered_members":
                    stats_after["counters"]["recovered_members"],
                "recovered_from_wal": expect <= got,
                "expected_members": sorted(expect),
                "members_at_probe": sorted(got),
                "registers_at_probe": stats_after["counters"]["registers"],
                "wal": stats_after.get("wal"),
            }
            dir_restarts.append(row)
            obs.dump_flight_bundle(flight_dir, "directory-restart",
                                   pool=router,
                                   extra=dict(row, directory_stats=stats_after))
            _checkpoint_collector()
            return name

        def op_torn_wal_restart(ev, rng):
            """Crash the current primary, append a TORN half-record to
            its WAL, restart: the tail must be truncated, never
            replayed, and membership must still recover."""
            name = current_primary()
            if name is None:
                return None
            rec = dirs[name]
            try:
                fence_before = dir_client(name).stats()["fence_counter"]
            except Exception:   # noqa: BLE001
                fence_before = None
            rec["proc"].kill()
            rec["proc"].wait(timeout=10)
            inject_torn_tail(rec["data_dir"])
            t_down = time.monotonic()
            start_directory(name)
            cl = dir_client(name)
            stats_after = cl.stats()
            row = {
                "directory": name,
                "gap_s": round(time.monotonic() - t_down, 3),
                "torn_records_truncated":
                    stats_after["counters"]["wal_torn_truncated"],
                "recovered_members":
                    stats_after["counters"]["recovered_members"],
                "members_at_probe": sorted(
                    m["replica_id"] for m in cl.snapshot()["members"]),
                "fence_before_crash": fence_before,
                "fence_after_recovery": stats_after["fence_counter"],
                "wal": stats_after.get("wal"),
            }
            torn_restarts.append(row)
            obs.dump_flight_bundle(flight_dir, "torn-wal-restart",
                                   pool=router,
                                   extra=dict(row, directory_stats=stats_after))
            _checkpoint_collector()
            return name

        def op_primary_kill(ev, rng):
            """PERMANENT primary death: d1 never restarts. The standby
            must promote itself (the epoch folded into the fence
            counter) and a canary after the failover must complete
            token-identically through it."""
            if failover or current_primary() != "d1":
                return "noop-already-failed-over"
            try:
                failover["fence_high_water_before"] = \
                    dir_client("d1").stats()["fence_counter"]
            except Exception:   # noqa: BLE001
                failover["fence_high_water_before"] = None
            dirs["d1"]["proc"].kill()
            dirs["d1"]["proc"].wait(timeout=10)
            t_kill = time.monotonic()
            deadline = t_kill + promote_after_s + 60.0
            promoted = False
            while time.monotonic() < deadline:
                try:
                    if dir_client("d2").ping()["role"] == "primary":
                        promoted = True
                        break
                except Exception:   # noqa: BLE001
                    pass
                time.sleep(0.05)
            failover["promoted"] = promoted
            failover["promoted_in_s"] = round(time.monotonic() - t_kill, 3)
            if promoted:
                st = dir_client("d2").stats()
                failover["epoch_after"] = st["epoch"]
                failover["fence_counter_after"] = st["fence_counter"]
                # a FRESH request routed and adjudicated by the promoted
                # directory; right after the promotion the fleet may
                # still be self-fenced (leases lapsed while no primary
                # answered), and typed sheds then are right: retry
                prompt = prompts[0]
                canary_deadline = time.monotonic() + 60.0
                tries = 0
                while True:
                    tries += 1
                    try:
                        h = router.submit(prompt,
                                          max_new_tokens=max_new_tokens,
                                          trace_id="canary-post-failover")
                        toks = h.result()
                        failover["canary"] = {
                            "token_identical": toks == want[tuple(prompt)],
                            "tokens": toks,
                            "served_by": h.replica_tag,
                            "resubmits": h.resubmits, "tries": tries,
                            "s": round(time.monotonic() - t_kill, 3)}
                        break
                    except Exception as e:   # noqa: BLE001 - typed shed
                        failover["canary"] = {
                            "token_identical": False,
                            "error": type(e).__name__, "tries": tries}
                        if time.monotonic() > canary_deadline:
                            break
                        time.sleep(0.1)
                # the promoted log now: a later crash of d2 wipes its
                # in-memory events (only durable state rides the WAL)
                try:
                    failover["d2_events"] = dir_client("d2").events()[
                        "events"]
                except Exception:   # noqa: BLE001
                    failover["d2_events"] = []
            obs.dump_flight_bundle(
                flight_dir, "primary-failover", pool=router,
                extra={k: v for k, v in failover.items()
                       if k != "d2_events"})
            _checkpoint_collector()
            return "d1"

        provider = FleetCapacityProvider(
            endpoints, model=model, token_delay_s=token_delay_s,
            rid_prefix="churn", spawn_timeout_s=240.0,
            extra_args=agent_args)

        def op_autoscale_churn(ev, rng):
            """The autoscaler's lifecycle end to end: a provider ticket,
            a real agent process (spawn, register, warm), the router's
            harvest, service under load, a drain with lease retirement
            and a tombstone, the reap. Churn agents are the provider's,
            not in ``procs``: the supervisor never resurrects one."""
            ticket = provider.request()
            row = {"ticket": ticket, "state": "provisioning",
                   "t_request": round(time.monotonic() - t0, 3)}
            churns.append(row)

            def _lifecycle():
                t_spawn = time.monotonic()
                ready = False
                while (time.monotonic() < t_spawn + 240.0
                       and not stop_all.is_set()):
                    try:
                        ready = provider.ready(ticket)
                    except Exception as e:   # noqa: BLE001
                        row["state"] = f"spawn-failed:{type(e).__name__}"
                        return
                    if ready:
                        break
                    time.sleep(0.1)
                if not ready:
                    row["state"] = "never-ready"
                    return
                row["ready_in_s"] = round(time.monotonic() - t_spawn, 3)
                row["eta_hint_s"] = round(provider.eta_s(ticket), 3)
                idx = router.add_replica_for_ticket(ticket)
                row["added_idx"] = idx
                row["state"] = "serving"
                # real traffic before the retirement
                time.sleep(max(2.0 * lease_ttl_s, 1.0))
                # the drain may race a failover window in which the
                # agent is self-fenced (not routable): retry until it
                # rejoins and drains cleanly
                t_retire = time.monotonic()
                retired = []
                retire_deadline = time.monotonic() + 90.0
                while (not retired and time.monotonic() < retire_deadline
                       and not stop_all.is_set()):
                    retired = router.scale_down(1, rids=[ticket])
                    if not retired:
                        time.sleep(0.2)
                row["retired_idxs"] = retired
                provider.release(ticket)
                chk_deadline = time.monotonic() + 30.0
                while time.monotonic() < chk_deadline:
                    try:
                        snap = dc.snapshot()
                        row["absent_after_retire"] = ticket not in {
                            m["replica_id"] for m in snap["members"]}
                        row["tombstoned"] = ticket in dc.stats()[
                            "tombstones"]
                        if (row.get("absent_after_retire")
                                and row.get("tombstoned")):
                            break
                    except Exception:   # noqa: BLE001 - directory down
                        pass
                    time.sleep(0.2)
                row["retire_s"] = round(time.monotonic() - t_retire, 3)
                row["state"] = "retired"

            th = threading.Thread(target=_lifecycle, name=f"churn-{ticket}",
                                  daemon=True)
            churn_threads.append(th)
            th.start()
            return ticket

        schedule = chaos.make_fleet_schedule(seed, duration_s,
                                             partition_s=partition_s)
        injector = chaos.FleetChaosInjector(
            schedule, {"kill_agent": op_kill, "partition": op_partition,
                       "directory_restart": op_directory_restart,
                       "primary_kill": op_primary_kill,
                       "torn_wal_restart": op_torn_wal_restart,
                       "autoscale_churn": op_autoscale_churn},
            seed=seed)

        # ---------------------------------------------------- load
        from ray_tpu_torch.serve.errors import (DeadlineExceeded,
                                                EngineDraining,
                                                EngineOverloaded,
                                                EngineShutdown,
                                                RequestCancelled,
                                                retry_after_s)
        results = {"completed": 0, "failed_typed": 0, "lost": 0,
                   "mismatched": 0, "shed": 0}
        failures = []
        parted = []          # (prompt, tokens, resubmits) off the truth
        resubmitted_ok = [0]
        res_lock = threading.Lock()
        typed = (RequestCancelled, DeadlineExceeded, EngineOverloaded,
                 EngineDraining, EngineShutdown)

        def client(ci):
            import random
            rng = random.Random(seed * 1000 + ci)
            n = 0
            while not stop_load.is_set():
                n += 1
                prompt = prompts[rng.randrange(len(prompts))]
                try:
                    h = router.submit(prompt, max_new_tokens=max_new_tokens,
                                      trace_id=f"fleet-c{ci}-{n}")
                except (EngineOverloaded, EngineShutdown) as e:
                    with res_lock:
                        results["shed"] += 1
                        failures.append((type(e).__name__,
                                         retry_after_s(e, default=0.0)))
                    time.sleep(0.05)
                    continue
                try:
                    toks = h.result()
                except typed as e:
                    with res_lock:
                        results["failed_typed"] += 1
                        failures.append((type(e).__name__,
                                         retry_after_s(e, default=0.0)))
                    continue
                except Exception as e:   # noqa: BLE001 - counted as lost
                    with res_lock:
                        results["lost"] += 1
                        failures.append((type(e).__name__, None))
                    continue
                with res_lock:
                    if toks == want[tuple(prompt)]:
                        results["completed"] += 1
                        if h.resubmits:
                            resubmitted_ok[0] += 1
                    else:
                        parted.append((prompt, toks, h.resubmits))

        threads = [threading.Thread(target=client, args=(i,),
                                    name=f"fleet-client-{i}", daemon=True)
                   for i in range(clients)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        injector.start()

        # until the whole schedule fired, then partitions heal and
        # resubmissions settle on the survivors
        settle = t0 + duration_s + partition_s + 60.0
        while time.monotonic() < settle:
            if injector.done() and all(p["probe"] != "pending"
                                       for p in partitions):
                break
            time.sleep(0.05)
        time.sleep(2 * lease_ttl_s)   # fenced victims rejoin
        # the canaries: each was in flight on a victim with no token
        # delivered, so each must complete token-identically from
        # ANOTHER agent through suspect -> confirmed dead -> resubmit
        for c in canaries:
            h = c["handle"]
            try:
                toks = h.result()
            except Exception as e:   # noqa: BLE001 - recorded
                c["outcome"] = f"failed:{type(e).__name__}"
                with res_lock:
                    results["failed_typed"] += 1
                continue
            c["resubmits"] = h.resubmits
            c["served_by"] = h.replica_tag
            if toks == want[tuple(c["prompt"])]:
                c["outcome"] = "completed"
                with res_lock:
                    results["completed"] += 1
                    if h.resubmits:
                        resubmitted_ok[0] += 1
            else:
                c["outcome"] = "parted"
                c["tokens"] = toks
                with res_lock:
                    parted.append((c["prompt"], toks, h.resubmits))
        # the churn settles before the load stops: the retired agent
        # must have drained while the clients were still sending
        for th in churn_threads:
            th.join(timeout=300)
        stop_load.set()
        for t in threads:
            t.join(timeout=60)
        injector.stop()

        # every SIGKILLed incarnation must end directory-confirmed dead
        # with a bundle explaining it; should no request have touched
        # the corpse, drive the suspect path the clients would have
        for k in killed:
            router._confirm_dead(
                k["member"], TransportError(
                    f"harness probe: {k['rid']} was SIGKILLed by the "
                    f"campaign"))

        # a parting from the truth: a near-tie on the card (counted
        # apart, printed, never completed), a mismatch anywhere else
        near_ties = []
        for prompt, toks, _resub in parted:
            gap = (_near_tie_gap(ref_model, prompt, want[tuple(prompt)],
                                 toks) if near_ties_allowed else None)
            if gap is not None and gap <= NEAR_TIE_GAP:
                near_ties.append({"prompt": prompt, "tokens": toks,
                                  "want": want[tuple(prompt)],
                                  "gap": gap})
            else:
                results["mismatched"] += 1
        for c in canaries:
            if c["outcome"] == "parted":
                gap = (_near_tie_gap(ref_model, c["prompt"],
                                     want[tuple(c["prompt"])], c["tokens"])
                       if near_ties_allowed else None)
                c["outcome"] = ("near_tie" if gap is not None
                                and gap <= NEAR_TIE_GAP else "mismatched")
        results["near_tie"] = len(near_ties)
        for row in near_ties:
            print(f"torch_chaos_serve: near-tie parting, gap "
                  f"{row['gap']:.4f}: prompt {row['prompt']} gave "
                  f"{row['tokens']}, the lone engine {row['want']}",
                  file=sys.stderr)

        # ------------------------------------------------ evidence
        wall = time.monotonic() - t0
        counts = injector.injected_counts()
        for kind in chaos.FLEET_KINDS:
            assert counts.get(kind, 0) >= 1, f"schedule never fired a {kind}"
        admitted = (results["completed"] + results["failed_typed"]
                    + results["lost"] + results["mismatched"]
                    + results["near_tie"])
        assert admitted > 0, "campaign saw no admitted requests"
        assert results["lost"] == 0, (
            f"{results['lost']} admitted requests lost (untyped); "
            f"failure types: {[n for n, _ in failures]}")
        assert results["mismatched"] == 0, (
            f"{results['mismatched']} completions diverged from the "
            f"reference: {parted}")
        for name, hint in failures:
            if name == "EngineOverloaded":
                assert hint and hint > 0, "shed without a Retry-After hint"

        # the fleet recovered: every replica id serves again
        rec_deadline = time.monotonic() + 180.0
        while time.monotonic() < rec_deadline:
            with state_lock:
                live = {rid: info for rid, info in procs.items()
                        if info["proc"].poll() is None}
            if len(live) == agents:
                break
            time.sleep(0.2)
        assert len(live) == agents, (
            f"only {sorted(live)} of {agents} agents alive at exit; "
            f"supervisor errors: {list(sup_errors)}")
        agent_stats = {rid: AgentClient(SocketTransport(
            ("127.0.0.1", info["port"]))).stats()
            for rid, info in sorted(live.items())}

        # the partition explained: the victim self-fenced in its own
        # process and refused an admission probe while fenced, or cycled
        # through the fenced state into a bumped generation
        for p in partitions:
            st = agent_stats.get(p["rid"])
            assert st is not None, f"partition victim {p['rid']} gone"
            assert st["counters"]["self_fences"] >= 1, (
                f"partitioned {p['rid']} never self-fenced: "
                f"{st['counters']}")
            p["generation_after"] = st["generation"]
            assert (p["probe"] == "refused_fenced"
                    or st["generation"] > p["generation_before"]), (
                f"no proof {p['rid']} refused admissions while fenced: "
                f"probe={p['probe']} gen {p['generation_before']} -> "
                f"{st['generation']}")

        for rid, info in sorted(live.items()):
            q = AgentClient(SocketTransport(
                ("127.0.0.1", info["port"]))).quiesce()
            assert q.get("ok"), f"{rid} failed quiescence: {q}"

        ok_outcomes = ("completed", "near_tie") if near_ties_allowed \
            else ("completed",)
        assert canaries, "no canary landed on any victim"
        for c in canaries:
            assert c["outcome"] in ok_outcomes, (
                f"canary on {c['kind']} victim {c['rid']} ended "
                f"{c['outcome']} (want a token-identical completion via "
                f"resubmit)")
            assert c["resubmits"] >= 1, (
                f"canary on {c['kind']} victim {c['rid']} completed "
                f"without a resubmit (fault landed after completion?)")
            assert c["served_by"] != c["incarnation"], (
                f"canary resubmit landed back on the faulted incarnation "
                f"{c['served_by']}")
        assert resubmitted_ok[0] >= 1

        attainment = results["completed"] / admitted
        assert attainment >= attainment_floor, \
            f"attainment {attainment:.3f} below floor {attainment_floor}"

        # ------------------------------------------- flight recorder
        obs.dump_flight_bundle(flight_dir, "fleet-campaign-end",
                               pool=router,
                               extra={"injected": counts,
                                      "agent_stats": agent_stats})
        bundles = []
        for bdir in sorted(glob.glob(os.path.join(flight_dir, "*"))):
            if not os.path.isdir(bdir):
                continue
            try:
                b = obs.load_flight_bundle(bdir)
            except Exception:   # noqa: BLE001 - half-written: skip
                continue
            bundles.append({"path": os.path.basename(bdir),
                            "reason": b.get("reason"), "pid": b.get("pid"),
                            "extra": b.get("extra")})
        reasons = [str(b["reason"]) for b in bundles]
        for k in killed:
            assert f"agent-dead-{k['rid']}" in reasons, (
                f"no flight bundle explains the SIGKILL of {k['rid']}; "
                f"reasons on disk: {sorted(set(reasons))}")
        for p in partitions:
            fb = [b for b in bundles
                  if b["reason"] == f"self-fenced-{p['rid']}"
                  and (b["extra"] or {}).get("lease_overdue_s", -1) >= 0]
            assert fb, (f"no self-fence bundle from partitioned {p['rid']}; "
                        f"reasons on disk: {sorted(set(reasons))}")
            # dumped by the agent's own process, not this one
            assert fb[-1]["pid"] != os.getpid()
        for d in dir_restarts:
            assert d["recovered_from_wal"], (
                f"membership did not recover from the WAL after the "
                f"directory restart: {d}")
            assert d["recovered_members"] >= 1, (
                f"restarted directory recovered an empty table: {d}")
            assert "directory-restart" in reasons
        assert torn_restarts, "schedule never fired a torn_wal_restart"
        for d in torn_restarts:
            assert d["torn_records_truncated"] >= 1, (
                f"torn WAL tail was not detected/truncated: {d}")
            assert d["recovered_members"] >= 1, (
                f"torn-tail recovery lost the whole table: {d}")
            assert (d["fence_before_crash"] is None
                    or d["fence_after_recovery"] >= d["fence_before_crash"]), (
                f"fence counter regressed across torn-WAL recovery: {d}")
            assert "torn-wal-restart" in reasons
        assert failover.get("promoted"), (
            f"standby never promoted after the permanent primary kill: "
            f"{failover}")
        canary = failover["canary"]
        canary_ok = canary.get("token_identical") or (
            near_ties_allowed and "tokens" in canary
            and _near_tie_gap(ref_model, prompts[0], want[tuple(prompts[0])],
                              canary["tokens"]) <= NEAR_TIE_GAP)
        assert canary_ok, (f"post-failover canary did not complete "
                           f"token-identically: {canary}")
        assert "primary-failover" in reasons

        # fencing tokens MONOTONIC across the failover, from the promoted
        # directory's own log: every fence it saw replicated, the
        # promotion's bump, every fence it issued. The live log has the
        # issues after the failover too; the log kept at the promotion
        # stands in should a later crash of d2 have wiped it
        d2_events = failover.get("d2_events") or []
        try:
            live_events = dir_client("d2").events()["events"]
            if any(e["kind"] == "promote" for e in live_events):
                d2_events = live_events
        except Exception:   # noqa: BLE001
            pass
        promote_evs = [e for e in d2_events if e["kind"] == "promote"]
        assert promote_evs, "promoted directory logged no promote event"
        pi = d2_events.index(promote_evs[0])
        pre = [e["fence"] for e in d2_events[:pi]
               if e["kind"] in ("repl_member", "fence_issued")]
        post = [e["fence"] for e in d2_events[pi + 1:]
                if e["kind"] == "fence_issued"]
        bump = promote_evs[0]
        assert bump["fence_after"] > bump["fence_before"], bump
        assert bump["fence_after"] > max(pre, default=0), (
            f"promotion bump {bump} does not clear the replicated "
            f"high-water {max(pre, default=0)}")
        hw = failover.get("fence_high_water_before")
        if hw is not None:
            assert bump["fence_after"] > hw, (
                f"promotion bump {bump} does not clear the dead primary's "
                f"high-water {hw}")
        assert all(b > a for a, b in zip(post, post[1:])), (
            f"post-failover issued fences not strictly increasing: {post}")
        assert all(f > bump["fence_before"] for f in post), (
            f"a post-failover fence fell below the pre-promotion counter: "
            f"{post} vs {bump}")
        # one more issue through the promoted directory, so the proof
        # never rests on an empty list
        fr = dc.register("fence-canary", ["loopback", "fence-canary"], 0,
                         page_size=0, min_fence=0)
        assert fr["fence"] > bump["fence_before"]
        assert fr["fence"] >= bump["fence_after"]
        if hw is not None:
            assert fr["fence"] > hw
        dc.deregister("fence-canary", fr["fence"])
        fence_monotonic = True

        assert churns, "schedule never fired an autoscale_churn"
        for c in churns:
            assert c["state"] == "retired", (
                f"churn agent never completed its lifecycle: {c}")
            assert c.get("absent_after_retire"), (
                f"retired churn agent still in membership: {c}")
            assert c.get("tombstoned"), (
                f"retired churn agent left no tombstone: {c}")
        assert provider.live_count() == 0, (
            f"provider leaked {provider.live_count()} agent processes")
        assert router.counters["stale_snapshots"] >= 1, (
            "router never served from a stale snapshot during the "
            "directory outage")

        # ---------------------------------- cluster flight recorder
        collector.stop()
        try:
            collector.scrape_once()   # the events since the last tick
        except Exception:   # noqa: BLE001 - a member may be down
            pass
        cbundles = list(collector.bundles)
        creasons = [str(b["reason"]) for b in cbundles]
        for k in killed:
            assert f"agent-dead-{k['rid']}" in creasons, (
                f"no cluster bundle explains the SIGKILL of {k['rid']}; "
                f"cluster reasons on disk: {sorted(set(creasons))}")
        for p in partitions:
            assert f"self_fence-{p['rid']}" in creasons, (
                f"no cluster bundle explains the partition self-fence of "
                f"{p['rid']}; cluster reasons on disk: "
                f"{sorted(set(creasons))}")
        recover_cb = [b for b in cbundles
                      if str(b["reason"]).startswith("recover-")]
        assert recover_cb, (
            f"no cluster bundle explains any directory recovery; cluster "
            f"reasons on disk: {sorted(set(creasons))}")
        assert any(((b.get("trigger") or {}).get("data") or {})
                   .get("torn_truncated", 0) >= 1 for b in recover_cb), (
            "no cluster bundle carries a recover trigger with a truncated "
            "torn WAL tail")
        assert any(r.startswith("promote-") for r in creasons), (
            f"no cluster bundle explains the standby promotion; cluster "
            f"reasons on disk: {sorted(set(creasons))}")
        for b in cbundles:
            cb = load_cluster_bundle(b["path"])
            assert cb["reason"] == b["reason"]
            assert cb["members"], f"bundle {b['path']} has no members"
        collector_health = collector.health()

        # ------------------------------------------------ recovery
        merged = collector.merged_events()
        router_events = router.events.snapshot()

        def confirm_s(k):
            t = [e[obs.T] for e in router_events
                 if e[obs.ETYPE] == "member_dead" and e[obs.SID] == k["rid"]
                 and e[obs.T] >= k["t"]]
            return round(min(t) - k["t"], 4) if t else None

        def fence_s(p):
            t = [e["local_t"] for e in merged
                 if e["type"] == "self_fence" and e["member"] == p["rid"]
                 and e["local_t"] is not None and e["local_t"] >= p["t"]]
            return round(min(t) - p["t"], 4) if t else None

        recovery = {
            "kill_agent_confirmed_dead_s": [confirm_s(k) for k in killed],
            "partition_self_fence_s": [fence_s(p) for p in partitions],
            "directory_restart_ready_s": [d["gap_s"] for d in dir_restarts],
            "torn_wal_restart_ready_s": [d["gap_s"] for d in torn_restarts],
            "primary_kill_promoted_s": failover.get("promoted_in_s"),
            "post_failover_canary_s": canary.get("s"),
            "churn_ready_s": [c.get("ready_in_s") for c in churns],
            "churn_retire_s": [c.get("retire_s") for c in churns],
            "directory_ready_s": {n: dirs[n].get("ready_s")
                                  for n in ("d1", "d2")},
            "agents_boot_s": round(boot_s, 3),
        }

        try:
            sha = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                capture_output=True, text=True, timeout=10
            ).stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            sha = None

        dirs_spawned = 2 + len(dir_restarts) + len(torn_restarts)
        artifact = {
            "schema_version": 2,
            "notes": (
                "Seeded cross-process fleet chaos of the PyTorch port over "
                "a durable, replicated control plane: replica agents as OS "
                "processes behind a primary and standby directory pair, "
                "under load through the socket transport. Faults: agent "
                "SIGKILL (directory-confirmed death, token-identical "
                "resubmit), a two-way partition longer than the lease "
                "(self-fence, refused admission, rejoin under a bumped "
                "generation), directory SIGKILL and same-port restart "
                "(membership from the WAL), a torn WAL tail (truncated, "
                "never replayed), a permanent primary kill (the standby "
                "promotes with an epoch-folded fence bump) and autoscaler "
                "churn. Gates: zero admitted requests lost, zero token "
                "mismatches (a near-tie parting on the card counted "
                "apart), every fault explained by a flight bundle and a "
                "cluster bundle, live agents quiesced."),
            "seed": seed,
            "topology": {
                "agents": agents,
                "transport": "tcp-json-v1",
                "directories": ["primary", "standby"],
                "processes": {
                    "directories_spawned": dirs_spawned,
                    "agents_spawned": len(spawned) - dirs_spawned,
                    "churn_agents_spawned": provider.stats["spawned"],
                },
                "model": model,
                "layers": layers if model == "tinyllama" else None,
                "device": ("cuda" if cuda else "cpu") if model != "fake"
                else None,
                "engine_knobs": knobs if model != "fake" else None,
                "lease_ttl_s": lease_ttl_s,
                "promote_after_s": promote_after_s,
            },
            "knobs": {
                "duration_s": duration_s, "clients": clients,
                "max_new_tokens": max_new_tokens,
                "partition_s": partition_s,
                "token_delay_s": token_delay_s if model == "fake" else None,
            },
            "schedule": [e.as_dict() for e in injector.schedule],
            "injected": counts,
            "requests": dict(results, admitted=admitted,
                             resubmitted_ok=resubmitted_ok[0]),
            "near_ties": near_ties,
            "attainment": round(attainment, 4),
            "attainment_floor": attainment_floor,
            "fleet": {
                "router": router.pool_stats(),
                "directory": dc.stats(),
                "agents": {rid: {"generation": st["generation"],
                                 "counters": st["counters"],
                                 "engine": st.get("stats")}
                           for rid, st in agent_stats.items()},
                "kills": [{k2: v for k2, v in k.items()
                           if k2 not in ("member", "t")} for k in killed],
                "partitions": [{k2: v for k2, v in p.items() if k2 != "t"}
                               for p in partitions],
                "canaries": [{k2: v for k2, v in c.items()
                              if k2 not in ("handle", "prompt")}
                             for c in canaries],
            },
            "wal_recovery": {
                "directory_restarts": dir_restarts,
                "torn_wal_restarts": torn_restarts,
            },
            "failover": {k2: v for k2, v in failover.items()
                         if k2 != "d2_events"},
            "fence_monotonic": fence_monotonic,
            "autoscale_churn": {"churns": churns,
                                "provider": dict(provider.stats)},
            "recovery": recovery,
            "card_memory": ({"free_before_agents": mem0,
                             "free_after_boot": mem1,
                             "weight_bytes": weight_bytes}
                            if cuda else None),
            "flight_recorder": {
                "dir": flight_dir,
                "bundles": len(bundles),
                "reasons": sorted(set(reasons)),
                "kill_explained": True,
                "partition_explained": True,
                "directory_restart_explained": True,
                "torn_wal_explained": True,
                "failover_explained": True,
                "faults_explained": True,
            },
            "cluster_flight_recorder": {
                "dir": cluster_dir,
                "bundles": len(cbundles),
                "reasons": sorted(set(creasons)),
                "collector": collector_health,
                "kill_explained": True,
                "partition_explained": True,
                "recover_explained": True,
                "torn_wal_explained": True,
                "failover_explained": True,
                "faults_explained": True,
            },
            "quiesced": True,
            "wall_s": round(wall, 2),
            "git_sha": sha,
        }
        return artifact
    except BaseException:
        for name in sorted(os.listdir(work)):
            if name.endswith(".log"):
                print(f"--- {name}, last lines:\n"
                      f"{_tail(os.path.join(work, name))}", file=sys.stderr)
        raise
    finally:
        stop_load.set()
        stop_all.set()
        if injector is not None and injector._thread.is_alive():
            injector.stop()
        if collector is not None:
            collector.stop()
        if sup is not None:
            sup.join(timeout=30)
        for t in threads:
            t.join(timeout=30)
        if router is not None:
            router.shutdown()
        if provider is not None:
            provider.stop_all()
        for p in spawned:
            if p.poll() is None:
                p.kill()
        for p in spawned:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fleet", action="store_true",
                    help="the cross-process campaign (the only one ported)")
    ap.add_argument("--seed", type=int, default=47)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--model", choices=("fake", "tiny", "tinyllama"),
                    default="tiny")
    ap.add_argument("--layers", type=int, default=22,
                    help="tinyllama: layers of TinyLlama-1.1B's widths")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--lease-ttl", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not args.fleet:
        print("torch_chaos_serve: the in-process pool campaign waits for "
              "the fleet's fourth slice (ROADMAP.md, queue 1, item 9); "
              "pass --fleet", file=sys.stderr)
        return 2
    artifact = run_fleet_chaos(
        seed=args.seed, agents=args.replicas, duration_s=args.duration,
        clients=args.clients, lease_ttl_s=args.lease_ttl, model=args.model,
        layers=args.layers, device=args.device)
    print(json.dumps(artifact, indent=1, default=repr))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1, default=repr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
