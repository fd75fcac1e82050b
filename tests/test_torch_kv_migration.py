"""The port's cross-replica KV pull (ray_tpu_torch.serve.kv_migration,
the fleet wire and transport, and the engine's donor and requester)
against the JAX package's, on the CPU.

Protocol cases (tests/test_kv_migration.py, the fake-engine layer):
each case runs the same script through both packages' ``KVDonor``,
``pull_prefix`` and transports over one donor double and returns what
it saw — payloads, stats, wire bytes, fault counts — and the two
records must be EQUAL; each case also asserts the reference test's own
properties. ``FaultyTransport`` draws in the reference's order, so one
seed gives both packages one drop-and-duplicate sequence. The wire
cases hold ``wire.encode`` to the reference's bytes and send a pull
across the packages over a socket.

Engine cases (the engine layer of the same file): ``llama_tiny`` fp32
with the flax params of PRNGKey(0) in both packages, each engine of
the JAX package with ``overlap=False``. A pulled prefix decodes
token-identically to a cold recompute, and the two packages' records
(streams, stats, events, landed page bytes) are equal, for fp and int8
pools; a pull also crosses the packages both ways over one loopback
wire (a JAX donor engine to a port requester, a port donor to a JAX
requester). Every failed pull falls back to plain prefill, counted; a
stopped donor refuses export and pins nothing. The reference's pool
case waits for the port's engine pool (ROADMAP.md, queue 1, item 6).
"""
import base64
import socket
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import engine as jeng
from ray_tpu.serve import kv_migration as jkm
from ray_tpu.serve.fleet import transport as jtr
from ray_tpu.serve.fleet import wire as jwire
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import kv_migration as tkm
from ray_tpu_torch.serve.fleet import transport as ttr
from ray_tpu_torch.serve.fleet import wire as twire
from ray_tpu_torch.serve.prefix_cache import path_hashes

_PKGS = {"jax": types.SimpleNamespace(km=jkm, tr=jtr, wire=jwire),
         "torch": types.SimpleNamespace(km=tkm, tr=ttr, wire=twire)}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeEngine:
    """Donor-contract double: a resident hash chain, page bytes per
    layer, and pin refcounts — everything ``KVDonor`` touches."""

    def __init__(self, n_pages=6, page_size=4, n_layers=2,
                 page_bytes=64, kv_dtype="int8"):
        self.Pg = page_size
        self.page_bytes = page_bytes
        self.kv_dtype = kv_dtype
        self.cfg = types.SimpleNamespace(n_layers=n_layers)
        self.chain = [1000 + i for i in range(n_pages)]
        self.refs = {p: 0 for p in range(n_pages)}
        self.data = {
            p: [[b"K%d.%d" % (p, i), b"V%d.%d" % (p, i)]
                for i in range(n_layers)]
            for p in range(n_pages)}

    def kv_pin_prefix(self, hashes):
        pages = []
        for i, h in enumerate(hashes):
            if i < len(self.chain) and self.chain[i] == h:
                self.refs[i] += 1
                pages.append(i)
            else:
                break
        return pages

    def kv_export_pages(self, pages):
        return [self.data[p] for p in pages]

    def kv_release_pages(self, pages):
        for p in pages:
            self.refs[p] -= 1


def _pull(pkg, donor, hashes, **kw):
    return pkg.km.pull_prefix(pkg.km.loopback_call(donor), hashes, **kw)


def _no_pins(eng):
    return all(r == 0 for r in eng.refs.values())


# ----------------------------------------------------- protocol cases


def _roundtrip(pkg):
    eng = FakeEngine(n_pages=6, page_bytes=64)
    # 128-byte chunk budget over 64-byte pages: 2 pages a chunk, 3 chunks
    donor = pkg.km.KVDonor(eng, max_chunk_bytes=128)
    stats = pkg.km.new_stats()
    payload = _pull(pkg, donor, eng.chain, stats=stats)
    assert payload["n_pages"] == 6 and payload["page_size"] == eng.Pg
    assert payload["kv_dtype"] == "int8"
    assert payload["n_layers"] == eng.cfg.n_layers
    assert payload["digest"] == eng.chain[-1]
    assert payload["pages"] == [eng.data[p] for p in range(6)]
    assert payload["wire_bytes"] == sum(
        len(base64.b64encode(b)) for p in range(6)
        for layer in eng.data[p] for b in layer)
    assert stats == {"pulls": 1, "pulled_pages": 6,
                     "wire_bytes": payload["wire_bytes"], "aborts": 0,
                     "fallbacks": 0}
    assert donor.open_transfers() == 0 and _no_pins(eng)
    return payload, stats


def _longest_resident_run(pkg):
    eng = FakeEngine(n_pages=4)
    payload = _pull(pkg, pkg.km.KVDonor(eng), eng.chain + [7777, 8888])
    assert payload["n_pages"] == 4 and payload["digest"] == eng.chain[3]
    assert _no_pins(eng)
    return payload


def _typed_abort_when_nothing_resident(pkg):
    eng = FakeEngine(n_pages=4)
    stats = pkg.km.new_stats()
    assert _pull(pkg, pkg.km.KVDonor(eng), [5555, 6666],
                 stats=stats) is None
    assert stats["pulls"] == 1 and stats["aborts"] == 1
    assert stats["pulled_pages"] == 0 and _no_pins(eng)
    return stats


def _deadline_aborts_and_gc_reclaims_pin(pkg):
    clock = FakeClock()
    eng = FakeEngine(n_pages=6, page_bytes=64)
    donor = pkg.km.KVDonor(eng, max_chunk_bytes=64, pin_ttl_s=5.0,
                           time_fn=clock)
    call = pkg.km.loopback_call(donor)

    def slow_call(method, args):
        if method == "kv_pull_chunk":
            clock.advance(10.0)       # every chunk blows the budget
        return call(method, args)

    stats = pkg.km.new_stats()
    out = pkg.km.pull_prefix(slow_call, eng.chain, deadline_s=1.0,
                             stats=stats, time_fn=clock)
    assert out is None and stats["aborts"] == 1
    # the requester never sent end; the pin-TTL GC is the backstop
    assert donor.open_transfers() == 0 and _no_pins(eng)
    return stats


def _dedupe_under_faulty_transport(pkg):
    """Drops and duplicate deliveries mid-pull: the (digest, chunk_idx)
    dedupe keeps the payload and the wire bytes those of a clean pull,
    and one seed gives one fault sequence per package."""
    eng = FakeEngine(n_pages=6, page_bytes=64)
    clean = _pull(pkg, pkg.km.KVDonor(eng, max_chunk_bytes=64), eng.chain)
    runs, exercised = [], False
    for seed in range(24):
        eng2 = FakeEngine(n_pages=6, page_bytes=64)
        clock = FakeClock()
        donor = pkg.km.KVDonor(eng2, max_chunk_bytes=64, pin_ttl_s=1.0,
                               time_fn=clock)
        ft = pkg.tr.FaultyTransport(
            pkg.tr.LoopbackTransport(
                lambda m, a, _t, d=donor: d.handle(m, a)),
            seed=seed, drop_p=0.15, dup_p=0.3)
        stats = pkg.km.new_stats()
        out = pkg.km.pull_prefix(lambda m, a: ft.call(m, a), eng2.chain,
                                 max_attempts=8, backoff_s=0.0,
                                 stats=stats)
        if out is None:
            # a dropped begin (no retry by design) aborts typed
            assert stats["aborts"] == 1
        else:
            assert out["pages"] == clean["pages"]
            assert out["wire_bytes"] == clean["wire_bytes"]
            assert stats["pulled_pages"] == 6
            exercised |= (ft.stats["dropped"] >= 1
                          and ft.stats["duplicated"] >= 1)
        clock.advance(2.0)
        assert donor.open_transfers() == 0
        assert _no_pins(eng2), f"seed {seed}: leaked pins {eng2.refs}"
        runs.append((out is None, stats, dict(ft.stats)))
    assert exercised, "no seed completed a pull through a drop and a dup"
    return runs


def _refuses_unknown_or_expired_transfer(pkg):
    clock = FakeClock()
    eng = FakeEngine(n_pages=2)
    donor = pkg.km.KVDonor(eng, pin_ttl_s=1.0, time_fn=clock)
    begin = donor.begin(eng.chain[:2])
    msgs = []
    for xid, idx, advance in (("never-issued", 0, 0.0),
                              (begin["xfer_id"], 99, 0.0),
                              (begin["xfer_id"], 0, 2.0)):
        clock.advance(advance)
        with pytest.raises(pkg.wire.KVPullAborted) as ei:
            donor.chunk(xid, idx)
        msgs.append(str(ei.value))
    assert _no_pins(eng)
    return begin, msgs


def _max_frame_knob_rejects_oversize_frames(pkg):
    msgs = []
    prev = pkg.tr.set_max_frame_bytes(2048)
    try:
        a, b = socket.socketpair()
        try:
            with pytest.raises(pkg.tr.TransportError,
                               match="max-frame knob") as ei:
                pkg.tr.send_frame(a, b"x" * 4096)
            msgs.append(str(ei.value))
            # a peer announcing an oversize frame is refused before any
            # payload byte is read
            a.sendall(pkg.tr._LEN.pack(1 << 20))
            with pytest.raises(pkg.tr.TransportError,
                               match="max-frame knob") as ei:
                pkg.tr.recv_frame(b)
            msgs.append(str(ei.value))
        finally:
            a.close()
            b.close()
        with pytest.raises(ValueError) as ei:
            pkg.tr.set_max_frame_bytes(100)       # below the floor
        msgs.append(str(ei.value))
    finally:
        pkg.tr.set_max_frame_bytes(prev)
    return msgs


def _chunks_size_under_the_frame_knob(pkg):
    eng = FakeEngine(n_pages=8, page_bytes=1024)
    donor = pkg.km.KVDonor(eng)
    prev = pkg.tr.set_max_frame_bytes(4096)
    try:
        b1 = donor.begin(eng.chain)
        # 4096 // 2 = 2048-byte budget over 1 KiB pages: 2 a chunk
        assert b1["pages_per_chunk"] == 2 and b1["n_chunks"] == 4
        donor.end(b1["xfer_id"])
        pkg.tr.set_max_frame_bytes(2048)
        b2 = donor.begin(eng.chain)
        assert b2["pages_per_chunk"] == 1 and b2["n_chunks"] == 8
        donor.end(b2["xfer_id"])
    finally:
        pkg.tr.set_max_frame_bytes(prev)
    assert _no_pins(eng)
    return b1, b2


def _validate_knobs_and_push_hint(pkg):
    out = [pkg.km.validate_pull_knobs(), pkg.km.validate_pull_knobs(
        deadline_s=2, backoff_s="0.5")]
    for bad in (0, -1.0, float("nan"), float("inf"), "junk"):
        with pytest.raises(ValueError) as ei:
            pkg.km.validate_pull_knobs(deadline_s=bad)
        out.append(str(ei.value))
    prompt = list(range(1, 22))
    out += [pkg.km.prefill_push_hint(prompt, 8, replica_idx=1),
            pkg.km.prefill_push_hint(prompt[:7], 8),
            pkg.km.prefill_push_hint(prompt, 0)]
    assert out[-3]["hashes"] == path_hashes(prompt, 8)[:2]
    assert out[-2] is None and out[-1] is None
    stats = pkg.km.new_stats()
    pkg.km.count_fallback(stats)
    return out, stats


@pytest.mark.parametrize("case", [
    _roundtrip, _longest_resident_run, _typed_abort_when_nothing_resident,
    _deadline_aborts_and_gc_reclaims_pin, _dedupe_under_faulty_transport,
    _refuses_unknown_or_expired_transfer,
    _max_frame_knob_rejects_oversize_frames,
    _chunks_size_under_the_frame_knob, _validate_knobs_and_push_hint],
    ids=lambda f: f.__name__.strip("_"))
def test_protocol_case_matches_reference(case):
    assert case(_PKGS["torch"]) == case(_PKGS["jax"])


def test_migration_metrics_keep_the_reference_names():
    from ray_tpu.util import metrics as jmetrics
    from ray_tpu_torch.util import metrics as tmetrics
    texts = []
    for pkg, reg in ((_PKGS["torch"], tmetrics), (_PKGS["jax"], jmetrics)):
        pkg.km._metrics()
        texts.append(sorted(n for n in reg.registry()
                            if n.startswith("serve_kv_migration_")))
    assert texts[0] == texts[1] and len(texts[0]) == 5


# ------------------------------------------------------- wire cases


def _envelopes(wire, errors):
    exc = errors.EngineOverloaded("queue full", retry_after_s=2.5)
    return [wire.request("kv_pull_chunk", {"xfer_id": "x1",
                                           "chunk_idx": 3}, "t-1"),
            wire.request("kv_pull_begin", {"hashes": [1, -2, 3]}),
            wire.ok({"b": [1, 2], "a": "é"}), wire.err(exc),
            wire.err(wire.KVPullAborted("prefix gone")),
            wire.err(RuntimeError("boom"))]


def test_wire_encode_is_byte_identical_to_reference():
    from ray_tpu.serve import errors as jerr
    ours = [twire.encode(e) for e in _envelopes(twire, terr)]
    ref = [jwire.encode(e) for e in _envelopes(jwire, jerr)]
    assert ours == ref
    assert twire.WIRE_VERSION == jwire.WIRE_VERSION
    assert [twire.decode(b) for b in ours] == [jwire.decode(b)
                                               for b in ref]


@pytest.mark.parametrize("name", [
    "RequestError", "RequestCancelled", "DeadlineExceeded",
    "EngineOverloaded", "EngineShutdown", "EngineDraining",
    "PoolDegraded", "StaleFencingToken", "UnknownMember", "AgentFenced",
    "NotPrimary", "KVPullAborted", "SomethingElse"])
def test_wire_errors_rebuild_by_name_as_the_reference(name):
    seen = []
    for wire in (twire, jwire):
        with pytest.raises(Exception) as ei:
            wire.raise_error({"type": name, "msg": "m",
                              "retry_after_s": 1.5})
        seen.append((type(ei.value).__name__, str(ei.value),
                     getattr(ei.value, "retry_after_s", None)))
    assert seen[0] == seen[1]


def test_replica_wedged_decodes_as_wire_error_until_the_watchdog():
    """Both wires decode ``ReplicaWedged`` to their own watchdog's class
    (an ``EngineShutdown``) with the message and retry hint it carried."""
    from ray_tpu.serve import errors as jerrors
    from ray_tpu.serve import watchdog as jwatchdog
    from ray_tpu_torch.serve import errors as terrors
    from ray_tpu_torch.serve import watchdog as twatchdog
    seen = []
    for wire, wd, errors in ((twire, twatchdog, terrors),
                             (jwire, jwatchdog, jerrors)):
        with pytest.raises(wd.ReplicaWedged) as ei:
            wire.raise_error({"type": "ReplicaWedged", "msg": "stuck",
                              "retry_after_s": 0.5})
        assert isinstance(ei.value, errors.EngineShutdown)
        seen.append((type(ei.value).__name__, str(ei.value),
                     ei.value.retry_after_s))
    assert seen[0] == seen[1] == ("ReplicaWedged", "stuck", 0.5)


def test_pull_crosses_the_packages_over_a_socket():
    """A port requester pulls from a JAX ``KVDonor`` behind a JAX
    ``SocketServer`` through the port's ``SocketTransport``, and the
    reverse: the frames, envelopes and typed abort are one wire."""
    out = []
    for srv_pkg, cli_pkg in ((_PKGS["jax"], _PKGS["torch"]),
                             (_PKGS["torch"], _PKGS["jax"])):
        eng = FakeEngine(n_pages=6, page_bytes=64)
        donor = srv_pkg.km.KVDonor(eng, max_chunk_bytes=128)
        server = srv_pkg.tr.SocketServer(
            lambda m, a, _t, d=donor: d.handle(m, a))
        try:
            client = cli_pkg.tr.SocketTransport(server.addr)
            stats = cli_pkg.km.new_stats()
            payload = cli_pkg.km.pull_prefix(
                lambda m, a: client.call(m, a), eng.chain, stats=stats)
            assert payload["pages"] == [eng.data[p] for p in range(6)]
            # the donor's typed refusal crosses as the client's type
            with pytest.raises(cli_pkg.wire.KVPullAborted):
                client.call("kv_pull_chunk", {"xfer_id": "nope",
                                              "chunk_idx": 0})
            assert cli_pkg.km.pull_prefix(
                lambda m, a: client.call(m, a), [5, 6]) is None
        finally:
            server.stop()
        assert donor.open_transfers() == 0 and _no_pins(eng)
        out.append((payload, stats))
    assert out[0] == out[1]


def test_faulty_transport_draws_as_the_reference():
    """Partition, heal and replay besides the seeded draws."""
    out = []
    for pkg in (_PKGS["torch"], _PKGS["jax"]):
        ft = pkg.tr.FaultyTransport(
            pkg.tr.LoopbackTransport(lambda m, a, _t: {"echo": a}),
            seed=5, drop_p=0.3, dup_p=0.3, delay_p=0.2, delay_s=0.0)
        got = []
        for i in range(40):
            try:
                got.append(ft.call("m", {"i": i}))
            except pkg.tr.TransportError as e:
                got.append(str(e))
        ft.partition()
        with pytest.raises(pkg.tr.TransportError):
            ft.call("m", {"i": -1})
        ft.heal()
        got.append(ft.replay_last())
        out.append((got, dict(ft.stats)))
    assert out[0] == out[1]


# -------------------------------------------------------- engine cases

PREFIX = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3,
          2, 3, 8, 4, 6, 2, 6, 4, 3, 3, 8, 3, 2, 7, 9, 5]  # 4 pages of 8
PROMPT = PREFIX + [11, 22, 33, 44]


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, flax params, torch model) of llama_tiny fp32."""
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tl.build_model(
        tl.llama_tiny(dtype=torch.float32), sd, "cpu")


def _maker(tiny, pkg):
    jmodel, params, tmodel = tiny
    knobs = dict(max_slots=2, page_size=8, n_pages=16, chunk=4,
                 prefill_chunk=4, temperature=0.0, eos_id=-1, seed=0,
                 prefix_cache=True, overlap=False)

    def make(**kw):
        args = {**knobs, **kw}
        if pkg == "jax":
            return jeng.LLMEngine(jmodel, params, **args)
        return teng.LLMEngine(tmodel, device="cpu", **args)
    return make


def _drain(eng):
    while eng.step():
        pass


def _run(eng, prompt, n=6, pull=None):
    h = eng.submit(list(prompt), max_new_tokens=n, pull=pull)
    _drain(eng)
    return h.result()


def _export(eng, prompt):
    """The engine's pages of ``prompt``'s full pages, exported (pinned
    and released around the export)."""
    pages = eng.kv_pin_prefix(path_hashes(prompt, eng.Pg))
    try:
        return eng.kv_export_pages(pages)
    finally:
        eng.kv_release_pages(pages)


def _fetcher(pkg, eng, donor):
    km = _PKGS[pkg].km
    return lambda pull: km.pull_prefix(km.loopback_call(donor),
                                       pull["hashes"],
                                       stats=eng.kv_migration_stats)


def _pull_scenario(tiny, pkg, kv_dtype):
    make = _maker(tiny, pkg)
    km = _PKGS[pkg].km
    cold = _run(make(kv_dtype=kv_dtype), PROMPT)
    donor_eng, req_eng = make(kv_dtype=kv_dtype), make(kv_dtype=kv_dtype)
    _run(donor_eng, PREFIX + [7, 7, 7, 7])
    donor = km.KVDonor(donor_eng)
    req_eng.kv_fetcher = _fetcher(pkg, req_eng, donor)
    hint = {"hashes": path_hashes(PREFIX, 8)}
    got = _run(req_eng, PROMPT, pull=hint)
    stats_after_pull = dict(req_eng.kv_migration_stats)
    hits0 = req_eng.prefix_stats()["hit_tokens"]
    # landed pages are ordinary residents: a second request over the
    # prefix hits locally, no second pull
    got2 = _run(req_eng, PROMPT, pull=dict(hint))
    rec = {
        "cold": cold, "pulled": got, "again": got2,
        "stats": stats_after_pull,
        "pulls_after_second": req_eng.kv_migration_stats["pulls"],
        "hit_tokens_second": req_eng.prefix_stats()["hit_tokens"] - hits0,
        "engine_stats": {k: req_eng.stats.get(k, 0) for k in (
            "kv_pull_admissions", "kv_pull_landed", "kv_pull_fallbacks",
            "kv_pulled_pages", "cache_hit_tokens", "prefill_tokens")},
        "events": [(e[2], e[5]) for e in req_eng.events.snapshot()
                   if e[2].startswith("pull_")],
        "open_transfers": donor.open_transfers(),
        "donor_bytes": _export(donor_eng, PREFIX),
        "landed_bytes": _export(req_eng, PREFIX),
        "donor_evictable_eq_cached": (
            donor_eng.prefix_cache.evictable_pages()
            == donor_eng.prefix_cache.cached_pages),
    }
    return rec, donor_eng


@pytest.fixture(scope="module")
def scenarios(tiny):
    """The pull scenario in each package and pool, plus the two
    cross-package pulls over one loopback wire: a JAX donor engine to
    a port requester and a port donor to a JAX requester."""
    out = {}
    for kv_dtype in ("fp", "int8"):
        donors = {}
        for pkg in ("jax", "torch"):
            out[pkg, kv_dtype], donors[pkg] = _pull_scenario(tiny, pkg,
                                                             kv_dtype)
        for donor_pkg, req_pkg in (("jax", "torch"), ("torch", "jax")):
            req = _maker(tiny, req_pkg)(kv_dtype=kv_dtype)
            # the requester's own loopback wire over the other package's
            # donor: its envelopes, its typed errors
            donor = _PKGS[donor_pkg].km.KVDonor(donors[donor_pkg])
            lb = _PKGS[req_pkg].tr.LoopbackTransport(
                lambda m, a, _t, d=donor: d.handle(m, a))
            req.kv_fetcher = lambda pull, lb=lb, req=req: \
                _PKGS[req_pkg].km.pull_prefix(
                    lambda m, a: lb.call(m, a), pull["hashes"],
                    stats=req.kv_migration_stats)
            got = _run(req, PROMPT, pull={"hashes": path_hashes(PREFIX, 8)})
            out[f"{donor_pkg}->{req_pkg}", kv_dtype] = {
                "pulled": got, "stats": dict(req.kv_migration_stats),
                "landed_bytes": _export(req, PREFIX),
                "donor_bytes": _export(donors[donor_pkg], PREFIX),
                "open_transfers": donor.open_transfers()}
            req.shutdown()
        for eng in donors.values():
            eng.shutdown()
    return out


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_engine_pull_lands_token_identical(scenarios, pkg, kv_dtype):
    """The contract, in each package: pulled-prefix decode equals a cold
    recompute, the pull is counted, the landed pages are ordinary cache
    residents, and the donor holds no transfer or pin afterwards."""
    rec = scenarios[pkg, kv_dtype]
    assert rec["pulled"] == rec["cold"] == rec["again"]
    st = rec["stats"]
    assert st["pulls"] == 1 and st["pulled_pages"] == 4
    assert st["aborts"] == 0 and st["fallbacks"] == 0
    assert st["wire_bytes"] > 0
    assert rec["engine_stats"]["kv_pull_landed"] == 1
    assert rec["pulls_after_second"] == 1
    assert rec["hit_tokens_second"] >= len(PREFIX)
    assert rec["open_transfers"] == 0 and rec["donor_evictable_eq_cached"]
    # the landed pages hold the donor's bytes
    assert rec["landed_bytes"] == rec["donor_bytes"]
    assert [k for k, _ in rec["events"]] == ["pull_start", "pull_land"]


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_engine_pull_record_matches_reference(scenarios, kv_dtype):
    ours, ref = scenarios["torch", kv_dtype], scenarios["jax", kv_dtype]
    for key in ("cold", "pulled", "again", "stats", "pulls_after_second",
                "hit_tokens_second", "engine_stats", "events"):
        assert ours[key] == ref[key], key


def _dequantized(blobs, kv_dtype):
    """Each layer's K and V of one exported page as fp32 numpy, and the
    largest int8 step (scale / 127) among its scales (0 for fp)."""
    out, step = [], 0.0
    for layer in blobs:
        if kv_dtype == "fp":
            out += [np.frombuffer(b, np.float32) for b in layer]
            continue
        k, v, sk, sv = layer
        for q, sc in ((k, sk), (v, sv)):
            scale = np.frombuffer(sc, np.float32)            # [KH]
            vals = np.frombuffer(q, np.int8).reshape(len(scale), -1)
            out.append((vals * scale[:, None] / 127.0).ravel())
            step = max(step, float(scale.max()) / 127.0)
    return out, step


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_page_bytes_close_to_reference(scenarios, kv_dtype):
    """The two packages' engines compute the same prefix's pages from
    the same weights in different summation orders, so the bytes agree
    only up to fp32 rounding: fp pages within 1e-5, int8 pages within
    one int8 step (a last-bit difference flips ``round`` now and then)
    — which is why the byte-exact checks hold a page to the DONOR's
    bytes, not to the other package's."""
    ours = scenarios["torch", kv_dtype]["donor_bytes"]
    ref = scenarios["jax", kv_dtype]["donor_bytes"]
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        (xa, step), (xb, _) = (_dequantized(a, kv_dtype),
                               _dequantized(b, kv_dtype))
        for u, w in zip(xa, xb):
            np.testing.assert_allclose(u, w, rtol=0,
                                       atol=1e-5 + 1.01 * step)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("way", ["jax->torch", "torch->jax"])
def test_pull_crosses_the_packages(scenarios, way, kv_dtype):
    """A JAX donor engine to a port requester and back, over one
    loopback wire: token-identical to the JAX engine's cold recompute,
    the donor's bytes landed as they left."""
    rec = scenarios[way, kv_dtype]
    assert rec["pulled"] == scenarios["jax", kv_dtype]["cold"]
    assert rec["landed_bytes"] == rec["donor_bytes"]
    assert rec["stats"]["pulled_pages"] == 4
    assert rec["stats"]["fallbacks"] == 0 and rec["stats"]["aborts"] == 0
    assert rec["open_transfers"] == 0


def _raising_fetcher(pull):
    raise RuntimeError("fetcher transport exploded")


def _fallbacks(tiny, pkg):
    """Every failed pull degrades to plain prefill, token-identical and
    counted: a typed donor abort (nothing resident), a fetcher that
    returns None, one that raises, and a payload of the wrong page
    size. One engine, a distinct prefix per fetcher."""
    make = _maker(tiny, pkg)
    km = _PKGS[pkg].km
    cold = make(prefix_cache=False)
    eng = make(n_pages=32)
    empty = km.KVDonor(FakeEngine(n_pages=0))
    wrong = km.KVDonor(FakeEngine(n_pages=4, page_size=4, kv_dtype="fp"))
    fetchers = [
        lambda pull: km.pull_prefix(km.loopback_call(empty),
                                    pull["hashes"],
                                    stats=eng.kv_migration_stats),
        lambda pull: None,
        _raising_fetcher,
        lambda pull: km.pull_prefix(km.loopback_call(wrong),
                                    FakeEngine(n_pages=4).chain)]
    out = []
    for i, fetcher in enumerate(fetchers):
        prefix = [(t + 17 * i) % 250 + 1 for t in PREFIX]
        prompt = prefix + [11, 22, 33, 44]
        eng.kv_fetcher = fetcher
        got = _run(eng, prompt, pull={"hashes": path_hashes(prefix, 8)})
        assert got == _run(cold, prompt), f"fetcher {i}: diverged"
        assert eng.kv_migration_stats["fallbacks"] == i + 1
        assert eng.stats.get("kv_pull_landed", 0) == 0
        out.append(got)
    # a malformed hint, and one the local cache covers, admit plainly
    for hint in ({"hashes": "junk"}, {"hashes": path_hashes(prefix, 8)}):
        out.append(_run(eng, prompt, pull=hint))
    assert eng.stats["kv_pull_admissions"] == 4
    assert [e[2] for e in eng.events.snapshot()
            if e[2].startswith("pull_")] == \
        ["pull_start", "pull_fallback"] * 4
    out.append((dict(eng.kv_migration_stats),
                {k: eng.stats.get(k, 0) for k in (
                    "kv_pull_admissions", "kv_pull_fallbacks",
                    "cache_hit_tokens")}))
    eng.shutdown()
    cold.shutdown()
    return out


def test_engine_falls_back_as_reference(tiny):
    assert _fallbacks(tiny, "torch") == _fallbacks(tiny, "jax")


def _stopped_donor(tiny, pkg):
    """A dead donor looks dead over every seam: a draining engine pins
    nothing, a stopped one refuses export with the typed abort, and
    release stays permissive on it (the donor's GC needs it)."""
    eng = _maker(tiny, pkg)()
    _run(eng, PREFIX + [7, 7, 7, 7])
    pages = eng.kv_pin_prefix(path_hashes(PREFIX, eng.Pg))
    assert len(pages) == 4
    n_exported = len(eng.kv_export_pages(pages))
    eng.drain()
    assert eng.kv_pin_prefix(path_hashes(PREFIX, eng.Pg)) == []
    eng.shutdown()
    with pytest.raises(_PKGS[pkg].wire.KVPullAborted) as ei:
        eng.kv_export_pages(pages)
    eng.kv_release_pages(pages)
    return len(pages), n_exported, str(ei.value)


def test_stopped_donor_as_reference(tiny):
    assert _stopped_donor(tiny, "torch") == _stopped_donor(tiny, "jax")


def test_pulling_slot_is_skipped_and_cancel_fails_typed(tiny):
    """While a slot pulls it holds no pages, rides no dispatch and is no
    preemption victim; a cancel and a shutdown fail the pulling
    request typed (the late payload is dropped), never hang it."""
    import threading
    eng = _maker(tiny, "torch")(n_pages=32)
    gate, started = threading.Event(), threading.Event()

    def blocked(pull):
        started.set()
        gate.wait(10)
        return None

    eng.kv_fetcher = blocked
    h = eng.submit(PROMPT, max_new_tokens=4,
                   pull={"hashes": path_hashes(PREFIX, 8)})
    other = eng.submit([5, 6, 7], max_new_tokens=4)
    eng.step()
    assert started.wait(10)
    with eng._lock:
        sid = next(i for i, s in enumerate(eng.slots)
                   if s is not None and s.pulling)
        assert eng.slots[sid].pages == []
        assert eng._victim_locked(None) != sid
    while not other.done:
        eng.step()
    assert other.result() == _run(_maker(tiny, "torch")(), [5, 6, 7], 4)
    assert h.cancel()
    with pytest.raises(terr.RequestCancelled):
        h.result()
    gate.set()
    h2 = eng.submit(PROMPT, max_new_tokens=4,
                    pull={"hashes": path_hashes(PREFIX, 8)})
    eng.step()
    eng.shutdown()
    with pytest.raises(terr.EngineShutdown):
        h2.result()
    assert eng.alloc.n_free + eng.prefix_cache.cached_pages \
        == eng.alloc.n_pages - 1


def test_concurrent_pulls_under_a_running_scheduler(tiny):
    """Stress: 6 requests with pull hints over 3 prefixes, on a started
    engine with more pull threads than cores and a short switch
    interval; each fetcher sleeps a little and every third one fails.
    Every stream equals its cold recompute and the pool balances."""
    import random
    import sys
    import time
    make = _maker(tiny, "torch")
    donor_eng = make(n_pages=64)
    prefixes = [[(t + 31 * i) % 250 + 1 for t in PREFIX] for i in range(3)]
    for p in prefixes:
        _run(donor_eng, p + [7, 7, 7, 7])
    donor = tkm.KVDonor(donor_eng)
    eng = make(n_pages=64, max_slots=4)
    rng = random.Random(0)
    calls = []

    def fetcher(pull):
        calls.append(1)
        time.sleep(rng.random() * 0.02)
        if len(calls) % 3 == 0:
            raise RuntimeError("injected")
        return tkm.pull_prefix(tkm.loopback_call(donor), pull["hashes"],
                               stats=eng.kv_migration_stats)

    eng.kv_fetcher = fetcher
    cold = make(n_pages=64, prefix_cache=False)
    prompts = [prefixes[i % 3] + [40 + i, 41 + i] for i in range(6)]
    want = [_run(cold, p) for p in prompts]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        hs = [eng.submit(p, max_new_tokens=6,
                         pull={"hashes": path_hashes(p[:32], 8)})
              for p in prompts]
        got = [h.result() for h in hs]
        assert eng.wait_idle(30)
    finally:
        sys.setswitchinterval(prev)
        eng.shutdown()
        donor_eng.shutdown()
        cold.shutdown()
    assert got == want
    st = eng.stats
    assert st["kv_pull_admissions"] == (st.get("kv_pull_landed", 0)
                                        + st.get("kv_pull_fallbacks", 0))
    assert st["kv_pull_admissions"] >= 3
    assert eng.alloc.occupancy() == eng.prefix_cache.cached_pages
    eng.prefix_cache.check_invariants()
    assert donor.open_transfers() == 0


@pytest.mark.parametrize("kv_dtype,dtype", [
    ("fp", torch.float32), ("fp", torch.bfloat16), ("int8", torch.float32)],
    ids=["fp32", "bf16", "int8"])
def test_batched_export_equals_per_page_export(kv_dtype, dtype):
    """The engine's export (``export_pages_bytes``: one gather and one
    host copy) gives ``export_page_bytes``'s bytes page by page, in the
    order asked, repeats included."""
    from ray_tpu_torch.models import kv_cache as tkv
    cfg = tl.llama_tiny(dtype=dtype)
    pool = tkv.init_kv_pool(cfg, 12, 8, kv_dtype, device="cpu")
    g = torch.Generator().manual_seed(0)
    for layer in pool:
        for t in layer:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
            else:
                t.copy_(torch.rand(t.shape, generator=g) * 4 - 2)
    pages = [5, 1, 11, 5, 7]
    got = tkv.export_pages_bytes(pool, pages)
    assert got == [tkv.export_page_bytes(pool, p) for p in pages]
    assert len(got[0]) == cfg.n_layers
    assert len(got[0][0]) == (2 if kv_dtype == "fp" else 4)


def test_chunk_delay_stretches_each_chunk_not_its_bytes(tiny):
    """``KVDonor(chunk_delay_s=)``, the reference's chaos seam: every
    chunk export waits the delay and carries the bytes an undelayed
    donor exports, one page a chunk."""
    eng = _maker(tiny, "torch")()
    _run(eng, PREFIX + [7, 7, 7, 7])
    hashes = path_hashes(PREFIX, eng.Pg)
    plain = tkm.KVDonor(eng, max_chunk_bytes=eng.page_bytes)
    slow = tkm.KVDonor(eng, max_chunk_bytes=eng.page_bytes,
                       chunk_delay_s=0.05)
    assert (slow.chunk_delay_s, plain.chunk_delay_s) == (0.05, 0.0)
    a, b = plain.begin(hashes), slow.begin(hashes)
    assert a["n_chunks"] == b["n_chunks"] == 4
    for i in range(4):
        t = time.monotonic()
        got = slow.chunk(b["xfer_id"], i)
        assert time.monotonic() - t >= 0.05
        assert got == plain.chunk(a["xfer_id"], i)
    assert plain.end(a["xfer_id"]) == slow.end(b["xfer_id"]) == {
        "released": True}
    assert slow.open_transfers() == 0
    eng.shutdown()
