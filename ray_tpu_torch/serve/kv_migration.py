"""Own copy of ``ray_tpu/serve/kv_migration.py``: fleet-wide KV page
migration — pull hot prefixes, don't recompute.

The radix prefix cache (serve/prefix_cache.py) is per-replica: a hot
system prompt is re-prefilled once per replica. Already-computed KV
pages are immutable objects, so a replica that lacks a prefix can pull
its pages from a peer that holds it (the int8 pool format halves their
wire cost for free). This module is the transfer protocol; the engine
(serve/engine.py) is its donor and its requester.

- **Donor side** (``KVDonor``): resolves a requester's prefix hashes
  to physical pages via ``PrefixCache.match_hashes`` — which PINS
  them (refcount increment) for the transfer lifetime, so eviction
  can never yank a page mid-pull — then serves bounded chunks of raw
  page bytes (int8 payload + per-page scales travel together,
  models/kv_cache.py ``export_page_bytes``). Transfers expire on a
  pin deadline: a requester that dies mid-pull cannot pin donor
  pages forever.
- **Requester side** (``pull_prefix``): chunked pull with per-pull
  deadline, bounded per-chunk retries with backoff, and dedupe keyed
  ``(digest, chunk_idx)`` so a duplicated or retried chunk can never
  double-land. A typed ``KVPullAborted`` (donor says the prefix is
  gone) aborts immediately; transport errors retry bounded, then
  abort. An aborted pull returns ``None`` — the engine falls back to
  plain prefill, it never wedges.

Chunks are sized to fit under the fleet transport's explicit
max-frame knob (``transport.max_frame_bytes``) with headroom for
base64 + envelope overhead.

Wire format (JSON-safe; no token ids ever cross — only rolling path
hashes), the reference's, so a port engine and a JAX-package engine
can pull from each other over one wire:

    begin  -> {xfer_id, digest, n_pages, n_chunks, pages_per_chunk,
               page_size, kv_dtype, n_layers}
    chunk  -> {chunk_idx, pages: [[b64, ...] per layer] per page}
    end    -> {released: bool}

The metric names (``serve_kv_migration_*``) are the reference's, in
the port's own registry (util/metrics.py).
"""
from __future__ import annotations

import base64
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_tpu_torch.serve.fleet import transport as fleet_transport
from ray_tpu_torch.serve.fleet.transport import TransportError
from ray_tpu_torch.serve.fleet.wire import KVPullAborted
from ray_tpu_torch.serve.prefix_cache import path_hashes
from ray_tpu_torch.util import metrics

PULLS = "serve_kv_migration_pulls_total"
PULLED_PAGES = "serve_kv_migration_pulled_pages_total"
WIRE_BYTES = "serve_kv_migration_wire_bytes_total"
ABORTS = "serve_kv_migration_aborts_total"
FALLBACKS = "serve_kv_migration_fallbacks_total"

_METRICS: Optional[dict] = None


def _metrics() -> dict:
    """Lazy module-level metric singletons, re-created if a test's
    ``clear_registry()`` dropped them (same pattern as the engine's
    weight-swap metrics)."""
    global _METRICS
    if (_METRICS is None
            or metrics.registry().get(PULLS) is not _METRICS["pulls"]):
        _METRICS = {
            "pulls": metrics.Counter(
                PULLS, "Cross-replica KV prefix pulls attempted"),
            "pulled_pages": metrics.Counter(
                PULLED_PAGES, "KV pages landed from a peer replica "
                "instead of recomputed"),
            "wire_bytes": metrics.Counter(
                WIRE_BYTES, "Encoded KV payload bytes received over "
                "the fleet transport"),
            "aborts": metrics.Counter(
                ABORTS, "KV pulls aborted (typed donor refusal, "
                "donor death, or pull deadline)"),
            "fallbacks": metrics.Counter(
                FALLBACKS, "Requests that fell back to plain prefill "
                "after an incomplete pull"),
        }
    return _METRICS


def new_stats() -> Dict[str, int]:
    """Plain-int per-entity mirror of the process counters (each
    engine keeps one, ``LLMEngine.kv_migration_stats``, so callers read
    local numbers, same convention as ``PrefixCache``'s counts)."""
    return {"pulls": 0, "pulled_pages": 0, "wire_bytes": 0,
            "aborts": 0, "fallbacks": 0}


# --------------------------------------------------------------- donor


class KVDonor:
    """Transfer table + export surface over ONE engine: the fleet
    agent's ``kv_pull_*`` RPC handlers drive it (serve/fleet/agent.py),
    and so does any ``call`` seam, e.g. ``loopback_call``.
    ``chunk_delay_s`` stretches every chunk export (a chaos seam: a
    harness can kill a donor process mid-pull).

    The engine contract (serve/engine.py): ``kv_pin_prefix(hashes)``
    pins and returns the longest resident page run,
    ``kv_export_pages(pages)`` reads raw page bytes, and
    ``kv_release_pages(pages)`` unpins — all under the engine lock.
    """

    def __init__(self, engine, *, pin_ttl_s: float = 30.0,
                 max_chunk_bytes: Optional[int] = None,
                 chunk_delay_s: float = 0.0,
                 time_fn: Callable[[], float] = time.monotonic):
        self._engine = engine
        self._pin_ttl_s = float(pin_ttl_s)
        self._max_chunk_bytes = max_chunk_bytes
        # chaos seam: stretch each chunk export so a harness can kill
        # the donor process deterministically MID-pull
        self.chunk_delay_s = float(chunk_delay_s)
        self._time = time_fn
        self._lock = threading.Lock()
        self._seq = 0
        self._xfers: Dict[str, Dict[str, Any]] = {}

    def _chunk_budget_bytes(self) -> int:
        """Raw payload bytes one chunk may carry: half the frame knob,
        leaving headroom for base64 (4/3x) plus JSON envelope."""
        budget = fleet_transport.max_frame_bytes() // 2
        if self._max_chunk_bytes is not None:
            budget = min(budget, int(self._max_chunk_bytes))
        return max(1, budget)

    def _gc_locked(self) -> None:
        now = self._time()
        for xid in [x for x, t in self._xfers.items()
                    if t["deadline"] <= now]:
            self._release(self._xfers.pop(xid))

    def _release(self, xfer: Dict[str, Any]) -> None:
        if not xfer.get("released"):
            xfer["released"] = True
            self._engine.kv_release_pages(xfer["pages"])

    def begin(self, hashes: Sequence[int]) -> Dict[str, Any]:
        """Pin the longest resident run of ``hashes`` and plan the
        chunked transfer. Raises typed ``KVPullAborted`` when nothing
        is resident (the requester's directory view was stale)."""
        hashes = [int(h) for h in hashes]
        pages = self._engine.kv_pin_prefix(hashes)
        if not pages:
            raise KVPullAborted(
                "prefix not resident on donor (evicted since "
                "advertised)")
        page_bytes = max(1, int(getattr(self._engine, "page_bytes",
                                        None) or 1))
        per_chunk = max(1, self._chunk_budget_bytes() // page_bytes)
        n_chunks = -(-len(pages) // per_chunk)
        with self._lock:
            self._gc_locked()
            self._seq += 1
            xid = f"x{self._seq}"
            self._xfers[xid] = {
                "pages": pages, "digest": hashes[len(pages) - 1],
                "per_chunk": per_chunk, "n_chunks": n_chunks,
                "deadline": self._time() + self._pin_ttl_s,
                "released": False,
            }
        return {"xfer_id": xid, "digest": hashes[len(pages) - 1],
                "n_pages": len(pages), "n_chunks": n_chunks,
                "pages_per_chunk": per_chunk,
                "page_size": self._engine.Pg,
                "kv_dtype": getattr(self._engine, "kv_dtype", "fp"),
                "n_layers": self._engine.cfg.n_layers}

    def chunk(self, xfer_id: str, chunk_idx: int) -> Dict[str, Any]:
        """Export one chunk's pages as base64 blobs. Idempotent (pure
        read of pinned pages), so duplicated or retried chunk RPCs are
        harmless. Unknown/expired transfers raise typed
        ``KVPullAborted`` — the pin is gone, the pages may not be."""
        with self._lock:
            self._gc_locked()
            xfer = self._xfers.get(xfer_id)
            if xfer is None:
                raise KVPullAborted(
                    f"unknown or expired transfer {xfer_id!r}")
            if not 0 <= int(chunk_idx) < xfer["n_chunks"]:
                raise KVPullAborted(
                    f"chunk {chunk_idx} out of range for {xfer_id!r}")
            lo = int(chunk_idx) * xfer["per_chunk"]
            pages = xfer["pages"][lo:lo + xfer["per_chunk"]]
        if self.chunk_delay_s > 0:
            time.sleep(self.chunk_delay_s)
        blobs = self._engine.kv_export_pages(pages)
        return {"chunk_idx": int(chunk_idx),
                "pages": [[[base64.b64encode(b).decode("ascii")
                            for b in layer_cols]
                           for layer_cols in page_blobs]
                          for page_blobs in blobs]}

    def end(self, xfer_id: str) -> Dict[str, Any]:
        """Unpin a finished transfer (best-effort from the requester;
        the pin deadline GC is the backstop when this call is lost)."""
        with self._lock:
            xfer = self._xfers.pop(xfer_id, None)
            if xfer is None:
                return {"released": False}
            self._release(xfer)
        return {"released": True}

    def open_transfers(self) -> int:
        with self._lock:
            self._gc_locked()
            return len(self._xfers)

    def handle(self, method: str, args: Dict[str, Any]) -> Any:
        """RPC-shaped dispatch: a loopback wire or a socket server
        routes calls through this."""
        if method == "kv_pull_begin":
            return self.begin(args["hashes"])
        if method == "kv_pull_chunk":
            return self.chunk(args["xfer_id"], args["chunk_idx"])
        if method == "kv_pull_end":
            return self.end(args["xfer_id"])
        raise KVPullAborted(f"unknown kv method {method!r}")


# ----------------------------------------------------------- requester


def pull_prefix(call: Callable[[str, Dict[str, Any]], Any],
                hashes: Sequence[int], *,
                deadline_s: float = 5.0,
                max_attempts: int = 3,
                backoff_s: float = 0.02,
                stats: Optional[Dict[str, int]] = None,
                time_fn: Callable[[], float] = time.monotonic
                ) -> Optional[Dict[str, Any]]:
    """Pull the longest donor-resident run of ``hashes`` over any
    ``call(method, args)`` seam. Returns ``{"n_pages", "page_size",
    "kv_dtype", "n_layers", "digest", "pages": [per-page [bytes per
    layer-col]], "wire_bytes"}`` — or ``None`` when the pull aborted
    (typed donor refusal, transport retries exhausted, or deadline):
    the caller falls back to plain prefill.

    Received chunks are deduped by ``(digest, chunk_idx)``: a
    duplicated delivery or a retry after a dropped response can never
    land a chunk twice or double-count its wire bytes.
    """
    m = _metrics()
    m["pulls"].inc()
    if stats is not None:
        stats["pulls"] += 1
    t0 = time_fn()

    def _abort() -> None:
        m["aborts"].inc()
        if stats is not None:
            stats["aborts"] += 1

    try:
        begin = call("kv_pull_begin", {"hashes": [int(h) for h
                                                  in hashes]})
    except (KVPullAborted, TransportError):
        _abort()
        return None
    digest = int(begin["digest"])
    n_chunks = int(begin["n_chunks"])
    got: Dict[Any, List[List[bytes]]] = {}
    wire_bytes = 0
    for idx in range(n_chunks):
        key = (digest, idx)
        if key in got:
            continue                      # dedupe: already landed
        attempts = 0
        while key not in got:
            if time_fn() - t0 > deadline_s:
                _abort()
                return None
            try:
                rsp = call("kv_pull_chunk",
                           {"xfer_id": begin["xfer_id"],
                            "chunk_idx": idx})
            except KVPullAborted:
                _abort()                  # typed: donor said no
                return None
            except TransportError:
                attempts += 1
                if attempts >= max_attempts:
                    _abort()              # donor unreachable
                    return None
                time.sleep(backoff_s * (2 ** (attempts - 1)))
                continue
            rkey = (digest, int(rsp["chunk_idx"]))
            if rkey in got:
                continue                  # duplicate delivery
            wire_bytes += sum(len(col) for page in rsp["pages"]
                              for layer in page for col in layer)
            got[rkey] = [
                [[base64.b64decode(col) for col in layer]
                 for layer in page]
                for page in rsp["pages"]]
    try:
        call("kv_pull_end", {"xfer_id": begin["xfer_id"]})
    except (KVPullAborted, TransportError):
        pass                              # pin GC is the backstop
    pages: List[List[bytes]] = []
    for idx in range(n_chunks):
        pages.extend(got[(digest, idx)])
    m["pulled_pages"].inc(len(pages))
    m["wire_bytes"].inc(wire_bytes)
    if stats is not None:
        stats["pulled_pages"] += len(pages)
        stats["wire_bytes"] += wire_bytes
    return {"n_pages": len(pages), "digest": digest,
            "page_size": int(begin["page_size"]),
            "kv_dtype": begin["kv_dtype"],
            "n_layers": int(begin["n_layers"]),
            "pages": pages, "wire_bytes": wire_bytes}


def validate_pull_knobs(deadline_s: Optional[float] = None,
                        backoff_s: Optional[float] = None
                        ) -> Dict[str, float]:
    """Typed validation for the requester-side pull knobs a
    deployment plumbs through (``LlamaDeployment(kv_pull_deadline_s=,
    kv_pull_backoff_s=)``). ``None`` means "use the ``pull_prefix``
    default"; anything else must be a positive finite number — a junk
    value fails HERE, at construction, not minutes later inside the
    first cache-miss pull. Returns only the overridden knobs, ready
    to splat into ``pull_prefix``."""
    knobs: Dict[str, float] = {}
    for name, val in (("deadline_s", deadline_s),
                      ("backoff_s", backoff_s)):
        if val is None:
            continue
        try:
            f = float(val)
        except (TypeError, ValueError):
            raise ValueError(
                f"kv pull {name} must be a positive number, "
                f"got {val!r}") from None
        if not (f > 0.0) or f != f or f == float("inf"):
            raise ValueError(
                f"kv pull {name} must be a positive finite number, "
                f"got {val!r}")
        knobs[name] = f
    return knobs


def prefill_push_hint(prompt: Sequence[int], page_size: int,
                      **donor: Any) -> Optional[Dict[str, Any]]:
    """Finished-prefill push hint: the donor-side twin of the cold
    routing pull. When a prefill-role replica completes a prompt, the
    pool hands the stream to a decode replica carrying THIS hint —
    the full-page hash chain of exactly the prompt the donor just
    retired into its prefix cache, plus the donor's address
    (``replica_idx=`` in-process, ``addr=``/``replica_id=`` over the
    fleet wire). The decode replica's admission pull then resumes at
    full prompt length instead of recomputing it: a degenerate
    "all pages pulled" prefill. Returns ``None`` when the prompt has
    no full page — nothing worth shipping."""
    if page_size <= 0 or len(prompt) < page_size:
        return None
    n_full = len(prompt) // page_size
    chain = path_hashes(list(prompt), page_size)[:n_full]
    if not chain:
        return None
    hint: Dict[str, Any] = {"hashes": chain}
    hint.update(donor)
    return hint


def count_fallback(stats: Optional[Dict[str, int]] = None) -> None:
    """One request fell back to plain prefill after its pull failed
    or its pulled pages could not land (allocator dry)."""
    _metrics()["fallbacks"].inc()
    if stats is not None:
        stats["fallbacks"] += 1


def loopback_call(donor: KVDonor
                  ) -> Callable[[str, Dict[str, Any]], Any]:
    """In-process call seam over a donor that still pays the wire
    toll: every request/response JSON round-trips and typed errors
    cross via the wire error shape, exactly as over a socket, so the
    wire bytes it counts are honest."""
    lb = fleet_transport.LoopbackTransport(
        lambda method, args, trace_id: donor.handle(method, args))
    return lambda method, args: lb.call(method, args)
