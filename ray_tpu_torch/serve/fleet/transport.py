"""Own copy of ``ray_tpu/serve/fleet/transport.py``: the fleet
transport seam — loopback, sockets, injected faults.

Three implementations of one call surface,
``call(method, args, timeout_s=..., trace_id=...) -> result``:

- ``LoopbackTransport``: in-process, but HONEST — every request and
  response round-trips through the JSON wire encoding, and typed
  errors cross via ``wire.err``/``wire.raise_error`` exactly as they
  would over a socket.
- ``SocketTransport`` + ``SocketServer``: length-prefixed JSON over
  TCP (4-byte big-endian length, UTF-8 JSON payload), one connection
  per call, thread-per-connection server. Real process separation; the
  frames are the reference's, so either package's client can call
  either package's server.
- ``FaultyTransport``: a seeded wrapper injecting drop / delay /
  duplicate / partition. It draws from ``random.Random(seed)`` in the
  reference's order (drop, duplicate, delay per call), so one seed
  gives one fault sequence in both packages.

Transport failures raise ``TransportError`` (``TransportTimeout``
for deadline cases) — NEVER a typed request error: the caller cannot
know whether the remote side executed the call.
"""
from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.serve.fleet import wire

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024
_max_frame = MAX_FRAME


def max_frame_bytes() -> int:
    """The fleet-wide frame ceiling every bulk payload must plan
    around: KV migration chunks size themselves to fit under it
    (serve/kv_migration.py) — one explicit knob, not an implicit one
    per payload."""
    return _max_frame


def set_max_frame_bytes(n: int) -> int:
    """Set the frame ceiling (tests shrink it to force the typed
    oversize rejection without building 64 MiB payloads). Returns the
    previous value so callers can restore it."""
    global _max_frame
    if int(n) < 1024:
        raise ValueError(f"max frame of {n} bytes is below the 1 KiB "
                         f"floor (control envelopes must always fit)")
    prev = _max_frame
    _max_frame = int(n)
    return prev

# handler(method, args, trace_id) -> JSON-serializable result
Handler = Callable[[str, Dict[str, Any], Optional[str]], Any]


class TransportError(RuntimeError):
    """The call may or may not have executed remotely."""


class TransportTimeout(TransportError):
    """No response within the per-call deadline."""


def send_frame(sock: socket.socket, payload: bytes) -> None:
    if len(payload) > _max_frame:
        raise TransportError(
            f"frame of {len(payload)} bytes exceeds the "
            f"{_max_frame}-byte max-frame knob")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes:
    head = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(head)
    if n > _max_frame:
        raise TransportError(
            f"peer announced {n}-byte frame over the "
            f"{_max_frame}-byte max-frame knob")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _dispatch(handler: Handler, req: Dict[str, Any]
              ) -> Dict[str, Any]:
    """Run one decoded request envelope through a handler, catching
    typed errors into the wire error shape. Shared by the loopback
    transport and the socket server so both sides of the seam agree
    on what crosses it."""
    try:
        result = handler(req["method"], req.get("args") or {},
                         req.get("trace_id"))
        return wire.ok(result)
    except Exception as e:
        return wire.err(e)


class Transport:
    """Call surface every fleet component speaks."""

    def call(self, method: str, args: Dict[str, Any], *,
             timeout_s: Optional[float] = None,
             trace_id: Optional[str] = None) -> Any:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LoopbackTransport(Transport):
    """In-process transport that still pays the wire toll: requests
    and responses are JSON-encoded and decoded, so anything that
    would not survive a socket does not survive loopback either."""

    def __init__(self, handler: Handler):
        self._handler = handler

    def call(self, method: str, args: Dict[str, Any], *,
             timeout_s: Optional[float] = None,
             trace_id: Optional[str] = None) -> Any:
        req = wire.decode(wire.encode(
            wire.request(method, args, trace_id)))
        resp = wire.decode(wire.encode(
            _dispatch(self._handler, req)))
        if not resp["ok"]:
            wire.raise_error(resp["error"])
        return resp["result"]


class SocketServer:
    """Thread-per-connection RPC server for one handler. ``addr`` is
    the bound ``(host, port)`` — pass port 0 to let the OS pick."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 port: int = 0,
                 gate: Optional[Callable[[], bool]] = None):
        self._handler = handler
        # gate() -> False drops the connection WITHOUT responding: the
        # server-side half of a network partition (the client sees a
        # TransportError, never a typed refusal)
        self._gate = gate
        self._sock = socket.socket(socket.AF_INET,
                                   socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET,
                              socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.addr: Tuple[str, int] = self._sock.getsockname()
        self._stopped = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"fleet-rpc-{self.addr[1]}", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while not self._stopped:
                    try:
                        payload = recv_frame(conn)
                    except TransportError:
                        return      # peer hung up
                    if self._gate is not None and not self._gate():
                        return      # partitioned: drop, no response
                    resp = _dispatch(self._handler,
                                     wire.decode(payload))
                    send_frame(conn, wire.encode(resp))
        except OSError:
            pass

    def stop(self) -> None:
        self._stopped = True
        try:
            self._sock.close()
        except OSError:
            pass


class SocketTransport(Transport):
    """Connection-per-call client for a ``SocketServer``. Stateless
    between calls, which keeps failure handling honest: any socket
    error is a ``TransportError`` and the next call starts clean."""

    def __init__(self, addr: Tuple[str, int], *,
                 connect_timeout_s: float = 2.0,
                 default_timeout_s: float = 10.0):
        self._addr = (addr[0], int(addr[1]))
        self._connect_timeout_s = connect_timeout_s
        self._default_timeout_s = default_timeout_s

    def call(self, method: str, args: Dict[str, Any], *,
             timeout_s: Optional[float] = None,
             trace_id: Optional[str] = None) -> Any:
        deadline = (timeout_s if timeout_s is not None
                    else self._default_timeout_s)
        try:
            sock = socket.create_connection(
                self._addr, timeout=min(self._connect_timeout_s,
                                        deadline))
        except socket.timeout as e:
            raise TransportTimeout(
                f"connect to {self._addr} timed out") from e
        except OSError as e:
            raise TransportError(
                f"connect to {self._addr} failed: {e}") from e
        try:
            with sock:
                sock.settimeout(deadline)
                send_frame(sock, wire.encode(
                    wire.request(method, args, trace_id)))
                resp = wire.decode(recv_frame(sock))
        except socket.timeout as e:
            raise TransportTimeout(
                f"{method} to {self._addr} timed out after "
                f"{deadline:.3f}s") from e
        except OSError as e:
            raise TransportError(
                f"{method} to {self._addr} failed: {e}") from e
        if not resp["ok"]:
            wire.raise_error(resp["error"])
        return resp["result"]


class FaultyTransport(Transport):
    """Seeded fault-injecting wrapper around any transport (the
    reference's cross-process face of its in-engine fault plans).

    - ``drop_p``: the call raises ``TransportError`` WITHOUT reaching
      the peer (request lost on the wire).
    - ``dup_p``: the call executes TWICE back-to-back and the second
      result is returned (duplicate delivery; receiver-side request
      keys and poll cursors must make this harmless).
    - ``delay_p`` / ``delay_s``: the call sleeps before executing.
    - ``partition()``: while partitioned, every call raises
      ``TransportError`` — the peer is unreachable both ways.
    - ``replay_last()``: re-deliver the most recent successful call
      verbatim, arbitrarily later — the DELAYED duplicate ``dup_p``
      can't model (back-to-back dups land inside one lease window;
      a held-then-replayed frame can straddle a renewal or even a
      re-registration boundary, which is exactly what fencing tokens
      exist to refuse).
    """

    def __init__(self, inner: Transport, *, seed: int = 0,
                 drop_p: float = 0.0, dup_p: float = 0.0,
                 delay_p: float = 0.0, delay_s: float = 0.01):
        self._inner = inner
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.delay_p = delay_p
        self.delay_s = delay_s
        self._partitioned_until: Optional[float] = None
        self._last: Optional[Tuple[str, Dict[str, Any]]] = None
        self.stats = {"calls": 0, "dropped": 0, "duplicated": 0,
                      "delayed": 0, "partitioned": 0, "replayed": 0}

    def partition(self, duration_s: Optional[float] = None) -> None:
        """Cut the link (for ``duration_s`` seconds, or until
        ``heal()``)."""
        with self._lock:
            self._partitioned_until = (
                float("inf") if duration_s is None
                else time.monotonic() + duration_s)

    def heal(self) -> None:
        with self._lock:
            self._partitioned_until = None

    def partitioned(self) -> bool:
        with self._lock:
            until = self._partitioned_until
        return until is not None and time.monotonic() < until

    def call(self, method: str, args: Dict[str, Any], *,
             timeout_s: Optional[float] = None,
             trace_id: Optional[str] = None) -> Any:
        with self._lock:
            self.stats["calls"] += 1
            drop = self._rng.random() < self.drop_p
            dup = self._rng.random() < self.dup_p
            delay = self._rng.random() < self.delay_p
        if self.partitioned():
            with self._lock:
                self.stats["partitioned"] += 1
            raise TransportError(
                f"partitioned: {method} undeliverable")
        if drop:
            with self._lock:
                self.stats["dropped"] += 1
            raise TransportError(f"injected drop of {method}")
        if delay:
            with self._lock:
                self.stats["delayed"] += 1
            time.sleep(self.delay_s)
        if dup:
            with self._lock:
                self.stats["duplicated"] += 1
            self._inner.call(method, args, timeout_s=timeout_s,
                             trace_id=trace_id)
        out = self._inner.call(method, args, timeout_s=timeout_s,
                               trace_id=trace_id)
        with self._lock:
            self._last = (method, dict(args))
        return out

    def replay_last(self, *, timeout_s: Optional[float] = None):
        """Re-deliver the last successful frame NOW (a duplicate the
        network held onto). Returns the peer's fresh answer — which,
        across a renewal/re-registration boundary, should be a typed
        fencing refusal, not a lease extension."""
        with self._lock:
            held = self._last
            self.stats["replayed"] += 1
        if held is None:
            raise TransportError("nothing to replay")
        method, args = held
        return self._inner.call(method, dict(args),
                                timeout_s=timeout_s)

    def close(self) -> None:
        self._inner.close()
