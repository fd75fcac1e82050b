"""The port's fleet control plane (counterpart: ``ray_tpu/serve/fleet``):
the engine pool split into processes behind a pluggable transport.

- ``directory``: ``FleetDirectory``, membership keyed by replica id +
  generation, lease-based liveness, monotonic fencing tokens.
- ``agent``: ``ReplicaAgent``, one ``LLMEngine`` per process, renews its
  lease and self-fences when it lapses.
- ``router``: ``FleetRouter``, routes by the advertised digests and load
  and treats transport errors as death candidates (suspect, then
  directory-confirmed dead, then a token-identical resubmit).
- ``transport``: loopback, length-prefixed JSON over sockets, and a
  seeded fault-injecting wrapper; ``wire``: the JSON envelopes and typed
  errors; ``routing``: the selection and resubmit core shared with the
  engine pool (serve/engine_pool.py).

The reference's WAL, replication, capacity provider and telemetry wait
for the fleet's later slices (ROADMAP.md, queue 1, item 9).

Attribute access is lazy (PEP 562): the engine pool imports
``fleet.routing``, and ``fleet.agent`` imports the watchdog, which
imports the engine pool; eager re-exports would close that cycle.
"""
import importlib

_EXPORTS = {
    "FleetDirectory": "directory", "DirectoryClient": "directory",
    "ReplicaAgent": "agent", "AgentClient": "agent",
    "ScriptedEngine": "agent",
    "FleetRouter": "router",
    "LoopbackTransport": "transport", "SocketTransport": "transport",
    "SocketServer": "transport", "FaultyTransport": "transport",
    "TransportError": "transport", "TransportTimeout": "transport",
    "AgentFenced": "wire", "StaleFencingToken": "wire",
    "UnknownMember": "wire", "NotPrimary": "wire",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
