"""Port of ``ray_tpu/serve/fleet/provider.py``: the fleet's capacity
providers, what the serve pool's autoscaler (serve/pool_autoscaler.py)
requests replicas from when it drives a ``FleetRouter``.

``FleetCapacityProvider``: a ticket is a REPLICA ID, and granting it
spawns a ``ReplicaAgent`` process that registers itself with the
(replicated) directory and warms its engine. ``ready()`` flips only
after the agent printed ``READY``, that is after register and warm-up,
so the autoscaler's harvest adds a member that can serve at once.
``release()`` retires the process; the drain (engine drained, requests
finished, lease deregistered, tombstone written) already happened
through ``FleetRouter.scale_down`` by the time the autoscaler releases
the ticket, so reaping here is process hygiene, idempotent where it is
not.

``LoopbackAgentProvider`` is the in-process twin behind
``LlamaDeployment(fleet=, autoscale=True)``: provisioning builds and
starts a loopback ``ReplicaAgent`` instead of a process, after an
optional modelled delay so the ETA plumbing is exercised.

One deliberate difference from the reference: a spawned agent's stderr
goes to a file in a temporary directory the provider owns
(``stderr_path``), not to ``/dev/null``, so a spawn that dies before
``READY`` can be diagnosed. Its stdout stays a pipe, drained after
``READY``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.node_provider import (CapacityUnavailable,
                                                    ReplicaCapacityProvider)

__all__ = ["FleetCapacityProvider", "LoopbackAgentProvider"]

# the directory holding the ray_tpu_torch package: a child's working
# directory, so that ``python -m ray_tpu_torch...`` resolves there
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _addr_pair(ep: Any) -> Tuple[str, int]:
    if isinstance(ep, str):
        host, _, port = ep.rpartition(":")
        return host or "127.0.0.1", int(port)
    return str(ep[0]), int(ep[1])


class FleetCapacityProvider(ReplicaCapacityProvider):
    """Capacity is a warm agent process registered in the directory.

    ``request()`` starts ``python -m ray_tpu_torch.serve.fleet.agent``
    (never a fork: the caller may hold a CUDA context) aimed at the
    ordered directory endpoint list, with ``extra_args`` after the
    provider's own, and returns the replica id as the ticket; a waiter
    thread marks the ticket ready when the agent prints ``READY
    <port>``. ``eta_s`` is an EWMA of the observed spawn-to-ready
    seconds minus the time elapsed, floored at 0.25 s while pending, so
    a Retry-After never promises capacity that does not exist yet.
    """

    def __init__(self, directory_addrs: List[Any], *,
                 model: str = "fake",
                 token_delay_s: float = 0.002,
                 rid_prefix: str = "auto",
                 max_agents: Optional[int] = None,
                 spawn_timeout_s: float = 120.0,
                 initial_eta_s: float = 2.0,
                 extra_args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None):
        self._dirs = [_addr_pair(e) for e in directory_addrs]
        if not self._dirs:
            raise ValueError("need at least one directory endpoint")
        self._model = model
        self._token_delay_s = token_delay_s
        self._prefix = rid_prefix
        self._max = max_agents
        self._spawn_timeout_s = spawn_timeout_s
        self._eta_ewma = float(initial_eta_s)
        self._extra_args = [str(a) for a in (extra_args or [])]
        self._env = env
        self._log_dir: Optional[str] = None
        self._lock = threading.Lock()
        self._n = 0
        # ticket -> {"proc", "t_spawn", "ready", "port", "failed", "err"}
        self._agents: Dict[str, Dict[str, Any]] = {}
        self.stats = {"spawned": 0, "ready": 0, "released": 0,
                      "denied": 0, "spawn_failures": 0}

    # ---------------------------------------------------- provider ABC

    def request(self) -> str:
        with self._lock:
            if self._max is not None and len(self._agents) >= self._max:
                self.stats["denied"] += 1
                raise CapacityUnavailable(
                    f"agent ceiling {self._max} reached")
            self._n += 1
            rid = f"{self._prefix}-{self._n}"
            self._agents[rid] = self._spawn(rid)
            self.stats["spawned"] += 1
        return rid

    def ready(self, ticket: str) -> bool:
        with self._lock:
            rec = self._agents.get(ticket)
        if rec is None:
            return False
        if rec["failed"]:
            # a dead spawn surfaces instead of pending for ever; the
            # autoscaler's release() reaps what is left
            raise CapacityUnavailable(f"agent {ticket} died before READY "
                                      f"(stderr: {rec['err']})")
        return bool(rec["ready"])

    def eta_s(self, ticket: str) -> float:
        with self._lock:
            rec = self._agents.get(ticket)
            ewma = self._eta_ewma
        if rec is None or rec["ready"]:
            return 0.0
        # never promise less than 250 ms while the process still warms
        return max(ewma - (time.monotonic() - rec["t_spawn"]), 0.25)

    def release(self, ticket: str) -> None:
        with self._lock:
            rec = self._agents.pop(ticket, None)
        if rec is None:
            return
        self.stats["released"] += 1
        self._reap(rec)

    # --------------------------------------------------------- helpers

    def agent_port(self, ticket: str) -> Optional[int]:
        with self._lock:
            rec = self._agents.get(ticket)
        return rec["port"] if rec else None

    def stderr_path(self, ticket: str) -> Optional[str]:
        """The file the ticket's agent writes its stderr to."""
        with self._lock:
            rec = self._agents.get(ticket)
        return rec["err"] if rec else None

    def live_count(self) -> int:
        with self._lock:
            return len(self._agents)

    def stop_all(self) -> None:
        """Reap every agent and remove the provider's stderr files."""
        with self._lock:
            recs = list(self._agents.values())
            self._agents.clear()
            log_dir, self._log_dir = self._log_dir, None
        for rec in recs:
            self._reap(rec)
        if log_dir is not None:
            shutil.rmtree(log_dir, ignore_errors=True)

    def _spawn(self, rid: str) -> Dict[str, Any]:
        """Start ``rid``'s agent. Caller holds the lock."""
        cmd = [sys.executable, "-m", "ray_tpu_torch.serve.fleet.agent",
               "--replica-id", rid, "--model", self._model,
               "--token-delay-s", str(self._token_delay_s)]
        for host, port in self._dirs:
            cmd += ["--directory", f"{host}:{port}"]
        cmd += self._extra_args
        env = dict(self._env if self._env is not None else os.environ)
        if self._log_dir is None:
            self._log_dir = tempfile.mkdtemp(prefix="fleet_provider_")
        err = os.path.join(self._log_dir, f"{rid}.stderr")
        with open(err, "wb") as err_fh:
            proc = subprocess.Popen(cmd, cwd=_PKG_ROOT, env=env, text=True,
                                    stdin=subprocess.DEVNULL,
                                    stdout=subprocess.PIPE, stderr=err_fh)
        rec = {"proc": proc, "t_spawn": time.monotonic(), "ready": False,
               "port": None, "failed": False, "err": err}
        threading.Thread(target=self._wait_ready, args=(rec,),
                         name=f"provider-wait-{rid}", daemon=True).start()
        return rec

    def _wait_ready(self, rec: Dict[str, Any]) -> None:
        deadline = rec["t_spawn"] + self._spawn_timeout_s
        out = rec["proc"].stdout
        while time.monotonic() < deadline:
            line = out.readline()
            if not line:            # EOF: the process died before READY
                break
            if line.startswith("READY"):
                took = time.monotonic() - rec["t_spawn"]
                with self._lock:
                    rec["port"] = int(line.split()[1])
                    rec["ready"] = True
                    self._eta_ewma = 0.5 * self._eta_ewma + 0.5 * took
                    self.stats["ready"] += 1
                # keep draining: the agent must never block on a full
                # stdout pipe
                for _ in out:
                    pass
                return
        with self._lock:
            rec["failed"] = True
            self.stats["spawn_failures"] += 1

    @staticmethod
    def _reap(rec: Dict[str, Any]) -> None:
        proc = rec["proc"]
        if proc.poll() is None:
            # polite first: rpc_shutdown makes a still-serving agent
            # deregister cleanly (after a scale_down drain it is already
            # deregistered, and the call is a plain shutdown)
            if rec.get("port"):
                try:
                    from ray_tpu_torch.serve.fleet.agent import AgentClient
                    from ray_tpu_torch.serve.fleet.transport import (
                        SocketTransport)
                    AgentClient(SocketTransport(("127.0.0.1", rec["port"])),
                                timeout_s=2.0).shutdown()
                except Exception:   # noqa: BLE001 - terminate follows
                    pass
            try:
                proc.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=3.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=3.0)
        try:
            if proc.stdout is not None:
                proc.stdout.close()
        except Exception:   # noqa: BLE001
            pass


class LoopbackAgentProvider(ReplicaCapacityProvider):
    """In-process provisioning for loopback fleets: "spawning a host" is
    building and starting a ``ReplicaAgent`` around a fresh engine.
    ``agent_factory(replica_id)`` must build, start AND make the agent
    routable (``LlamaDeployment`` puts it in the transport map the
    router resolves addresses against). ``provision_delay_s`` models the
    spin-up so the ETA and Retry-After plumbing is exercised."""

    def __init__(self, agent_factory: Callable[[str], Any], *,
                 provision_delay_s: float = 0.0,
                 rid_prefix: str = "auto",
                 max_agents: Optional[int] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self._factory = agent_factory
        self._delay = float(provision_delay_s)
        self._prefix = rid_prefix
        self._max = max_agents
        self._now = time_fn
        self._lock = threading.Lock()
        self._n = 0
        # ticket -> {"t_request", "agent": None, "building" or the agent}
        self._tickets: Dict[str, Dict[str, Any]] = {}
        self.agents: Dict[str, Any] = {}
        self.stats = {"granted": 0, "built": 0, "released": 0, "denied": 0}

    def request(self) -> str:
        with self._lock:
            if self._max is not None and len(self._tickets) >= self._max:
                self.stats["denied"] += 1
                raise CapacityUnavailable(
                    f"agent ceiling {self._max} reached")
            self._n += 1
            rid = f"{self._prefix}-{self._n}"
            self._tickets[rid] = {"t_request": self._now(), "agent": None}
            self.stats["granted"] += 1
        return rid

    def ready(self, ticket: str) -> bool:
        with self._lock:
            rec = self._tickets.get(ticket)
            if rec is None:
                return False
            if self._now() - rec["t_request"] < self._delay:
                return False
            build = rec["agent"] is None
            if build:
                rec["agent"] = "building"   # bar re-entry
        if build:
            agent = self._factory(ticket)
            with self._lock:
                rec["agent"] = agent
                self.agents[ticket] = agent
                self.stats["built"] += 1
        return True

    def eta_s(self, ticket: str) -> float:
        with self._lock:
            rec = self._tickets.get(ticket)
            if rec is None or rec["agent"] is not None:
                return 0.0
            return max(self._delay - (self._now() - rec["t_request"]), 0.0)

    def release(self, ticket: str) -> None:
        with self._lock:
            rec = self._tickets.pop(ticket, None)
            agent = self.agents.pop(ticket, None)
        if rec is None:
            return
        self.stats["released"] += 1
        if agent is not None and agent != "building":
            try:
                agent.shutdown()
            except Exception:   # noqa: BLE001
                pass
