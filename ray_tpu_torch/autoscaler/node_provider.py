"""Own copy of the replica-capacity seam of
``ray_tpu/autoscaler/node_provider.py``: ``CapacityUnavailable``,
``ReplicaCapacityProvider`` and ``ImmediateCapacityProvider``, which
the serve pool's autoscaler (serve/pool_autoscaler.py) requests
capacity from.

The autoscaler never builds a replica out of thin air: it
``request()``s capacity, polls ``ready()`` on the returned ticket,
builds the replica once the ticket is ready, and ``release()``s the
ticket when the replica is later retired. ``eta_s`` is the remaining
provisioning estimate the pool folds into all-shed Retry-After hints,
so a client is never invited back before capacity exists.

The reference's cluster ``NodeProvider``s, ``TPUSliceCapacityProvider``
and ``SimulatedTPUCloud`` (queued TPU slices) wait for the cloud
provider (ROADMAP.md, queue 1, item 13).
"""
from __future__ import annotations

import threading
from typing import Optional


class CapacityUnavailable(RuntimeError):
    """The provider cannot grant more capacity right now (stockout or
    configured ceiling). The autoscaler records the denial and keeps
    serving at the current size."""


class ReplicaCapacityProvider:
    """Capacity seam between the serve-pool autoscaler and whatever
    holds the devices (module docstring)."""

    def request(self) -> str:
        """Ask for capacity for ONE replica. Returns an opaque ticket.
        Raises ``CapacityUnavailable`` on a hard denial."""
        raise NotImplementedError

    def ready(self, ticket: str) -> bool:
        """True when the ticket's capacity is provisioned."""
        raise NotImplementedError

    def eta_s(self, ticket: str) -> float:
        """Remaining provisioning time estimate, seconds (0 when
        ready)."""
        return 0.0

    def release(self, ticket: str) -> None:
        """Return the ticket's capacity (scale-down or an abandoned
        request). Idempotent."""


class ImmediateCapacityProvider(ReplicaCapacityProvider):
    """Capacity that already exists (spare memory on the card, or
    tests): every request is granted and at once ready, up to an
    optional ceiling of tickets granted at the same time."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._granted: set = set()
        self._n = 0

    def request(self) -> str:
        with self._lock:
            if (self._capacity is not None
                    and len(self._granted) >= self._capacity):
                raise CapacityUnavailable(
                    f"capacity ceiling {self._capacity} reached")
            self._n += 1
            ticket = f"immediate-{self._n}"
            self._granted.add(ticket)
            return ticket

    def ready(self, ticket: str) -> bool:
        return True

    def release(self, ticket: str) -> None:
        with self._lock:
            self._granted.discard(ticket)
