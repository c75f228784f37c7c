"""Multi-replica request router (port of the reference's
``serve/frontdoor/router.py``).

Fans front-door requests across N :class:`EngineWorker` replicas —
each an independent :class:`~repro_torch.serve.engine.ContinuousBatcher`
on the one device, or, under ``--tp``, a tensor-parallel rank group
(:class:`~repro_torch.serve.frontdoor.tp_replica.TPReplica`: one row of
``launch.mesh.make_replica_meshes``' grid, as the reference gives each
replica a ``(1, tp)`` mesh).

Policy, deliberately boring:

  * **least-loaded dispatch** — a new request goes to the healthy,
    non-draining replica with the fewest in-flight requests (ties break
    to the lowest index, making single-replica and N-replica runs
    deterministic for tests);
  * **bounded admission** — total in-flight across replicas is capped;
    over the cap, :meth:`ReplicaRouter.submit` raises
    :class:`QueueFull`, which the HTTP layer maps to 429. Backpressure
    is explicit: the client is told now, rather than parked on an
    unbounded queue distorting every TTFT behind it;
  * **health/drain** — a draining or dead replica receives nothing new;
    its in-flight requests finish (drain) or error out (dead: a worker
    whose step raised drains itself, ``EngineWorker.failed``).

Request ids are allocated router-wide, so a rid names one request
across every replica, trace event and stats endpoint.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

from repro_torch.serve.frontdoor.worker import EngineWorker, TrackedRequest


class QueueFull(RuntimeError):
    """Admission control rejected the request (total in-flight at the
    cap). Maps to HTTP 429 at the front door."""


class NoReplicaAvailable(RuntimeError):
    """Every replica is draining or dead. Maps to HTTP 503-ish 429
    (the front door treats it as a rejection, not a crash)."""


class ReplicaRouter:
    """Least-loaded dispatch over N workers with a global admission cap.
    All methods run on the event loop."""

    def __init__(self, workers: List[EngineWorker], queue_limit: int = 64):
        if not workers:
            raise ValueError("router needs at least one replica")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.workers = list(workers)
        self.queue_limit = int(queue_limit)
        self._rids = itertools.count()
        self._owner: Dict[int, EngineWorker] = {}

    # -- dispatch -----------------------------------------------------------

    @property
    def in_flight(self) -> int:
        return sum(w.load for w in self.workers)

    def _pick(self) -> Optional[EngineWorker]:
        live = [w for w in self.workers if not w.draining]
        if not live:
            return None
        return min(live, key=lambda w: (w.load, self.workers.index(w)))

    def submit(self, prompt: List[int], max_new: int) -> TrackedRequest:
        """Admit one request or raise. QueueFull/NoReplicaAvailable are
        backpressure (429); ValueError is a bad request (400)."""
        if self.in_flight >= self.queue_limit:
            raise QueueFull(
                f"{self.in_flight} requests in flight >= limit {self.queue_limit}")
        w = self._pick()
        if w is None:
            raise NoReplicaAvailable("all replicas draining")
        rid = next(self._rids)
        t = w.submit(rid, prompt, max_new)
        self._owner[rid] = w
        return t

    def cancel(self, rid: int) -> bool:
        """Cancel wherever the request landed; False for unknown/already
        finished rids (cancellation is idempotent at the front door)."""
        w = self._owner.get(rid)
        if w is None:
            return False
        ok = w.cancel(rid)
        if not ok:
            # already finished: drop the stale ownership entry
            self._owner.pop(rid, None)
        return ok

    def forget(self, rid: int) -> None:
        """Drop ownership bookkeeping once a request's stream closed."""
        self._owner.pop(rid, None)

    # -- lifecycle ----------------------------------------------------------

    def drain(self) -> None:
        for w in self.workers:
            w.drain()

    def stop(self) -> None:
        for w in self.workers:
            w.stop()

    def stats(self) -> Dict[str, Any]:
        return {
            "replicas": [w.stats() for w in self.workers],
            "in_flight": self.in_flight,
            "queue_limit": self.queue_limit,
        }
