"""One engine replica under the async front door (port of the reference's
``serve/frontdoor/worker.py``).

An :class:`EngineWorker` owns one :class:`~repro_torch.serve.engine.
ContinuousBatcher` and drives its host loop from a dedicated
single-thread executor so the event loop never blocks on a step: the
coroutine :meth:`EngineWorker.run` awaits one ``batcher.step()`` at a
time in the worker thread, then — back on the event loop, with no step
in flight — drains newly generated tokens into per-request asyncio
queues and applies any pending cancellations at the step boundary
(``ContinuousBatcher.cancel`` is host-side bookkeeping and must not race
a step that is reading the slot table).

The async layer adds **nothing** inside the step: the only thing it ever
applies to the engine's step callable is :func:`passthrough_step` (the
identity). Every device->host fetch stays the engine's own (one per
decode step, one per prefill batch: ``host_syncs == decode_steps +
prefill_batches``); the worker reads only host-side Python state
(``Request.generated`` lists of ints), so serving over the network
changes neither the host-sync count nor the captured graphs.

Replicas on one CUDA device step one at a time: each step holds the
device's lock (:func:`device_lock`). A capture (``torch.cuda.graph``,
global capture mode) fails or is invalidated by CUDA work from another
thread, which a replica's replay, allocation or input copy would be, and
the kernel wrappers' launch counters, which a capture takes back, are
process-wide. Replicas on one card share its default stream, so their
steps were serialized on the device anyway. Each step runs on the stream
that was current where the worker was built (where its batcher was),
because torch keeps the current stream per thread. On the CPU, replicas
step concurrently, as the reference's do. A tensor-parallel replica
(``tp_replica.TPReplica``, ``remote``) steps in rank processes of its
own: the worker takes no lock and no stream for it (see that module).

A replica whose step raises fails: its open streams end with an error
frame, it takes nothing new (``draining``, and ``failed`` in its stats
says why), and the router passes it by.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Set, Tuple

import torch

from repro_torch.serve.engine import ContinuousBatcher, Request
from repro_torch.serve.frontdoor.slo import RequestSLO, SLOTracker, now_us

# the card is process-wide state, and so is its lock
_DEVICE_LOCKS: Dict[torch.device, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_lock(device: torch.device) -> threading.Lock:
    """The lock that every front-door replica on CUDA ``device`` holds
    for each of its steps (one per device and process)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(device, threading.Lock())


def passthrough_step(fn):
    """The identity — and deliberately so. This is the single seam the
    front door applies to the engine's step callable before scheduling
    it on the worker thread; keeping it a named function gives the
    tests a concrete subject: the step the worker runs is the batcher's
    own ``step``, so timing inside the step would have to go through the
    engine's ``profile=`` hook, never through the front door."""
    return fn


@dataclasses.dataclass
class TrackedRequest:
    """Event-loop-side view of one in-flight engine request."""

    req: Request
    slo: RequestSLO
    stream: "asyncio.Queue[Tuple[str, Any]]"
    delivered: int = 0
    dispatched: bool = False


class EngineWorker:
    """Drives one batcher replica; owns its submission/cancel/token
    plumbing. All public methods run on the event loop."""

    def __init__(self, name: str, batcher: ContinuousBatcher,
                 tracker: SLOTracker, pace_us: float = 0.0):
        self.name = name
        self.batcher = batcher
        self.tracker = tracker
        # modeled per-step device latency: slept in the replica's worker
        # thread AFTER each real engine step (outside the device lock),
        # with the GIL released — the way accelerator compute occupies a
        # device without occupying the host; 0 disables (the default)
        self.pace_us = float(pace_us)
        cuda = batcher.device.type == "cuda" and not getattr(batcher, "remote", False)
        self._lock = device_lock(batcher.device) if cuda else None
        self._stream = torch.cuda.current_stream(batcher.device) if cuda else None
        self._tracked: Dict[int, TrackedRequest] = {}
        self._pending_cancels: Set[int] = set()
        self._wake = asyncio.Event()
        self._stopping = False
        self.draining = False
        self.failed = None
        self.steps = 0
        self.completed = self.cancelled = 0
        # one thread: engine steps serialize per replica (the batcher is
        # not reentrant)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"engine-{name}")

    # -- submission / cancellation (event loop) -----------------------------

    @property
    def load(self) -> int:
        """In-flight request count (queued + active slots) — the
        router's least-loaded dispatch key."""
        return len(self._tracked)

    def submit(self, rid: int, prompt, max_new: int) -> TrackedRequest:
        """Hand one request to the engine. Raises ValueError for
        unservable prompts (empty, over s_max, token ids outside the
        vocabulary — the engine's own checks), RuntimeError when
        draining/stopped."""
        if self.draining or self._stopping:
            raise RuntimeError(f"replica {self.name} is draining")
        req = Request(rid, list(prompt), max_new=int(max_new))
        # batcher.submit validates before touching engine state, so a
        # rejected prompt leaves no tracking residue
        self.batcher.submit(req)
        t = TrackedRequest(
            req=req,
            slo=RequestSLO(rid=rid, replica=self.name,
                           prompt_len=len(req.prompt), max_new=req.max_new,
                           t_admit_us=now_us()),
            stream=asyncio.Queue(),
        )
        self._tracked[rid] = t
        self._wake.set()
        return t

    def cancel(self, rid: int) -> bool:
        """Request cancellation of ``rid``; applied at the next step
        boundary (the engine's slot table must not change under a
        running step). Returns False when rid is not in flight here."""
        if rid not in self._tracked:
            return False
        self._pending_cancels.add(rid)
        self._wake.set()
        return True

    def drain(self) -> None:
        """Stop accepting new requests; in-flight requests finish."""
        self.draining = True
        self._wake.set()

    def stop(self) -> None:
        """Drain and let :meth:`run` exit once in-flight work is done."""
        self.draining = True
        self._stopping = True
        self._wake.set()

    def stats(self) -> Dict[str, Any]:
        s = self.batcher.stats()
        s.update({
            "name": self.name,
            "load": self.load,
            "queue_len": len(self.batcher.queue),
            "slots_active": sum(r is not None for r in self.batcher.slot_req),
            "n_slots": self.batcher.n_slots,
            "draining": self.draining,
            "failed": self.failed,
            "completed": self.completed,
            "cancelled": self.cancelled,
        })
        return s

    # -- the engine loop ----------------------------------------------------

    def _has_work(self) -> bool:
        return bool(self.batcher.queue) or any(
            r is not None for r in self.batcher.slot_req)

    def _engine_step(self, step) -> None:
        """One step in the worker thread: under the device's lock and on
        the worker's stream on the card."""
        if self._lock is None:
            step()
        else:
            with self._lock, torch.cuda.stream(self._stream):
                step()
        if self.pace_us > 0:
            time.sleep(self.pace_us * 1e-6)  # modeled device time, off the GIL

    async def run(self) -> None:
        """The replica's engine loop: step in the worker thread, drain
        tokens on the event loop, sleep when idle. Exits after
        :meth:`stop` once every in-flight request finished."""
        loop = asyncio.get_running_loop()
        step = passthrough_step(self.batcher.step)
        try:
            while True:
                self._apply_cancels()
                if self._has_work():
                    await loop.run_in_executor(self._pool, self._engine_step, step)
                    self.steps += 1
                    self._drain_tokens()
                elif self._stopping:
                    break
                else:
                    self._wake.clear()
                    # woken by submit/cancel/drain/stop
                    await self._wake.wait()
        except Exception as e:  # engine died: fail every open stream
            self.failed = repr(e)
            self.draining = True  # the router sends nothing more here
            for t in list(self._tracked.values()):
                t.stream.put_nowait(("error", f"engine error: {e!r}"))
            self._tracked.clear()
            raise
        finally:
            self._pool.shutdown(wait=True)

    def _apply_cancels(self) -> None:
        """Engine-level cancel between steps; finalization (the 'done'
        sentinel with cancelled=True) rides the same drain path as
        normal completion."""
        if not self._pending_cancels:
            return
        for rid in sorted(self._pending_cancels):
            self.batcher.cancel(rid)
        self._pending_cancels.clear()
        self._drain_tokens()

    def _drain_tokens(self) -> None:
        """Move newly generated tokens from engine Requests into the
        per-request streams; finalize finished requests. Runs only when
        no step is in flight, so reading engine state is race-free."""
        now = now_us()
        in_queue = {r.rid for r in self.batcher.queue}
        for rid in list(self._tracked):
            t = self._tracked[rid]
            if not t.dispatched and rid not in in_queue:
                t.slo.mark_dispatch(now)
                t.dispatched = True
            gen = t.req.generated
            while t.delivered < len(gen):
                tok = gen[t.delivered]
                t.delivered += 1
                t.slo.mark_token(now)
                t.stream.put_nowait(("token", int(tok)))
            if t.req.done:
                t.slo.mark_done(cancelled=t.req.cancelled,
                                truncated=t.req.truncated, t_us=now)
                self.tracker.finish(t.slo)
                if t.req.cancelled:
                    self.cancelled += 1
                else:
                    self.completed += 1
                t.stream.put_nowait(("done", {
                    "rid": rid,
                    "tokens": t.slo.tokens,
                    "cancelled": t.req.cancelled,
                    "truncated": t.req.truncated,
                    "ttft_us": round(t.slo.ttft_us or 0.0, 1),
                    "queue_wait_us": round(t.slo.queue_wait_us or 0.0, 1),
                    "e2e_us": round(t.slo.e2e_us or 0.0, 1),
                    "replica": self.name,
                }))
                del self._tracked[rid]


# ---------------------------------------------------------------------------
# Tracing contract (repro_torch.analysis): the front door's seam adds
# nothing to the engine's step -- the program through passthrough_step
# is the program without it, with no host sync in either.
# ---------------------------------------------------------------------------

from repro_torch.analysis.contracts import (  # noqa: E402
    TraceContract,
    register_trace_contract,
)


def _passthrough_point():
    def build(wrapped: int = 0):
        from repro_torch.serve.engine import fused_step_point

        step, args = fused_step_point("off")(n_slots=3)
        if wrapped:
            step = passthrough_step(step)
        return step, args

    return build


register_trace_contract(
    "serve.frontdoor.step_passthrough",
    _passthrough_point(),
    TraceContract(max_host_syncs=0, max_host_to_device=0),
    axes={"wrapped": (0, 1)},
)
