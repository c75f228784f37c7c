"""Per-request SLO accounting for the front door (port of the
reference's ``serve/frontdoor/slo.py``).

Every admitted request is timed at four host-side marks:

  * ``t_admit``     — the router accepted it (queue entry);
  * ``t_dispatch``  — it left the engine queue for a slot (recorded at
    the end of the engine step that prefilled it — the worker observes
    slot assignment between steps, so this is step-granular by design);
  * ``t_first``     — its first token was delivered (TTFT);
  * ``t_done``      — it finished (completed, truncated, or cancelled).

Derived metrics: ``ttft_us = t_first - t_admit`` (what a streaming
client feels), ``queue_wait_us = t_dispatch - t_admit`` (admission →
slot, the backpressure signal), and per-token latency (inter-token
gaps after the first token — the decode cadence).

The tracker aggregates p50/p99 over completed requests for the
``/stats`` endpoint and, when a :class:`repro_torch.profile.Profiler` is
installed, emits one ``frontdoor.request``
:class:`~repro_torch.profile.trace.TraceEvent` per finished request — the same versioned trace schema the engine's step
events use, so request-level SLOs land in the same JSON-lines file as
the step timings that explain them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np


def now_us() -> float:
    """Monotonic microseconds (one clock for every SLO mark)."""
    return time.perf_counter() * 1e6


@dataclasses.dataclass
class RequestSLO:
    """The timing record of one front-door request."""

    rid: int
    replica: str
    prompt_len: int
    max_new: int
    t_admit_us: float
    t_dispatch_us: Optional[float] = None
    t_first_us: Optional[float] = None
    t_done_us: Optional[float] = None
    token_gaps_us: List[float] = dataclasses.field(default_factory=list)
    _t_last_tok_us: Optional[float] = None
    tokens: int = 0
    cancelled: bool = False
    truncated: bool = False

    def mark_dispatch(self, t_us: Optional[float] = None) -> None:
        if self.t_dispatch_us is None:
            self.t_dispatch_us = now_us() if t_us is None else t_us

    def mark_token(self, t_us: Optional[float] = None) -> None:
        t = now_us() if t_us is None else t_us
        self.tokens += 1
        if self.t_first_us is None:
            self.t_first_us = t
            # first token implies a slot: dispatch happened no later
            self.mark_dispatch(t)
        elif self._t_last_tok_us is not None:
            self.token_gaps_us.append(t - self._t_last_tok_us)
        self._t_last_tok_us = t

    def mark_done(self, *, cancelled: bool, truncated: bool,
                  t_us: Optional[float] = None) -> None:
        self.t_done_us = now_us() if t_us is None else t_us
        self.cancelled = cancelled
        self.truncated = truncated

    @property
    def ttft_us(self) -> Optional[float]:
        if self.t_first_us is None:
            return None
        return self.t_first_us - self.t_admit_us

    @property
    def queue_wait_us(self) -> Optional[float]:
        if self.t_dispatch_us is None:
            return None
        return self.t_dispatch_us - self.t_admit_us

    @property
    def e2e_us(self) -> Optional[float]:
        if self.t_done_us is None:
            return None
        return self.t_done_us - self.t_admit_us

    def to_json(self) -> Dict[str, Any]:
        return {
            "rid": self.rid,
            "replica": self.replica,
            "tokens": self.tokens,
            "ttft_us": round(self.ttft_us, 1) if self.ttft_us is not None else None,
            "queue_wait_us": round(self.queue_wait_us, 1)
            if self.queue_wait_us is not None else None,
            "e2e_us": round(self.e2e_us, 1) if self.e2e_us is not None else None,
            "cancelled": self.cancelled,
            "truncated": self.truncated,
        }


def _pct(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "n": 0}
    # analysis: host-sync ok -- host latencies (Python floats), no device value
    arr = np.asarray(values, dtype=np.float64)
    return {
        "p50": round(float(np.percentile(arr, 50)), 1),
        "p99": round(float(np.percentile(arr, 99)), 1),
        "mean": round(float(arr.mean()), 1),
        "n": int(arr.size),
    }


class SLOTracker:
    """Aggregates finished :class:`RequestSLO` records and counts
    admissions/rejections — everything ``/stats`` reports. All mutation
    happens on the event loop (single-threaded); the worker threads
    never touch it."""

    def __init__(self, profiler=None, exec_spec: str = "mode:off",
                 mesh: Optional[Dict[str, int]] = None):
        self.profiler = profiler
        self.exec_spec = exec_spec
        self.mesh = mesh
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.cancelled = 0
        self.truncated = 0
        self.tokens_out = 0
        self._t0_us = now_us()
        self._ttft: List[float] = []
        self._queue_wait: List[float] = []
        self._tok_gaps: List[float] = []
        self._e2e: List[float] = []

    def reset(self) -> None:
        """Zero every counter and aggregate and restart the uptime
        clock — a caller calls this after a warm-up pass so the graphs'
        captures never pollute the measured SLOs."""
        self.admitted = self.rejected = 0
        self.completed = self.cancelled = self.truncated = 0
        self.tokens_out = 0
        self._t0_us = now_us()
        self._ttft.clear()
        self._queue_wait.clear()
        self._tok_gaps.clear()
        self._e2e.clear()

    def admit(self) -> None:
        self.admitted += 1

    def reject(self) -> None:
        self.rejected += 1

    def finish(self, slo: RequestSLO) -> None:
        """Fold one finished request into the aggregates (and the trace
        file, when profiling)."""
        if slo.cancelled:
            self.cancelled += 1
        else:
            self.completed += 1
        if slo.truncated:
            self.truncated += 1
        self.tokens_out += slo.tokens
        if slo.ttft_us is not None:
            self._ttft.append(slo.ttft_us)
        if slo.queue_wait_us is not None:
            self._queue_wait.append(slo.queue_wait_us)
        self._tok_gaps.extend(slo.token_gaps_us)
        if slo.e2e_us is not None:
            self._e2e.append(slo.e2e_us)
        if self.profiler is not None:
            from repro_torch.profile.trace import TraceEvent

            self.profiler.record(TraceEvent(
                entry_point="frontdoor.request",
                exec_spec=self.exec_spec,
                shape_class="request",
                mesh=self.mesh,
                wall_us=slo.e2e_us or 0.0,
                dispatch_us=slo.queue_wait_us or 0.0,
                meta=slo.to_json(),
            ))

    def summary(self) -> Dict[str, Any]:
        """The ``/stats`` SLO block: counters + p50/p99 aggregates."""
        wall_s = (now_us() - self._t0_us) * 1e-6
        return {
            "requests": {
                "admitted": self.admitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "cancelled": self.cancelled,
                "truncated": self.truncated,
            },
            "tokens_out": self.tokens_out,
            "uptime_s": round(wall_s, 3),
            "goodput_tok_s": round(self.tokens_out / max(wall_s, 1e-9), 2),
            "slo_us": {
                "ttft": _pct(self._ttft),
                "queue_wait": _pct(self._queue_wait),
                "tok_latency": _pct(self._tok_gaps),
                "e2e": _pct(self._e2e),
            },
        }
