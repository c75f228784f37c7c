"""``repro_torch.serve.frontdoor`` — the async serving front door (port of
the reference's ``serve/frontdoor``): a stdlib-asyncio HTTP + WebSocket
server over N :class:`~repro_torch.serve.engine.ContinuousBatcher`
replicas.

  * :mod:`.protocol` — HTTP/1.1 + RFC 6455 wire layer (server and
    client side, stdlib only; the reference's bytes);
  * :mod:`.worker`   — one engine replica: step in a worker thread
    (under the device's lock on the card), token/cancel plumbing at step
    boundaries;
  * :mod:`.tp_replica` — a tensor-parallel replica: rank processes of
    one gloo world behind a batcher-shaped proxy (``--tp``);
  * :mod:`.router`   — least-loaded dispatch, bounded admission
    (QueueFull -> 429), replica drain/health;
  * :mod:`.slo`      — per-request TTFT / queue-wait / per-token
    latency, aggregated for ``/stats`` and emitted as
    ``frontdoor.request`` trace events;
  * :mod:`.server`   — the routes: /healthz, /stats, /v1/generate,
    /v1/stream (WebSocket);
  * :mod:`.client`   — the matching stdlib client (tests and
    ``chip_smoke.py``).
"""
from repro_torch.serve.frontdoor.client import WSClient, http_json  # noqa: F401
from repro_torch.serve.frontdoor.protocol import ProtocolError  # noqa: F401
from repro_torch.serve.frontdoor.router import (  # noqa: F401
    NoReplicaAvailable,
    QueueFull,
    ReplicaRouter,
)
from repro_torch.serve.frontdoor.server import FrontDoor  # noqa: F401
from repro_torch.serve.frontdoor.slo import RequestSLO, SLOTracker  # noqa: F401
from repro_torch.serve.frontdoor.worker import (  # noqa: F401
    EngineWorker,
    passthrough_step,
)
