"""The async serving front door: HTTP + WebSocket over the router
(port of the reference's ``serve/frontdoor/server.py``).

One asyncio server, four routes:

  * ``GET /healthz``      — liveness + replica count;
  * ``GET /stats``        — SLO aggregates (p50/p99 TTFT, queue wait,
    per-token latency, goodput), per-replica engine counters
    (decode_steps, host_syncs, prefill_batches, load) and the serving
    ``mesh`` (``{"data": replicas, "model": tp}`` under TP, else null);
  * ``POST /v1/generate`` — one-shot JSON: submit, wait, return every
    token. 429 + ``{"error": "queue_full"}`` when admission control
    rejects;
  * ``GET /v1/stream``    — WebSocket. Client sends ``{"type":
    "generate", "prompt": [...], "max_new": n}``; server answers
    ``admitted``, then one ``token`` message per generated token as the
    engine produces it, then ``done``. A client ``{"type": "cancel"}``
    (or dropping the connection) withdraws the request — the engine
    slot frees at the next step boundary and decode continues
    undisturbed for every other request.

The front door is pure host-side asyncio: it owns no tensors and never
calls into torch. Engine work happens in the per-replica worker threads
(:mod:`repro_torch.serve.frontdoor.worker`); this module only moves ints
and JSON between sockets and asyncio queues.
"""
from __future__ import annotations

import asyncio
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.serve.frontdoor.protocol import (
    CLOSE_PROTOCOL_ERROR,
    ProtocolError,
    http_response,
    is_ws_upgrade,
    json_response,
    read_http_request,
    ws_close_frame,
    ws_handshake_response,
    ws_recv_json,
    ws_send_json,
)
from repro_torch.serve.frontdoor.router import (
    NoReplicaAvailable,
    QueueFull,
    ReplicaRouter,
)
from repro_torch.serve.frontdoor.slo import SLOTracker
from repro_torch.serve.frontdoor.worker import TrackedRequest


class FrontDoor:
    """Binds the router to a TCP port and speaks the wire protocol.

    ``port=0`` binds an ephemeral port (tests, chip_smoke.py) — read the real
    one from :attr:`port` after :meth:`start`. ``on_stop`` (a callable)
    runs in a thread at the end of :meth:`stop`: the launcher's TP route
    passes ``TPReplicaGroup.close``, which reaps the rank processes.
    """

    def __init__(self, router: ReplicaRouter, tracker: SLOTracker,
                 host: str = "127.0.0.1", port: int = 0,
                 on_stop: Optional[Callable[[], None]] = None):
        self.router = router
        self.tracker = tracker
        self.host = host
        self.port = port
        self.on_stop = on_stop
        self._server: Optional[asyncio.AbstractServer] = None
        self._worker_tasks: List[asyncio.Task] = []
        self._conns: Set[asyncio.StreamWriter] = set()

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> Tuple[str, int]:
        """Start the replica engine loops and the TCP listener."""
        self._worker_tasks = [
            asyncio.create_task(w.run(), name=f"engine-{w.name}")
            for w in self.router.workers
        ]
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self) -> None:
        """Clean shutdown: stop admitting, let in-flight requests finish,
        join every engine loop, close the listener and the connections
        that clients left open, then ``on_stop``."""
        self.router.stop()
        if self._worker_tasks:
            await asyncio.gather(*self._worker_tasks, return_exceptions=True)
            self._worker_tasks = []
        if self._server is not None:
            self._server.close()
            for writer in list(self._conns):
                writer.close()
            await self._server.wait_closed()
            self._server = None
        if self.on_stop is not None:
            await asyncio.to_thread(self.on_stop)

    # -- connection handling ------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            while True:
                req = await read_http_request(reader)
                if req is None:
                    break  # peer closed the keep-alive connection
                if is_ws_upgrade(req):
                    if req.path != "/v1/stream":
                        writer.write(json_response(
                            404, {"error": "not_found", "path": req.path}))
                        await writer.drain()
                        break
                    writer.write(ws_handshake_response(req))
                    await writer.drain()
                    await self._ws_session(reader, writer)
                    break  # a socket never downgrades back to HTTP
                await self._http_request(req, writer)
        except ProtocolError as e:
            try:
                writer.write(json_response(
                    400, {"error": "bad_request", "detail": str(e)}))
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # peer vanished; per-request cancel handled in the session
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    # -- plain HTTP ---------------------------------------------------------

    async def _http_request(self, req, writer: asyncio.StreamWriter) -> None:
        if req.method == "GET" and req.path == "/healthz":
            writer.write(json_response(200, {
                "ok": True,
                "replicas": len(self.router.workers),
            }))
        elif req.method == "GET" and req.path == "/stats":
            writer.write(json_response(200, self.stats()))
        elif req.method == "POST" and req.path == "/v1/generate":
            writer.write(await self._generate_oneshot(req))
        elif req.path in ("/healthz", "/stats", "/v1/generate"):
            writer.write(http_response(405, b'{"error": "method_not_allowed"}'))
        else:
            writer.write(json_response(
                404, {"error": "not_found", "path": req.path}))
        await writer.drain()

    def stats(self) -> Dict[str, Any]:
        return {"slo": self.tracker.summary(), "router": self.router.stats(),
                "mesh": self.tracker.mesh}

    def _submit(self, body: Dict[str, Any]) -> TrackedRequest:
        """Validate + admit. Raises ProtocolError (400), QueueFull /
        NoReplicaAvailable (429)."""
        try:
            prompt = [int(t) for t in body["prompt"]]
            max_new = int(body.get("max_new", 16))
        except (KeyError, TypeError, ValueError):
            raise ProtocolError(
                "body must be {'prompt': [int, ...], 'max_new': int}"
            ) from None
        try:
            t = self.router.submit(prompt, max_new)
        except ValueError as e:  # engine rejected the prompt shape
            raise ProtocolError(str(e)) from None
        self.tracker.admit()
        return t

    async def _generate_oneshot(self, req) -> bytes:
        try:
            t = self._submit(req.json())
        except (QueueFull, NoReplicaAvailable) as e:
            self.tracker.reject()
            return json_response(429, {"error": "queue_full", "detail": str(e)})
        except ProtocolError as e:
            return json_response(400, {"error": "bad_request", "detail": str(e)})
        tokens: List[int] = []
        while True:
            kind, payload = await t.stream.get()
            if kind == "token":
                tokens.append(payload)
            elif kind == "done":
                self.router.forget(t.req.rid)
                # the done payload's "tokens" field is the count — the
                # one-shot body carries the ids themselves
                return json_response(
                    200, {**payload, "n_tokens": payload["tokens"],
                          "tokens": tokens})
            else:  # engine error
                self.router.forget(t.req.rid)
                return json_response(500, {"error": "engine", "detail": payload})

    # -- WebSocket streaming ------------------------------------------------

    async def _ws_session(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """One upgraded socket: sequential ``generate`` requests, tokens
        streamed as produced, ``cancel`` honored mid-stream, connection
        drop treated as cancel."""
        recv: asyncio.Task = asyncio.create_task(ws_recv_json(reader, writer))
        pump: Optional[asyncio.Task] = None
        active_rid: Optional[int] = None
        try:
            while True:
                waits = {recv} if pump is None else {recv, pump}
                done, _ = await asyncio.wait(
                    waits, return_when=asyncio.FIRST_COMPLETED)
                if pump is not None and pump in done:
                    exc = pump.exception()
                    if exc is not None:
                        # socket died mid-stream: withdraw the request so
                        # its slot frees at the next step boundary
                        self.router.cancel(active_rid)
                    self.router.forget(active_rid)
                    pump, active_rid = None, None
                    if exc is not None:
                        return
                if recv not in done:
                    continue
                msg = recv.result()
                if msg is None:
                    return  # peer closed/hung up; finally-cancel below
                recv = asyncio.create_task(ws_recv_json(reader, writer))
                mtype = msg.get("type") if isinstance(msg, dict) else None
                if mtype == "cancel":
                    rid = msg.get("rid", active_rid)
                    ok = rid is not None and self.router.cancel(rid)
                    await ws_send_json(writer, {
                        "type": "cancel_ack", "rid": rid, "cancelled": bool(ok)})
                elif mtype == "generate":
                    if pump is not None:
                        await ws_send_json(writer, {
                            "type": "error", "error": "busy",
                            "detail": "one active request per stream"})
                        continue
                    try:
                        t = self._submit(msg)
                    except (QueueFull, NoReplicaAvailable) as e:
                        self.tracker.reject()
                        await ws_send_json(writer, {
                            "type": "error", "error": "queue_full",
                            "detail": str(e)})
                        continue
                    except ProtocolError as e:
                        await ws_send_json(writer, {
                            "type": "error", "error": "bad_request",
                            "detail": str(e)})
                        continue
                    active_rid = t.req.rid
                    await ws_send_json(writer, {
                        "type": "admitted", "rid": active_rid,
                        "replica": t.slo.replica})
                    pump = asyncio.create_task(self._pump(t, writer))
                else:
                    await ws_send_json(writer, {
                        "type": "error", "error": "bad_request",
                        "detail": f"unknown message type {mtype!r}"})
        except ProtocolError:
            # malformed frame (fragmented, reserved bits, bad opcode,
            # non-JSON text): tell the peer why with close code 1002
            # before teardown — the finally below still reclaims the
            # admission slot of any in-flight request
            try:
                writer.write(ws_close_frame(CLOSE_PROTOCOL_ERROR))
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        except ConnectionError:
            pass
        finally:
            recv.cancel()
            if pump is not None:
                pump.cancel()
            if active_rid is not None:
                # connection died with a request in flight: free its slot
                self.router.cancel(active_rid)
                self.router.forget(active_rid)

    async def _pump(self, t: TrackedRequest,
                    writer: asyncio.StreamWriter) -> None:
        """Forward one request's stream (tokens, then done) to the
        socket as the engine produces them."""
        rid, idx = t.req.rid, 0
        while True:
            kind, payload = await t.stream.get()
            if kind == "token":
                await ws_send_json(writer, {
                    "type": "token", "rid": rid, "index": idx,
                    "token": payload})
                idx += 1
            elif kind == "done":
                await ws_send_json(writer, {"type": "done", **payload})
                return
            else:
                await ws_send_json(writer, {
                    "type": "error", "error": "engine", "rid": rid,
                    "detail": payload})
                return
