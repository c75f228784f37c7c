"""Stdlib asyncio client for the front door — the other end of
:mod:`repro_torch.serve.frontdoor.protocol` (port of the reference's
``serve/frontdoor/client.py``).

Used by the front-door tests and ``chip_smoke.py`` so they drive the
*real* network path (TCP, HTTP upgrade, RFC 6455 masked client frames),
not an in-process shortcut. Not a general
HTTP/WebSocket client: it speaks exactly the front door's dialect.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serve.frontdoor.protocol import (
    ProtocolError,
    ws_client_handshake,
    ws_encode_frame,
    ws_recv_json,
    ws_send_json,
    OP_CLOSE,
)


async def _read_http_response(
    reader: asyncio.StreamReader,
) -> Tuple[int, Dict[str, str], bytes]:
    """(status, headers, body) of one HTTP/1.1 response."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ", 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/1."):
        raise ProtocolError(f"bad status line: {lines[0]!r}")
    status = int(parts[1])
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if line and ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    body = await reader.readexactly(int(headers.get("content-length", "0")))
    return status, headers, body


async def http_json(
    host: str, port: int, method: str, path: str,
    body: Optional[Any] = None,
) -> Tuple[int, Any]:
    """One HTTP request -> (status, decoded JSON body)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        payload = b"" if body is None else json.dumps(body).encode("utf-8")
        req = (
            f"{method} {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode("latin-1") + payload
        writer.write(req)
        await writer.drain()
        status, _, resp = await _read_http_response(reader)
        return status, json.loads(resp.decode("utf-8")) if resp else None
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, RuntimeError):
            pass


class WSClient:
    """One upgraded ``/v1/stream`` socket. Client frames are masked per
    RFC 6455 §5.1."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    @classmethod
    async def connect(cls, host: str, port: int,
                      path: str = "/v1/stream") -> "WSClient":
        reader, writer = await asyncio.open_connection(host, port)
        req, expect_accept = ws_client_handshake(host, port, path)
        writer.write(req)
        await writer.drain()
        status, headers, _ = await _read_http_response(reader)
        if status != 101:
            writer.close()
            raise ProtocolError(f"upgrade refused: HTTP {status}")
        if headers.get("sec-websocket-accept") != expect_accept:
            writer.close()
            raise ProtocolError("bad Sec-WebSocket-Accept")
        return cls(reader, writer)

    async def send(self, obj: Any) -> None:
        await ws_send_json(self.writer, obj, mask=True)

    async def recv(self) -> Optional[Any]:
        """Next server message, or None when the server closed."""
        return await ws_recv_json(self.reader, self.writer, mask=True)

    async def close(self) -> None:
        try:
            self.writer.write(ws_encode_frame(OP_CLOSE, b"", mask=True))
            await self.writer.drain()
        except (ConnectionError, RuntimeError):
            pass
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except (ConnectionError, RuntimeError):
            pass

    # -- conveniences for tests and chip_smoke.py ----------------------------

    async def generate(self, prompt: List[int], max_new: int,
                       cancel_after: Optional[int] = None) -> Dict[str, Any]:
        """Run one streamed request to completion; returns ``{"rid",
        "tokens": [...], "done": {...}}``. With ``cancel_after=k``, sends
        a cancel once ``k`` tokens arrived — the result then carries the
        partial stream and ``done["cancelled"] is True``.

        Raises RuntimeError on a server-side rejection (queue_full /
        bad_request) with the error payload attached."""
        await self.send({"type": "generate",
                         "prompt": list(prompt), "max_new": int(max_new)})
        rid: Optional[int] = None
        tokens: List[int] = []
        cancel_sent = False
        while True:
            msg = await self.recv()
            if msg is None:
                raise RuntimeError("server closed mid-stream")
            mtype = msg.get("type")
            if mtype == "admitted":
                rid = msg["rid"]
            elif mtype == "token":
                tokens.append(msg["token"])
                if (cancel_after is not None and not cancel_sent
                        and len(tokens) >= cancel_after):
                    await self.send({"type": "cancel", "rid": rid})
                    cancel_sent = True
            elif mtype == "done":
                return {"rid": rid, "tokens": tokens, "done": msg}
            elif mtype == "cancel_ack":
                continue
            elif mtype == "error":
                err = RuntimeError(f"request rejected: {msg.get('error')}")
                err.payload = msg  # type: ignore[attr-defined]
                raise err
            else:
                raise ProtocolError(f"unexpected message {mtype!r}")
