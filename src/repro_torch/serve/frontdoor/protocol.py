"""Minimal HTTP/1.1 + WebSocket (RFC 6455) wire protocol over asyncio
streams — the front door's only network layer (a copy of the reference's
``serve/frontdoor/protocol.py``; the two speak the same bytes).

Stdlib-only by design: the protocol surface the front door needs is
tiny — parse one request head, write one response, upgrade to a
WebSocket and exchange small single-frame text messages. Both the server
side (handshake accept, unmasked frames out, masked frames in) and the
client side (handshake offer, masked frames out — used by the tests and
``chip_smoke.py``) live here so the two ends can never drift apart.

Deliberate non-goals: frame fragmentation (every message the front door
exchanges fits one frame; fragmented input raises), extensions,
compression, TLS. Control frames are handled per the RFC: ping is
answered with pong, close with close.
"""
from __future__ import annotations

import asyncio
import base64
import dataclasses
import hashlib
import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

#: RFC 6455 §1.3 — the fixed GUID appended to the client key
WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

#: WebSocket frame opcodes (the subset the front door speaks)
OP_TEXT, OP_CLOSE, OP_PING, OP_PONG = 0x1, 0x8, 0x9, 0xA

#: request-head size cap: the front door's JSON bodies are token-id
#: lists, never bulk payloads — anything bigger is a client bug
MAX_HEAD_BYTES = 64 * 1024
MAX_BODY_BYTES = 4 * 1024 * 1024

_STATUS_TEXT = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 429: "Too Many Requests",
    500: "Internal Server Error",
}


class ProtocolError(ValueError):
    """Malformed HTTP head or WebSocket frame."""


@dataclasses.dataclass
class HTTPRequest:
    """One parsed request head (+ body when Content-Length was sent).
    Header names are lower-cased; values keep their wire form."""

    method: str
    path: str
    headers: Dict[str, str]
    body: bytes = b""

    def json(self) -> Any:
        """Decode the body as JSON (raises ProtocolError, not
        JSONDecodeError, so handlers map it to a 400 uniformly)."""
        try:
            return json.loads(self.body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ProtocolError(f"bad JSON body: {e}") from None


async def read_http_request(reader: asyncio.StreamReader) -> Optional[HTTPRequest]:
    """Read one request head (and its Content-Length body) from the
    stream. Returns None on a clean EOF before any bytes (keep-alive
    connection closed by the peer)."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise ProtocolError("connection closed mid-request-head") from None
    except asyncio.LimitOverrunError:
        raise ProtocolError("request head exceeds stream limit") from None
    if len(head) > MAX_HEAD_BYTES:
        raise ProtocolError(f"request head over {MAX_HEAD_BYTES} bytes")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise ProtocolError(f"bad request line: {lines[0]!r}")
    method, path = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        if ":" not in line:
            raise ProtocolError(f"bad header line: {line!r}")
        k, v = line.split(":", 1)
        headers[k.strip().lower()] = v.strip()
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise ProtocolError("bad Content-Length") from None
        if n < 0 or n > MAX_BODY_BYTES:
            raise ProtocolError(f"Content-Length {n} out of range")
        body = await reader.readexactly(n)
    return HTTPRequest(method=method, path=path, headers=headers, body=body)


def http_response(
    status: int,
    body: bytes = b"",
    *,
    content_type: str = "application/json",
    extra_headers: Mapping[str, str] = (),
) -> bytes:
    """Serialize one HTTP/1.1 response (Connection: keep-alive — the
    front door serves many requests per connection)."""
    lines = [
        f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}",
        f"Content-Type: {content_type}",
        f"Content-Length: {len(body)}",
        "Connection: keep-alive",
    ]
    for k, v in dict(extra_headers).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


def json_response(status: int, payload: Any,
                  extra_headers: Mapping[str, str] = ()) -> bytes:
    return http_response(
        status, json.dumps(payload, sort_keys=True).encode("utf-8"),
        extra_headers=extra_headers)


# ---------------------------------------------------------------------------
# WebSocket handshake
# ---------------------------------------------------------------------------


def ws_accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    digest = hashlib.sha1((client_key + WS_GUID).encode("latin-1")).digest()
    return base64.b64encode(digest).decode("latin-1")


def is_ws_upgrade(req: HTTPRequest) -> bool:
    return (
        req.headers.get("upgrade", "").lower() == "websocket"
        and "upgrade" in req.headers.get("connection", "").lower()
        and "sec-websocket-key" in req.headers
    )


def ws_handshake_response(req: HTTPRequest) -> bytes:
    """The 101 Switching Protocols reply to a valid upgrade request."""
    key = req.headers["sec-websocket-key"]
    return (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {ws_accept_key(key)}\r\n\r\n"
    ).encode("latin-1")


def ws_client_handshake(host: str, port: int, path: str) -> Tuple[bytes, str]:
    """(request bytes, expected Sec-WebSocket-Accept) for a client
    upgrade offer."""
    key = base64.b64encode(os.urandom(16)).decode("latin-1")
    req = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    ).encode("latin-1")
    return req, ws_accept_key(key)


# ---------------------------------------------------------------------------
# WebSocket framing
# ---------------------------------------------------------------------------


def ws_encode_frame(opcode: int, payload: bytes, *, mask: bool) -> bytes:
    """One FIN frame. Servers send unmasked, clients masked (RFC 6455
    §5.1 — a server MUST close on an unmasked client frame, so the
    client side here always masks)."""
    head = bytearray([0x80 | (opcode & 0x0F)])
    n = len(payload)
    mask_bit = 0x80 if mask else 0x00
    if n < 126:
        head.append(mask_bit | n)
    elif n < (1 << 16):
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


async def ws_read_frame(reader: asyncio.StreamReader) -> Tuple[int, bytes]:
    """Read one frame -> (opcode, unmasked payload). Raises
    ProtocolError on fragmentation (FIN=0) or reserved bits; EOF mid-
    frame raises IncompleteReadError (callers treat it as a dropped
    peer)."""
    b0, b1 = await reader.readexactly(2)
    fin, opcode = b0 & 0x80, b0 & 0x0F
    if not fin or b0 & 0x70:
        raise ProtocolError("fragmented/reserved-bit WebSocket frame")
    masked, n = b1 & 0x80, b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    if n > MAX_BODY_BYTES:
        raise ProtocolError(f"WebSocket frame over {MAX_BODY_BYTES} bytes")
    key = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n)
    if key is not None:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload


#: RFC 6455 §7.4.1 close codes the front door uses
CLOSE_NORMAL, CLOSE_PROTOCOL_ERROR = 1000, 1002


def ws_close_frame(code: int = CLOSE_NORMAL, reason: bytes = b"",
                   *, mask: bool = False) -> bytes:
    """One close frame with a status code payload (RFC 6455 §5.5.1 —
    the first two payload bytes are the code, big-endian). The server
    answers malformed frames with code 1002 before dropping the
    connection so conforming clients see *why* instead of a bare TCP
    reset."""
    return ws_encode_frame(OP_CLOSE, struct.pack(">H", code) + reason,
                           mask=mask)


def ws_close_code(payload: bytes) -> Optional[int]:
    """Status code of a close-frame payload (None when absent — an
    empty close payload is legal)."""
    if len(payload) < 2:
        return None
    return struct.unpack(">H", payload[:2])[0]


async def ws_send_json(writer: asyncio.StreamWriter, obj: Any,
                       *, mask: bool = False) -> None:
    data = json.dumps(obj, sort_keys=True).encode("utf-8")
    writer.write(ws_encode_frame(OP_TEXT, data, mask=mask))
    await writer.drain()


async def ws_recv_json(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
    *, mask: bool = False,
) -> Optional[Any]:
    """Next text message as decoded JSON, transparently answering pings.
    Returns None when the peer sent close (a close reply is echoed) or
    hung up."""
    while True:
        try:
            opcode, payload = await ws_read_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        if opcode == OP_TEXT:
            try:
                return json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ProtocolError(f"bad JSON WebSocket message: {e}") from None
        if opcode == OP_PING:
            writer.write(ws_encode_frame(OP_PONG, payload, mask=mask))
            await writer.drain()
            continue
        if opcode == OP_CLOSE:
            try:
                writer.write(ws_encode_frame(OP_CLOSE, b"", mask=mask))
                await writer.drain()
            except ConnectionError:
                pass
            return None
        if opcode == OP_PONG:
            continue
        raise ProtocolError(f"unsupported WebSocket opcode {opcode:#x}")
