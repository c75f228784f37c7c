"""The port's async front door (``repro_torch.serve.frontdoor``) against
the JAX package's, over the real network stack (TCP loopback, HTTP
upgrade, RFC 6455 frames): the wire protocol byte for byte in both
directions, the SLO aggregates of the same timelines, and the reference's
``TestFrontDoor`` on the port's door (smollm-135m smoke, f32, mode "off",
params through the bridge): streamed tokens == the port's
``generate()``, survivors of a cancel exact, 429 when saturated, token
identity across two replicas with one host sync per step and fill batch,
the one-shot POST, /healthz, /stats and a clean shutdown, a dropped
connection cancelling, a protocol error closing with 1002 and freeing the
slot; and the reference's door and the port's streaming the same tokens
for the same prompts."""
import asyncio

import jax
import numpy as np
import pytest

from repro.models import transformer as jT
from repro.models.layers import QuantConfig as JQuant
from repro.models.registry import get_config as jget_config
from repro.serve import frontdoor as JF
from repro.serve.engine import ContinuousBatcher as JBatcher
from repro.serve.frontdoor import protocol as jproto
from repro.serve.frontdoor import slo as jslo
from repro_torch.bridge import params_from_numpy
from repro_torch.models.layers import QuantConfig
from repro_torch.models.registry import get_config
from repro_torch.serve import frontdoor as F
from repro_torch.serve.engine import ContinuousBatcher, generate
from repro_torch.serve.frontdoor import protocol as proto
from repro_torch.serve.frontdoor import slo
from repro_torch.serve.frontdoor.client import WSClient, http_json
from torch_threads import one_thread  # noqa: F401

PROMPTS = [[3, 1, 4], [9, 8], [2, 7, 1, 8], [6], [5, 5, 5], [1, 2]]
MAX_NEWS = [4, 6, 3, 5, 4, 6]


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("smollm-135m", smoke=True).replace(
        dtype="float32", quant=JQuant(mode="off"))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    tcfg = get_config("smollm-135m", smoke=True).replace(
        dtype="float32", quant=QuantConfig(mode="off"))
    return jcfg, jparams, tcfg, params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def solo(models):
    """The port's greedy generate() stream of a prompt, memoized."""
    _, _, cfg, params = models
    memo = {}

    def tokens(prompt, max_new):
        key = (tuple(prompt), max_new)
        if key not in memo:
            memo[key] = generate(params, [prompt], cfg, max_new=max_new, s_max=32,
                                 device="cpu")[0].tolist()
        return memo[key]

    return tokens


# ---------------------------------------------------------------------------
# The wire protocol against the reference's
# ---------------------------------------------------------------------------


def test_ws_accept_key_rfc_vector():
    # RFC 6455 §1.3's worked example
    for mod in (proto, jproto):
        assert mod.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
            "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def _read_frame(mod, frame):
    async def read():
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        return await mod.ws_read_frame(reader)

    return asyncio.run(read())


# every length encoding (7-bit, 16-bit and 64-bit extended) at its edges
@pytest.mark.parametrize("size", [0, 125, 126, 65535, 65536])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_frames_cross_read(size, mask, writer):
    w, r = (proto, jproto) if writer == "port" else (jproto, proto)
    payload = bytes(i % 251 for i in range(size))
    frame = w.ws_encode_frame(w.OP_TEXT, payload, mask=mask)
    assert _read_frame(r, frame) == (r.OP_TEXT, payload)
    assert _read_frame(w, frame) == (w.OP_TEXT, payload)
    if not mask:  # unmasked frames carry no random key: equal bytes
        assert frame == r.ws_encode_frame(r.OP_TEXT, payload, mask=False)


def test_fragmented_frame_rejected():
    with pytest.raises(proto.ProtocolError):
        _read_frame(proto, bytes([0x01, 0x01, 0x41]))  # FIN=0 text frame


def test_close_frames_and_responses_match_reference():
    assert proto.ws_close_frame(proto.CLOSE_PROTOCOL_ERROR) == \
        jproto.ws_close_frame(jproto.CLOSE_PROTOCOL_ERROR)
    assert proto.ws_close_code(proto.ws_close_frame(1002)[2:]) == 1002
    for status in (200, 400, 404, 405, 429, 500):
        assert proto.json_response(status, {"error": "x", "n": [1, 2]}) == \
            jproto.json_response(status, {"error": "x", "n": [1, 2]})
    assert proto.http_response(429, b'{"error": "queue_full"}').startswith(
        b"HTTP/1.1 429 Too Many Requests\r\n")


@pytest.mark.parametrize("raw", [
    b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n\r\n{}",
    b"GET /v1/stream HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
    b"Connection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n\r\n",
    b"GET /stats HTTP/1.0\r\nHost: x\r\n\r\n",
])
def test_http_parsing_matches_reference(raw):
    def parse(mod):
        async def run():
            reader = asyncio.StreamReader()
            reader.feed_data(raw)
            reader.feed_eof()
            return await mod.read_http_request(reader)

        return asyncio.run(run())

    mine, theirs = parse(proto), parse(jproto)
    assert (mine.method, mine.path, mine.headers, mine.body) == (
        theirs.method, theirs.path, theirs.headers, theirs.body)
    assert proto.is_ws_upgrade(mine) == jproto.is_ws_upgrade(theirs)
    if proto.is_ws_upgrade(mine):
        assert proto.ws_handshake_response(mine) == jproto.ws_handshake_response(theirs)


@pytest.mark.parametrize("raw", [b"BAD\r\n\r\n", b"GET / HTTP/1.1\r\nnocolon\r\n\r\n",
                                 b"GET / HTTP/1.1\r\nContent-Length: x\r\n\r\n"])
def test_http_parsing_rejects_what_the_reference_rejects(raw):
    for mod in (proto, jproto):
        async def run():
            reader = asyncio.StreamReader()
            reader.feed_data(raw)
            reader.feed_eof()
            return await mod.read_http_request(reader)

        with pytest.raises(mod.ProtocolError):
            asyncio.run(run())


# ---------------------------------------------------------------------------
# SLO accounting against the reference's
# ---------------------------------------------------------------------------

# (rid, admit, dispatch, token times, done, cancelled, truncated), in us
TIMELINES = [
    (0, 0.0, 120.0, [500.0, 900.0, 1300.0, 1750.0], 1750.0, False, False),
    (1, 10.0, 130.0, [700.0, 1000.0], 1100.0, True, True),
    (2, 20.0, None, [2400.0, 2410.0, 2600.0], 2600.0, False, True),
    (3, 30.0, 3000.0, [], 3100.0, True, False),
]


def _summary(mod, prof_mod=None):
    profiler = prof_mod.Profiler() if prof_mod is not None else None
    tracker = mod.SLOTracker(profiler=profiler, exec_spec="mode:off")
    for _ in TIMELINES:
        tracker.admit()
    tracker.reject()
    for rid, admit, dispatch, toks, done, cancelled, truncated in TIMELINES:
        s = mod.RequestSLO(rid=rid, replica="r0", prompt_len=3, max_new=8,
                           t_admit_us=admit)
        if dispatch is not None:
            s.mark_dispatch(dispatch)
        for t in toks:
            s.mark_token(t)
        s.mark_done(cancelled=cancelled, truncated=truncated, t_us=done)
        tracker.finish(s)
    out = tracker.summary()
    del out["uptime_s"], out["goodput_tok_s"]  # from the wall clock
    return out, profiler


def test_slo_summary_matches_reference():
    import repro.profile as JP
    from repro_torch import profile as P

    mine, prof = _summary(slo, P)
    theirs, jprof = _summary(jslo, JP)
    assert mine == theirs
    assert mine["requests"] == {"admitted": 4, "rejected": 1, "completed": 2,
                                "cancelled": 2, "truncated": 2}
    assert [e.to_json() for e in prof.events] == [e.to_json() for e in jprof.events]
    assert {e.entry_point for e in prof.events} == {"frontdoor.request"}


def test_slo_reset_zeroes_everything():
    tracker = slo.SLOTracker()
    tracker.admit()
    tracker.reset()
    s = tracker.summary()
    assert s["requests"] == {"admitted": 0, "rejected": 0, "completed": 0,
                             "cancelled": 0, "truncated": 0}
    assert s["slo_us"]["ttft"]["n"] == 0


# ---------------------------------------------------------------------------
# The port's front door over real sockets
# ---------------------------------------------------------------------------


async def _make_door(models, *, replicas=1, n_slots=2, s_max=32, queue_limit=16,
                     pkg=F):
    jcfg, jparams, cfg, params = models
    tracker = pkg.SLOTracker()
    if pkg is F:
        batchers = [ContinuousBatcher(params, cfg, n_slots=n_slots, s_max=s_max,
                                      device="cpu") for _ in range(replicas)]
    else:
        batchers = [JBatcher(jparams, jcfg, n_slots=n_slots, s_max=s_max)
                    for _ in range(replicas)]
    workers = [pkg.EngineWorker(f"r{i}", b, tracker) for i, b in enumerate(batchers)]
    door = pkg.FrontDoor(pkg.ReplicaRouter(workers, queue_limit=queue_limit), tracker)
    await door.start()
    return door


def test_passthrough_is_identity_and_no_lock_off_the_card(models):
    def f():
        return 1

    assert F.passthrough_step(f) is f

    async def scenario():
        door = await _make_door(models, replicas=2)
        try:
            return [w._lock for w in door.router.workers]
        finally:
            await door.stop()

    assert asyncio.run(scenario()) == [None, None]  # CPU replicas step concurrently


def test_streamed_tokens_match_generate(models, solo):
    async def scenario():
        door = await _make_door(models)
        try:
            ws = await WSClient.connect(door.host, door.port)
            await ws.send({"type": "generate", "prompt": [3, 1, 4], "max_new": 6})
            msgs = []
            while True:
                m = await ws.recv()
                msgs.append(m)
                if m["type"] in ("done", "error"):
                    break
            await ws.close()
            return msgs
        finally:
            await door.stop()

    msgs = asyncio.run(scenario())
    assert msgs[0]["type"] == "admitted"
    toks = [m for m in msgs if m["type"] == "token"]
    assert [m["index"] for m in toks] == list(range(len(toks)))
    assert msgs[-1]["type"] == "done" and msgs[-1]["cancelled"] is False
    assert [m["token"] for m in toks] == solo([3, 1, 4], 6)


def test_cancel_mid_stream_is_clean_and_survivor_exact(models, solo):
    async def scenario():
        door = await _make_door(models, n_slots=2)
        try:
            w1 = await WSClient.connect(door.host, door.port)
            w2 = await WSClient.connect(door.host, door.port)
            victim, survivor = await asyncio.gather(
                w1.generate([3, 1, 4], 20, cancel_after=2), w2.generate([9, 8], 8))
            await w1.close()
            await w2.close()
            return victim, survivor
        finally:
            await door.stop()

    victim, survivor = asyncio.run(scenario())
    assert victim["done"]["cancelled"] is True
    assert 2 <= len(victim["tokens"]) < 20
    assert victim["tokens"] == solo([3, 1, 4], 20)[: len(victim["tokens"])]
    assert survivor["done"]["cancelled"] is False
    assert survivor["tokens"] == solo([9, 8], 8)


def test_admission_rejected_when_saturated(models, solo):
    async def scenario():
        door = await _make_door(models, n_slots=1, queue_limit=1)
        try:
            w1 = await WSClient.connect(door.host, door.port)
            w2 = await WSClient.connect(door.host, door.port)
            first = asyncio.ensure_future(w1.generate([3, 1, 4], 12))
            while door.router.in_flight == 0:
                await asyncio.sleep(0.001)
            rejected_ws = None
            try:
                await w2.generate([9, 8], 4)
            except RuntimeError as e:
                rejected_ws = e.payload
            status_429, body = await http_json(
                door.host, door.port, "POST", "/v1/generate",
                {"prompt": [9, 8], "max_new": 4})
            await first
            retry = await w2.generate([9, 8], 4)
            await w1.close()
            await w2.close()
            _, stats = await http_json(door.host, door.port, "GET", "/stats")
            return rejected_ws, status_429, body, retry, stats
        finally:
            await door.stop()

    rejected_ws, status_429, body, retry, stats = asyncio.run(scenario())
    assert rejected_ws is not None and rejected_ws["error"] == "queue_full"
    assert status_429 == 429 and body["error"] == "queue_full"
    assert retry["tokens"] == solo([9, 8], 4)
    assert stats["slo"]["requests"]["rejected"] == 2


async def _stream_all(door, prompts=PROMPTS, max_news=MAX_NEWS, client=WSClient,
                      http=http_json):
    conns = [await client.connect(door.host, door.port) for _ in prompts]
    results = await asyncio.gather(*[
        ws.generate(p, m) for ws, p, m in zip(conns, prompts, max_news)])
    for ws in conns:
        await ws.close()
    _, stats = await http(door.host, door.port, "GET", "/stats")
    return results, stats


def test_router_two_replicas_token_identity(models, solo):
    """Six concurrent streams across 2 replicas: every request's greedy
    tokens equal generate(), both replicas served work, and each kept one
    host sync per decode step and per fill batch (the reference's
    ``serve.frontdoor.step_passthrough`` contract)."""
    async def scenario():
        door = await _make_door(models, replicas=2, n_slots=2, queue_limit=16)
        try:
            return await _stream_all(door)
        finally:
            await door.stop()

    results, stats = asyncio.run(scenario())
    for res, p, m in zip(results, PROMPTS, MAX_NEWS):
        assert res["tokens"] == solo(p, m), p
    replicas = stats["router"]["replicas"]
    assert all(r["decode_steps"] > 0 for r in replicas), replicas
    for r in replicas:
        assert r["host_syncs"] == r["decode_steps"] + r["prefill_batches"], r
    assert stats["slo"]["requests"]["completed"] == len(PROMPTS)
    assert stats["router"]["in_flight"] == 0


def test_oneshot_post_returns_token_ids(models, solo):
    async def scenario():
        door = await _make_door(models)
        try:
            ok = await http_json(door.host, door.port, "POST", "/v1/generate",
                                 {"prompt": [3, 1, 4], "max_new": 5})
            # token ids outside the vocabulary are a bad request
            bad = await http_json(door.host, door.port, "POST", "/v1/generate",
                                  {"prompt": [3, 256], "max_new": 5})
            return ok, bad
        finally:
            await door.stop()

    (status, body), (bad_status, bad_body) = asyncio.run(scenario())
    assert status == 200
    assert body["tokens"] == solo([3, 1, 4], 5)
    assert body["n_tokens"] == 5 and body["cancelled"] is False
    assert bad_status == 400 and bad_body["error"] == "bad_request"


def test_healthz_stats_and_clean_shutdown(models):
    async def scenario():
        door = await _make_door(models, replicas=2)
        try:
            s1, health = await http_json(door.host, door.port, "GET", "/healthz")
            ws = await WSClient.connect(door.host, door.port)
            await ws.generate([5], 2)
            await ws.close()
            s2, stats = await http_json(door.host, door.port, "GET", "/stats")
            s3, missing = await http_json(door.host, door.port, "GET", "/nope")
            s4, _ = await http_json(door.host, door.port, "POST", "/stats")
        finally:
            await door.stop()
        loads = [w.load for w in door.router.workers]
        return s1, health, s2, stats, s3, missing, s4, loads

    s1, health, s2, stats, s3, missing, s4, loads = asyncio.run(scenario())
    assert s1 == 200 and health["ok"] and health["replicas"] == 2
    assert s2 == 200
    assert stats["slo"]["tokens_out"] == 2
    assert stats["slo"]["slo_us"]["ttft"]["n"] == 1
    assert s3 == 404 and missing["error"] == "not_found"
    assert s4 == 405
    assert loads == [0, 0]


def test_connection_drop_cancels_in_flight(models):
    async def scenario():
        door = await _make_door(models, n_slots=1)
        try:
            ws = await WSClient.connect(door.host, door.port)
            await ws.send({"type": "generate", "prompt": [3, 1, 4], "max_new": 24})
            got = 0
            while got < 2:
                m = await ws.recv()
                if m["type"] == "token":
                    got += 1
            ws.writer.close()
            for _ in range(2000):
                if door.router.in_flight == 0:
                    break
                await asyncio.sleep(0.005)
            return door.router.in_flight, door.tracker.cancelled
        finally:
            await door.stop()

    in_flight, cancelled = asyncio.run(scenario())
    assert in_flight == 0
    assert cancelled == 1


def test_protocol_error_closes_1002_and_frees_slot(models):
    async def scenario():
        door = await _make_door(models, n_slots=1)
        try:
            ws = await WSClient.connect(door.host, door.port)
            await ws.send({"type": "generate", "prompt": [3, 1, 4], "max_new": 24})
            got = 0
            while got < 2:
                m = await ws.recv()
                if m["type"] == "token":
                    got += 1
            # FIN=0 masked text frame, empty payload: fragmentation is a
            # deliberate non-goal, the server must refuse it
            ws.writer.write(bytes([0x01, 0x80, 0, 0, 0, 0]))
            await ws.writer.drain()
            code = None
            for _ in range(100):
                opcode, payload = await asyncio.wait_for(
                    proto.ws_read_frame(ws.reader), timeout=5)
                if opcode == proto.OP_CLOSE:
                    code = proto.ws_close_code(payload)
                    break
            for _ in range(2000):
                if door.router.in_flight == 0:
                    break
                await asyncio.sleep(0.005)
            ws.writer.close()
            return code, door.router.in_flight, door.tracker.cancelled
        finally:
            await door.stop()

    code, in_flight, cancelled = asyncio.run(scenario())
    assert code == 1002
    assert in_flight == 0
    assert cancelled == 1


def test_profiled_door_records_steps_and_requests(models, solo, tmp_path):
    """One profiler shared by two replicas and the tracker: one
    serve.decode_step event per decode step, one serve.prefill per fill
    batch and one frontdoor.request per request, in one valid file."""
    from repro_torch import profile as P

    path = tmp_path / "door.jsonl"

    async def scenario():
        _, _, cfg, params = models
        prof = P.Profiler(path)
        tracker = F.SLOTracker(profiler=prof)
        batchers = [ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu",
                                      profile=prof) for _ in range(2)]
        workers = [F.EngineWorker(f"r{i}", b, tracker) for i, b in enumerate(batchers)]
        door = F.FrontDoor(F.ReplicaRouter(workers), tracker)
        await door.start()
        try:
            results, stats = await _stream_all(door)
        finally:
            await door.stop()
            prof.close()
        return results, stats

    results, stats = asyncio.run(scenario())
    for res, p, m in zip(results, PROMPTS, MAX_NEWS):
        assert res["tokens"] == solo(p, m), p
    events = P.read_trace(path)
    count = {k: sum(e.entry_point == k for e in events)
             for k in ("serve.decode_step", "serve.prefill", "frontdoor.request")}
    replicas = stats["router"]["replicas"]
    assert count == {"serve.decode_step": sum(r["decode_steps"] for r in replicas),
                     "serve.prefill": sum(r["prefill_batches"] for r in replicas),
                     "frontdoor.request": len(PROMPTS)}
    assert len(events) == sum(count.values())


def test_reference_and_port_doors_stream_the_same_tokens(models, solo):
    """The reference's front door (its batchers, its client) and the
    port's, each with two replicas, stream the same tokens for the same
    prompts at f32."""
    async def scenario(pkg, client, http):
        door = await _make_door(models, replicas=2, n_slots=2, pkg=pkg)
        try:
            return await _stream_all(door, client=client, http=http)
        finally:
            await door.stop()

    mine, _ = asyncio.run(scenario(F, WSClient, http_json))
    theirs, jstats = asyncio.run(scenario(JF, JF.WSClient, JF.http_json))
    assert [r["tokens"] for r in mine] == [r["tokens"] for r in theirs]
    assert [r["tokens"] for r in mine] == [solo(p, m) for p, m in zip(PROMPTS, MAX_NEWS)]
    assert jstats["slo"]["requests"]["completed"] == len(PROMPTS)


def test_port_client_speaks_to_the_reference_door(models):
    """The port's client against the reference's server: the protocol
    copies interoperate over a socket."""
    async def scenario():
        door = await _make_door(models, pkg=JF)
        try:
            ws = await WSClient.connect(door.host, door.port)
            res = await ws.generate([6], 3)
            await ws.close()
            status, health = await http_json(door.host, door.port, "GET", "/healthz")
            return res, status, health
        finally:
            await door.stop()

    res, status, health = asyncio.run(scenario())
    assert len(res["tokens"]) == 3 and res["done"]["cancelled"] is False
    assert status == 200 and health["ok"]


def test_engine_error_fails_open_streams(models):
    """A step that raises fails every open stream with an error message
    (nothing runs on in its place)."""
    async def scenario():
        _, _, cfg, params = models
        batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu")

        def broken():
            raise RuntimeError("capture failed")

        batcher.step = broken
        tracker = F.SLOTracker()
        worker = F.EngineWorker("r0", batcher, tracker)
        door = F.FrontDoor(F.ReplicaRouter([worker]), tracker)
        await door.start()
        try:
            ws = await WSClient.connect(door.host, door.port)
            with pytest.raises(RuntimeError, match="rejected: engine"):
                await ws.generate([3, 1, 4], 4)
            await ws.close()
        finally:
            await door.stop()
        return worker.load

    assert asyncio.run(scenario()) == 0


def test_serve_cli_selftest_on_cpu(capsys, tmp_path):
    from repro_torch import profile as P
    from repro_torch.launch import serve

    path = tmp_path / "selftest.jsonl"
    assert serve.main(["--smoke", "--device", "cpu", "--serve-http", "--replicas",
                       "2", "--selftest", "--profile", str(path)]) == 0
    out = capsys.readouterr().out
    assert "selftest ok" in out and "2 replicas on cpu" in out
    kinds = {e.entry_point for e in P.read_trace(path)}
    assert kinds == {"serve.decode_step", "serve.prefill", "frontdoor.request"}


def test_pace_us_sleeps_after_every_step(models, solo):
    """``pace_us`` (``--pace-us``) models a device's step time: the worker
    sleeps that long after each engine step, outside the step, so the
    tokens do not change and a request takes at least steps x pace."""
    import time

    _, _, cfg, params = models
    pace_us = 20000.0

    async def scenario():
        tracker = F.SLOTracker()
        worker = F.EngineWorker("r0", ContinuousBatcher(
            params, cfg, n_slots=2, s_max=32, device="cpu"), tracker, pace_us=pace_us)
        door = F.FrontDoor(F.ReplicaRouter([worker]), tracker)
        await door.start()
        try:
            t0 = time.perf_counter()
            status, body = await http_json(door.host, door.port, "POST", "/v1/generate",
                                           {"prompt": [9, 8], "max_new": 4})
            return status, body, time.perf_counter() - t0, worker.steps
        finally:
            await door.stop()

    status, body, secs, steps = asyncio.run(scenario())
    assert status == 200 and body["tokens"] == solo([9, 8], 4)
    assert steps >= 3 and secs >= steps * pace_us * 1e-6
