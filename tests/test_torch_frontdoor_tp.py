"""The front door over tensor-parallel replicas
(``serve.frontdoor.tp_replica``, ``launch.serve --serve-http --tp``): 2
replicas x tp 2, each replica a rank group of gloo processes on the CPU
behind a proxy, against the port's single-device ``generate()``.

The reference builds the same door from one ``(1, tp)`` JAX mesh per
replica (``repro/launch/serve.py`` ``build_frontdoor``); its own tests
run no TP replica behind the door, so the port is held against its own
single device: smollm-135m smoke at f32, seed-0 params made in every
rank, mode "off" and cim (per-row activation scales). One rank group
serves each mode for the module. The contract:

  * concurrent streams over both replicas == ``generate()``, one host
    sync per decode step and fill batch in rank 0, and ``/stats``'
    ``mesh`` {"data": 2, "model": 2};
  * a cancel mid-stream frees the slot on every rank of its replica
    (``stats()["rank_slots"]``), and the replica counts it;
  * a killed rank fails its replica alone: its stream ends with an
    error frame, the router routes around it, ``door.stop()`` returns
    within its timeout and no rank process is left;
  * the launcher's ``--serve-http --tp 2 --selftest`` exits 0, with one
    trace file holding the door's and both replicas' events.
"""
import asyncio
import multiprocessing
import time

import pytest

import torch_tp_ranks as R
from repro_torch.launch import serve as launcher
from repro_torch.models import transformer as T
from repro_torch.serve import frontdoor as F
from repro_torch.serve.engine import generate
from repro_torch.serve.frontdoor import tp_replica
from repro_torch.serve.frontdoor.client import WSClient, http_json
from torch_threads import one_thread  # noqa: F401

PROMPTS = [[3, 1, 4], [9, 8], [2, 7, 1, 8], [6], [5, 5, 5], [1, 2]]
MAX_NEWS = [4, 6, 3, 5, 4, 6]
REPLICAS, TP = 2, 2
GROUP_TIMEOUT = 120.0


def _group(mode):
    return tp_replica.TPReplicaGroup(R.door_batcher, (mode,), replicas=REPLICAS, tp=TP,
                                     device="cpu", timeout=GROUP_TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def groups():
    made = {}
    try:
        for mode in ("off", "cim"):
            made[mode] = _group(mode)
        yield made
    finally:
        for g in made.values():
            g.close()


@pytest.fixture(scope="module")
def solo():
    """The port's single-device greedy generate() of a prompt, memoized."""
    memo, params = {}, {}

    def tokens(mode, prompt, max_new):
        key = (mode, tuple(prompt), max_new)
        if key not in memo:
            cfg = R.door_cfg(mode)
            if mode not in params:
                params[mode] = T.init_params(cfg, seed=0, device="cpu")
            memo[key] = generate(params[mode], [prompt], cfg, max_new=max_new,
                                 s_max=32, device="cpu")[0].tolist()
        return memo[key]

    return tokens


def _door(group, on_stop=None):
    tracker = F.SLOTracker(mesh={"data": REPLICAS, "model": TP})
    workers = [F.EngineWorker(rep.name, rep, tracker) for rep in group.replicas]
    return F.FrontDoor(F.ReplicaRouter(workers, queue_limit=16), tracker,
                       on_stop=on_stop)


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_streams_equal_generate(groups, solo, mode):
    async def scenario():
        door = _door(groups[mode])
        await door.start()
        try:
            conns = [await WSClient.connect(door.host, door.port) for _ in PROMPTS]
            results = await asyncio.gather(*[
                ws.generate(p, m) for ws, p, m in zip(conns, PROMPTS, MAX_NEWS)])
            for ws in conns:
                await ws.close()
            _, stats = await http_json(door.host, door.port, "GET", "/stats")
            return results, stats
        finally:
            await door.stop()

    results, stats = asyncio.run(scenario())
    for res, p, m in zip(results, PROMPTS, MAX_NEWS):
        assert res["tokens"] == solo(mode, p, m), (mode, p)
    assert {r["done"]["replica"] for r in results} == {"r0", "r1"}
    assert stats["mesh"] == {"data": REPLICAS, "model": TP}
    for r in stats["router"]["replicas"]:
        assert r["tp"] == TP and r["failed"] is None
        assert r["decode_steps"] > 0
        assert r["host_syncs"] == r["decode_steps"] + r["prefill_batches"], r
        # plain versions on the CPU: no kernel launched in any rank
        assert not any(r["launches"].values()), r["launches"]
        assert r["rank_slots"] == [[None, None]] * TP
    assert stats["slo"]["requests"]["completed"] == len(PROMPTS)
    assert [rep.alive() for rep in groups[mode].replicas] == [[0, 1], [2, 3]]


def test_cancel_frees_the_slot_on_every_rank(groups, solo):
    async def scenario():
        door = _door(groups["cim"])
        await door.start()
        try:
            w1 = await WSClient.connect(door.host, door.port)
            w2 = await WSClient.connect(door.host, door.port)
            victim, survivor = await asyncio.gather(
                w1.generate([3, 1, 4], 20, cancel_after=2), w2.generate([9, 8], 8))
            await w1.close()
            await w2.close()
            _, stats = await http_json(door.host, door.port, "GET", "/stats")
            return victim, survivor, stats
        finally:
            await door.stop()

    victim, survivor, stats = asyncio.run(scenario())
    assert victim["done"]["cancelled"] is True and 2 <= len(victim["tokens"]) < 20
    assert victim["tokens"] == solo("cim", [3, 1, 4], 20)[:len(victim["tokens"])]
    assert survivor["tokens"] == solo("cim", [9, 8], 8)
    assert victim["done"]["replica"] != survivor["done"]["replica"]
    replicas = {r["name"]: r for r in stats["router"]["replicas"]}
    hit = replicas[victim["done"]["replica"]]
    assert (hit["cancelled"], hit["completed"]) == (1, 0)
    # the cancel reached every rank: no rank's slot table holds the request
    assert len(hit["rank_slots"]) == TP
    assert all(victim["rid"] not in slots for slots in hit["rank_slots"])
    assert stats["slo"]["requests"]["cancelled"] == 1


def test_killed_rank_fails_its_replica_alone(solo):
    group = _group("off")
    children = set(group.procs)

    async def scenario():
        door = _door(group, on_stop=group.close)
        await door.start()
        stop_s = None
        try:
            streams = {}
            for prompt in ([3, 1, 4], [9, 8]):
                ws = await WSClient.connect(door.host, door.port)
                await ws.send({"type": "generate", "prompt": prompt, "max_new": 24})
                admitted = await ws.recv()
                first = await ws.recv()
                assert admitted["type"] == "admitted" and first["type"] == "token"
                streams[admitted["replica"]] = (ws, prompt, [first["token"]])
            victim = next(rep for rep in group.replicas if rep.name == "r1")
            victim.procs[1].kill()
            outcome = {}
            for name, (ws, prompt, toks) in streams.items():
                while True:
                    m = await ws.recv()
                    if m["type"] == "token":
                        toks.append(m["token"])
                        continue
                    outcome[name] = (m, toks)
                    break
                await ws.close()
            # the router passes the failed replica by; a client that
            # leaves its connection open does not hold up the stop
            ws = await WSClient.connect(door.host, door.port)
            after = [await ws.generate([6], 3) for _ in range(2)]
            _, stats = await http_json(door.host, door.port, "GET", "/stats")
        finally:
            t0 = time.monotonic()
            await door.stop()
            stop_s = time.monotonic() - t0
        return outcome, after, stats, stop_s

    try:
        outcome, after, stats, stop_s = asyncio.run(scenario())
    finally:
        group.close()
    dead_msg, _ = outcome["r1"]
    assert dead_msg["type"] == "error" and dead_msg["error"] == "engine"
    assert "replica r1" in dead_msg["detail"]
    ok_msg, ok_toks = outcome["r0"]
    assert ok_msg["type"] == "done" and ok_toks == solo("off", [3, 1, 4], 24)
    for res in after:
        assert res["done"]["replica"] == "r0" and res["tokens"] == solo("off", [6], 3)
    r1 = next(r for r in stats["router"]["replicas"] if r["name"] == "r1")
    assert r1["failed"] and r1["draining"] and r1["load"] == 0
    assert stop_s < tp_replica.STOP_TIMEOUT_S + 10
    assert group.alive() == []
    assert not children & set(multiprocessing.active_children())


def test_launcher_serve_http_tp_selftest(capsys, monkeypatch, tmp_path):
    from repro_torch import profile as P

    monkeypatch.setattr(launcher, "TP_TIMEOUT_S", GROUP_TIMEOUT)
    path = tmp_path / "door.jsonl"
    assert launcher.main(["--smoke", "--device", "cpu", "--serve-http", "--replicas",
                          "2", "--tp", "2", "--selftest", "--profile", str(path)]) == 0
    out = capsys.readouterr().out
    assert "selftest ok" in out and "2 replicas x tp 2 on cpu" in out
    events = P.read_trace(path)
    meshes = {(e.entry_point, tuple(sorted(e.mesh.items()))) for e in events}
    assert meshes == {("serve.decode_step", (("data", 1), ("model", 2))),
                      ("serve.prefill", (("data", 1), ("model", 2))),
                      ("frontdoor.request", (("data", 2), ("model", 2)))}
    assert sum(e.entry_point == "frontdoor.request" for e in events) == 2
