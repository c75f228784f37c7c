"""Serving launcher: continuous batching over a ternary model on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --requests 8 --slots 4

``--arch`` takes any arch of ``models.registry`` (the dense configs,
``mamba2-780m``, ``zamba2-2.7b``, ``deepseek-v2-236b``, ``grok-1-314b``,
``whisper-large-v3`` and ``llava-next-34b``). As the reference's CLI,
it serves token requests only: whisper as its decoder without cross
attention (the batcher takes no encoder output), llava as its Yi-34B
token stream (image patches enter only ``transformer.forward``).

Runs on ``cuda`` by default and exits with an error without CUDA unless
``--device cpu`` is given (use it with ``--smoke`` on a CPU host). The
serving CiM execution spec is selected with ``--exec-spec`` as
``formulation[/backend[/packing[/flavor]]]``, e.g. ``blocked/cuda``,
``exact/cuda`` (the near-memory baseline) or ``blocked/cuda/bitplane_u8``;
with ``--prepare-weights`` the quantization is folded offline once
(quant.prepare.prepare_for_spec), and a packed spec keeps the stored
planes beside the model (``blocked/cuda_stream/bitplane_u8`` stores
them in the stream kernel's layout 1). On the card the decode step runs
as one captured CUDA graph; its capture time is printed on its own line.
``--loop-decode`` serves the per-slot loop baseline instead (greedy,
eager). The KV cache follows the config's ``quant.cache_dtype`` (the
reference's CLI has no flag for it). ``--profile TRACE.jsonl`` records
one trace event per decode step, fill batch and weight preparation
(``repro_torch.profile``), in the one-shot run and under the front door.

``--serve-http`` starts the async front door instead of the one-shot
batch run (``repro_torch.serve.frontdoor``): an HTTP + WebSocket server
streaming tokens per request, with ``--replicas N`` batchers behind a
least-loaded router and bounded admission (``--queue-limit``, 429 over
it). Every replica runs on the one ``--device``; on the card they step
one at a time under the device's lock. With ``--tp N`` each replica is a
tensor-parallel group of N rank processes (``serve.frontdoor.
tp_replica``: ``replicas x N`` gloo processes on ``--device``, each
making the seeded model and keeping its shard; the door in this process
drives them through a proxy, and its shutdown reaps them); ``/stats``
carries ``mesh {"data": replicas, "model": N}``. ``--selftest`` runs the
front door against itself — stream one request, cancel a second
mid-stream, check ``/stats``, shut down — and exits::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --serve-http --replicas 2 --selftest
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --serve-http --replicas 2 --tp 2 --selftest

``--tp N`` serves tensor-parallel over N ranks (``launch.mesh.spawn_tp``:
N processes of one gloo group, all on ``--device``: on one card they
share it): every rank builds the same seeded params and requests, keeps
its shard (``ContinuousBatcher(mesh=)``: every family), and the parent
prints rank 0's report; the steps run eagerly (gloo's collectives cannot
be captured). ``--compress-tp`` sums the row-parallel partials through
the int8-compressed collective::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --tp 2 \\
        --arch mamba2-780m
    python -m repro_torch.launch.serve --tp 3              # on the card
    python -m repro_torch.launch.serve --tp 2 --arch zamba2-2.7b
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.core.execution import CiMExecSpec
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import ternarize_params
from repro_torch.serve.engine import ContinuousBatcher, Request

#: seconds the ``--tp`` ranks may take before they are killed and the run
#: fails (each collective is also bounded by the group's timeout)
TP_TIMEOUT_S = 1800.0


def parse_exec_spec(text: str) -> CiMExecSpec:
    """``formulation[/backend[/packing[/flavor]]]`` -> CiMExecSpec."""
    parts = text.split("/")
    if len(parts) > 4:
        raise ValueError(f"bad exec spec {text!r} (at most 4 '/'-fields)")
    fields = ("formulation", "backend", "packing", "flavor")
    return CiMExecSpec(**dict(zip(fields, parts)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--exec-spec", default=None,
                    metavar="FORM[/BACKEND[/PACKING[/FLAVOR]]]")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of sampling")
    ap.add_argument("--loop-decode", action="store_true",
                    help="use the legacy per-slot-loop decode baseline "
                         "instead of the fused ragged-position step")
    ap.add_argument("--prepare-weights", action="store_true",
                    help="run quant.prepare.prepare_for_spec once at startup "
                         "(requires --exec-spec)")
    ap.add_argument("--pre-quantize", action="store_true",
                    help="fold ternarization into weights offline")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for a CPU host)")
    ap.add_argument("--profile", default=None, metavar="TRACE.jsonl",
                    help="record per-step timing events (serve.prefill / "
                         "serve.decode_step / serve.prepare, and "
                         "frontdoor.request under --serve-http) to a "
                         "JSON-lines trace file")
    ap.add_argument("--serve-http", action="store_true",
                    help="start the async HTTP/WebSocket front door instead "
                         "of the one-shot batch run; serves until interrupted")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="batcher replicas behind the front-door router, all "
                         "on --device")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8471,
                    help="front-door TCP port (0 = ephemeral)")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="admission cap: total in-flight requests across "
                         "replicas; over it, new requests get 429")
    ap.add_argument("--pace-us", type=float, default=0.0, dest="pace_us",
                    help="modeled per-step device latency in microseconds, "
                         "slept off-GIL in each replica's worker thread after "
                         "its step (0 = off)")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="tensor-parallel degree: serve over N ranks (gloo "
                         "processes on --device, each holding its shard)")
    ap.add_argument("--compress-tp", action="store_true",
                    help="sum the row-parallel partials through the "
                         "int8-compressed collective (requires --tp > 1 and a "
                         "quantized mode)")
    ap.add_argument("--selftest", action="store_true",
                    help="front-door smoke: start --serve-http on an "
                         "ephemeral port, stream one request, cancel a "
                         "second mid-stream, check /stats, shut down "
                         "cleanly, exit 0")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.prepare_weights and not args.exec_spec:
        ap.error("--prepare-weights requires --exec-spec")
    if args.compress_tp and args.tp <= 1:
        ap.error("--compress-tp requires --tp > 1")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.selftest:
        args.serve_http = True
        args.port = 0  # ephemeral: the selftest races no other listener
    if args.tp > 1 and not args.serve_http:
        from repro_torch.launch.mesh import spawn_tp

        for line in spawn_tp(_serve_rank, args.tp, args, timeout=TP_TIMEOUT_S):
            print(line)
        return 0
    cfg, exec_spec = _config(args)
    if args.serve_http:
        # under --tp the ranks make the seeded params themselves
        params = None if args.tp > 1 else _params(cfg, args.seed, device)
        return _serve_http_main(args, cfg, params, exec_spec, device)
    for line in serve_once(args, cfg, _params(cfg, args.seed, device), exec_spec,
                           device):
        print(line)
    return 0


def _config(args):
    """(cfg, exec spec) of the parsed args."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.pre_quantize:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, pre_quantized=True))
    return cfg, parse_exec_spec(args.exec_spec) if args.exec_spec else None


def _params(cfg, seed, device):
    """The seeded params of ``cfg`` on ``device``, ternarized offline
    where ``cfg.quant.pre_quantized`` (``--pre-quantize``)."""
    params = T.init_params(cfg, seed=seed, device=device)
    return ternarize_params(params) if cfg.quant.pre_quantized else params


def _batcher(args, params, cfg, exec_spec, device, mesh=None, profile=None):
    """The parsed args' batcher over ``params`` (on ``mesh``: its shard)."""
    return ContinuousBatcher(
        params, cfg, n_slots=args.slots, s_max=args.s_max, exec_spec=exec_spec,
        temperature=args.temperature, seed=args.seed, fused=not args.loop_decode,
        prepare_weights=args.prepare_weights, device=device, profile=profile,
        mesh=mesh, compress_tp=args.compress_tp)


def _serve_rank(mesh, args):
    """One ``--tp`` rank: the whole seeded model, its shard served; rank
    0's report lines come back to the parent."""
    device = resolve_device(args.device)
    cfg, exec_spec = _config(args)
    lines = serve_once(args, cfg, _params(cfg, args.seed, device), exec_spec, device,
                       mesh)
    return lines if mesh.rank == 0 else None


def _frontdoor_rank(mesh, device, args, cfg, exec_spec):
    """One rank of a ``--serve-http --tp`` replica
    (``tp_replica.TPReplicaGroup``'s ``build``): the seeded params of
    ``cfg``, its shard served by the parsed args' batcher on ``mesh``.
    Under ``--profile`` rank 0's batcher records into a profiler in
    memory, whose events the replica's proxy writes to the door's file."""
    profile = None
    if args.profile and mesh.rank == 0:
        from repro_torch.profile.trace import Profiler

        profile = Profiler()
    return _batcher(args, _params(cfg, args.seed, device), cfg, exec_spec, device,
                    mesh=mesh, profile=profile)


def serve_once(args, cfg, params, exec_spec, device, mesh=None):
    """The one-shot batch run of the parsed args; returns its report
    lines (raises if a request did not finish)."""
    batcher = _batcher(args, params, cfg, exec_spec, device, mesh=mesh,
                       profile=args.profile)
    reqs = [
        Request(i, [1 + (i * 7 + j) % (cfg.vocab - 1) for j in range(1 + i % 4)],
                max_new=2 + i % args.max_new)
        for i in range(args.requests)
    ]
    for r in reqs:
        batcher.submit(r)
    t0 = time.perf_counter()
    batcher.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in reqs)
    stats = batcher.stats()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    if mesh is not None:
        where += (f", tp={mesh.size}" + (" int8-compressed" if args.compress_tp
                                         else "") + " rank 0")
    lines = [f"[serve] {len(reqs)} requests, {toks} tokens, {dt:.3f}s "
             f"({toks / max(dt, 1e-9):.1f} tok/s on {where}), "
             f"{stats['decode_steps']} decode steps, "
             f"{stats['prefill_batches']} prefill batches, "
             f"{stats['host_syncs']} host syncs"]
    if batcher.capture_seconds is not None:
        lines.append(f"[serve] decode step captured as one CUDA graph in "
                     f"{batcher.capture_seconds:.3f}s (warm-up included; part of "
                     f"the {dt:.3f}s above)")
    elif args.loop_decode:
        lines.append(f"[serve] decode step is the per-slot loop baseline, run "
                     f"eagerly on {where}")
    else:
        lines.append(f"[serve] decode step not captured: it runs eagerly on {where}")
    if mesh is not None:
        lines += [f"[serve] request {r.rid}: {r.generated}" for r in reqs]
    if args.profile:
        lines.append(f"[serve] profile: {len(batcher.profiler.events)} trace "
                     f"events -> {args.profile}")
    if not all(r.done for r in reqs):
        raise RuntimeError("some requests did not finish")
    return lines


# ---------------------------------------------------------------------------
# --serve-http: the async front door (repro_torch.serve.frontdoor)
# ---------------------------------------------------------------------------


def build_frontdoor(args, cfg, params, exec_spec, device):
    """(FrontDoor, profiler) for the parsed args: ``args.replicas``
    batchers of ``params`` on ``device``, one router, one tracker, and
    one profiler shared by every replica and the tracker when
    ``args.profile`` is set (it appends per event, so their events
    interleave in one file).

    With ``args.tp > 1`` each replica is a rank group of
    ``serve.frontdoor.tp_replica.TPReplicaGroup``: ``replicas x tp`` gloo
    processes on ``device`` (every rank on it: on one card they share
    it), one ``(1, tp)`` mesh per replica, each rank making the seeded
    params of ``cfg`` itself (``params`` is not read and may be None);
    a replica whose rank raises, dies or overruns ``TP_TIMEOUT_S`` fails
    alone, the door's ``stop()`` reaps every rank, and the tracker
    reports ``mesh {"data": replicas, "model": tp}``, as the
    reference's does."""
    from repro_torch.serve.frontdoor import (
        EngineWorker,
        FrontDoor,
        ReplicaRouter,
        SLOTracker,
    )

    profiler = None
    if args.profile:
        from repro_torch.profile.trace import Profiler

        profiler = Profiler(args.profile)
    tp = args.tp
    group = None
    if tp > 1:
        from repro_torch.serve.frontdoor.tp_replica import TPReplicaGroup

        group = TPReplicaGroup(_frontdoor_rank, (args, cfg, exec_spec),
                               replicas=args.replicas, tp=tp, device=device,
                               timeout=TP_TIMEOUT_S, profiler=profiler)
        batchers = group.replicas
    else:
        batchers = [_batcher(args, params, cfg, exec_spec, device, profile=profiler)
                    for _ in range(args.replicas)]
    tracker = SLOTracker(profiler=profiler, exec_spec=batchers[0].spec_tag,
                         mesh={"data": args.replicas, "model": tp} if tp > 1 else None)
    workers = [EngineWorker(f"r{i}", b, tracker, pace_us=args.pace_us)
               for i, b in enumerate(batchers)]
    router = ReplicaRouter(workers, queue_limit=args.queue_limit)
    return FrontDoor(router, tracker, host=args.host, port=args.port,
                     on_stop=None if group is None else group.close), profiler


async def _selftest_session(door) -> None:
    """The front-door smoke: one full streamed request, one cancelled
    mid-stream, /stats agrees, nothing left in flight."""
    from repro_torch.serve.frontdoor.client import WSClient, http_json

    def check(ok: bool, what) -> None:
        if not ok:
            raise RuntimeError(f"selftest failed: {what}")

    host, port = door.host, door.port
    ws = await WSClient.connect(host, port)
    full = await ws.generate([1, 2, 3], max_new=6)
    check(len(full["tokens"]) == 6 and full["done"]["cancelled"] is False, full)
    part = await ws.generate([4, 5], max_new=32, cancel_after=2)
    check(part["done"]["cancelled"] is True and 2 <= len(part["tokens"]) < 32, part)
    await ws.close()
    status, stats = await http_json(host, port, "GET", "/stats")
    check(status == 200, (status, stats))
    reqs = stats["slo"]["requests"]
    check(reqs["completed"] == 1 and reqs["cancelled"] == 1, reqs)
    check(stats["router"]["in_flight"] == 0, stats["router"])
    for r in stats["router"]["replicas"]:
        check(r["host_syncs"] == r["decode_steps"] + r["prefill_batches"], r)
    print(f"[serve] selftest: streamed {len(full['tokens'])} tokens, "
          f"cancelled after {len(part['tokens'])}, /stats consistent")


async def _serve_http_async(args, cfg, params, exec_spec, device) -> int:
    import asyncio
    import signal

    door, profiler = build_frontdoor(args, cfg, params, exec_spec, device)
    host, port = await door.start()
    n_rep = args.replicas
    tp = f" x tp {args.tp}" if args.tp > 1 else ""
    print(f"[serve] front door on http://{host}:{port} "
          f"({n_rep} replica{'s' if n_rep != 1 else ''}{tp} on {device}, "
          f"queue-limit {args.queue_limit}) — "
          "routes: /healthz /stats /v1/generate /v1/stream", flush=True)
    try:
        if args.selftest:
            await _selftest_session(door)
        else:
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.add_signal_handler(sig, stop.set)
                except NotImplementedError:
                    pass  # non-unix event loops: rely on KeyboardInterrupt
            await stop.wait()
            print("[serve] draining...")
    finally:
        await door.stop()
        if profiler is not None:
            profiler.close()
    loaded = [w.name for w in door.router.workers if w.load]
    if loaded:
        raise RuntimeError(f"replicas {loaded} still have load after stop")
    if profiler is not None:
        print(f"[serve] profile: {len(profiler.events)} trace events -> {args.profile}")
    print("[serve] clean shutdown" + (" — selftest ok" if args.selftest else ""))
    return 0


def _serve_http_main(args, cfg, params, exec_spec, device) -> int:
    import asyncio

    try:
        return asyncio.run(_serve_http_async(args, cfg, params, exec_spec, device))
    except KeyboardInterrupt:
        print("[serve] interrupted")
        return 130


if __name__ == "__main__":
    raise SystemExit(main())
