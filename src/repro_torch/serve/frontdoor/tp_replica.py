"""A front-door replica that is a tensor-parallel rank group.

The reference has no counterpart file. There, ``build_frontdoor`` carves
one ``(1, tp)`` JAX ``Mesh`` per replica (``make_replica_meshes``) and
hands it to the replica's batcher: one program shards over the mesh's
devices, and the front door drives a TP replica as it drives any other
batcher. Here a mesh is a gloo process group (``launch.mesh``): a TP
batcher runs in lockstep on ``tp`` processes, each on its shard, and
every rank must apply the same submits and cancels before the same step.
So a TP replica is a group of rank processes, and the front door, which
stays in the parent process, drives a proxy of it.

:class:`TPReplicaGroup` starts ``replicas * tp`` spawn-context processes
of one gloo world, which meet at a ``file://`` store in a temporary
directory. Each rank calls ``launch.mesh.make_replica_meshes(replicas,
tp)``, keeps its row, and builds its batcher with ``build(mesh, device,
*args)`` (a module-level function: it is pickled) on the device that
``dist.sharding.replica_device_groups`` gives it: every rank sits on the
one ``device`` (on one card they all share it), as the launcher's
``--device`` says. Then it serves commands until it is told to stop.

:class:`TPReplica` (``group.replicas[i]``) gives ``EngineWorker`` the
batcher interface the worker reads: ``submit``, ``cancel``, ``step``,
``stats()``, ``queue``, ``slot_req``, ``n_slots``, ``device``, and the
``Request`` objects' ``generated`` and ``done``. ``submit`` checks the
prompt here, as a batcher does; ``submit`` and ``cancel`` only queue an
operation, and ``step`` sends the queued operations with the step
command to every rank of the replica. Each rank applies them in order
and steps; then the ranks gather what each holds (one
``all_gather_object`` over the replica's group), rank 0 fails the
replica unless they all agree, and returns what changed: the new tokens
per request, the requests that ended (cancelled, truncated), the queue,
the slot table, ``stats()`` with the rank's kernel launch counts, and,
where its batcher has a profiler, the step's trace events, which the
proxy records into the door's profiler. So a cancel takes effect at the
next step boundary on every rank, and ``stats()["rank_slots"]`` holds
every rank's slot table.

The commands go from the parent into each rank's own queue, not to rank
0 for a broadcast over the group: a rank waiting in a broadcast for the
next request would meet the group's collective timeout whenever the door
idled that long, and a queue waits without one (a waiting rank checks
each second that the parent lives, and exits with it). The parent puts
each command into every rank's queue of the replica before it waits, so
the ranks apply the same operations before the same step.

**No device lock.** ``worker.device_lock`` serializes the replicas of
one process, which share its CUDA context: there a capture is
invalidated by CUDA work from another thread, and the kernel wrappers'
launch counters are process-wide. The ranks are processes of their own,
each with its own context and counters, and a TP batcher captures
nothing (gloo's collectives cannot be captured, so its steps run
eagerly). The card time-slices the contexts, as it does any two
processes' work. So the worker takes no lock for a TP replica
(``remote``), and the parent process touches no CUDA at all.

**Failure.** A rank that raises (its traceback comes back), dies, or
does not answer a command within ``timeout`` seconds fails its replica:
every rank of the replica is killed and reaped, and ``step`` raises, so
``EngineWorker`` ends the replica's in-flight requests with an error
frame and the router sends it nothing more. Nothing falls back to a
single device. :meth:`TPReplicaGroup.close` stops the ranks that are
left (a stop command, then a kill after ``STOP_TIMEOUT_S``) and reaps
every process; ``FrontDoor(on_stop=group.close)`` calls it in ``stop()``.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.serve.engine import Request, check_prompt

#: seconds :meth:`TPReplicaGroup.close` waits for the ranks to exit after
#: the stop command before it kills them
STOP_TIMEOUT_S = 30.0
# how often a waiting parent checks its ranks, and a waiting rank its parent
_POLL_S = 0.2
_RANK_POLL_S = 1.0


# ---------------------------------------------------------------------------
# A rank
# ---------------------------------------------------------------------------


def _rank_main(world_rank: int, replicas: int, tp: int, store: str, device: str,
               build: Callable, args: Sequence, commands, replies, timeout: float,
               threads: int) -> None:
    torch.set_num_threads(threads)
    try:
        from repro_torch.launch.mesh import make_replica_meshes

        dist.init_process_group("gloo", init_method=store, rank=world_rank,
                                world_size=replicas * tp,
                                timeout=datetime.timedelta(seconds=timeout))
        mesh = make_replica_meshes(replicas, tp)[world_rank // tp]
        batcher = build(mesh, torch.device(device), *args)
        _serve_commands(mesh, batcher, commands, replies)
    except BaseException:  # reported to the parent, which fails the replica
        replies.put(("error", world_rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _view(batcher, active: int, tokens, ended) -> Dict[str, Any]:
    from repro_torch.serve.graph import launch_counted

    stats = dict(batcher.stats(),
                 launches={fn.__name__: fn.launches for fn in launch_counted()})
    return {"active": active, "tokens": tokens, "ended": ended,
            "queue": [r.rid for r in batcher.queue],
            "slots": [None if r is None else r.rid for r in batcher.slot_req],
            "stats": stats}


def _serve_commands(mesh, batcher, commands, replies) -> None:
    """A rank's loop: apply each command's operations, step, agree with
    the other ranks; rank 0 answers the parent."""
    lead = mesh.rank == 0
    parent = mp.parent_process()
    reqs: Dict[int, Request] = {}
    sent: Dict[int, int] = {}
    if lead:
        replies.put(("ready", dict(
            _view(batcher, 0, {}, {}), device=str(batcher.device),
            n_slots=batcher.n_slots, s_max=batcher.s_max, vocab=batcher.cfg.vocab,
            spec_tag=batcher.spec_tag, ranks=list(mesh.ranks))))
    while True:
        try:
            cmd = commands.get(timeout=_RANK_POLL_S)
        except queue_mod.Empty:
            if parent is not None and not parent.is_alive():
                return
            continue
        if cmd[0] == "stop":
            return
        for op in cmd[1]:
            if op[0] == "submit":
                _, rid, prompt, max_new = op
                reqs[rid], sent[rid] = Request(rid, list(prompt), max_new=max_new), 0
                batcher.submit(reqs[rid])
            else:
                batcher.cancel(op[1])
        active = batcher.step()
        tokens, ended = {}, {}
        for rid, req in list(reqs.items()):
            if len(req.generated) > sent[rid]:
                tokens[rid] = [int(t) for t in req.generated[sent[rid]:]]
                sent[rid] = len(req.generated)
            if req.done:
                ended[rid] = (req.cancelled, req.truncated)
                del reqs[rid], sent[rid]
        view = _view(batcher, active, tokens, ended)
        views: List[Any] = [None] * mesh.size
        dist.all_gather_object(views, view, group=mesh.group)
        if not lead:
            continue
        differ = [r for r, v in enumerate(views) if v != view]
        if differ:
            raise RuntimeError(f"ranks {differ} of the replica diverged from rank 0: "
                               f"{views}")
        events = []
        if batcher.profiler is not None:
            events = list(batcher.profiler.events)
            batcher.profiler.events.clear()
        replies.put(("step", dict(view, rank_slots=[v["slots"] for v in views],
                                  events=events)))


# ---------------------------------------------------------------------------
# The parent's proxy of one replica
# ---------------------------------------------------------------------------


class TPReplica:
    """One TP replica's rank processes, driven as a batcher (see the
    module docstring). ``submit`` and ``cancel`` run on the event loop,
    ``step`` in the worker's thread."""

    #: EngineWorker: the steps run in the rank processes, not in this one
    remote = True

    def __init__(self, name: str, procs: List, ranks: Sequence[int], commands: List,
                 replies, timeout: float, profiler=None):
        self.name = name
        self.ranks = tuple(ranks)
        self.timeout = float(timeout)
        self.profiler = profiler
        self.failed: Optional[str] = None
        self.procs, self._commands, self._replies = procs, commands, replies
        self._lock = threading.Lock()
        self._ops: List[tuple] = []
        self._reqs: Dict[int, Request] = {}
        self.queue: List[Request] = []
        self.slot_req: List[Optional[Request]] = []
        self._stats: Dict[str, Any] = {}
        self.rank_slots: List[list] = []

    @property
    def tp(self) -> int:
        return len(self.procs)

    def _ready(self) -> None:
        info = self._wait("start-up")
        self.device = torch.device(info["device"])
        self.n_slots, self.s_max = info["n_slots"], info["s_max"]
        self.vocab, self.spec_tag = info["vocab"], info["spec_tag"]
        self.slot_req = [None] * self.n_slots
        self._stats = info["stats"]
        self.rank_slots = [info["slots"]] * self.tp

    # -- the batcher interface ------------------------------------------------

    def submit(self, req: Request) -> None:
        check_prompt(req.prompt, self.vocab, self.s_max)
        with self._lock:
            self._reqs[req.rid] = req
            self._ops.append(("submit", req.rid, list(req.prompt), req.max_new))
            self.queue = self.queue + [req]

    def cancel(self, request_id: int) -> bool:
        """Withdraw ``request_id`` on every rank before the next step;
        False when it is not in flight here. The request ends (``done``,
        ``cancelled``) when that step's answer comes back."""
        with self._lock:
            if request_id not in self._reqs:
                return False
            self._ops.append(("cancel", request_id))
            return True

    def step(self) -> int:
        """Send the queued operations and one step to every rank; apply
        rank 0's answer. Raises (and the replica stays failed) when a rank
        raised, died or overran ``timeout``."""
        if self.failed is not None:
            raise RuntimeError(f"replica {self.name} failed: {self.failed}")
        with self._lock:
            ops, self._ops = self._ops, []
        for q in self._commands:
            q.put(("step", ops))
        answer = self._wait("a step")
        with self._lock:
            for rid, toks in answer["tokens"].items():
                self._reqs[rid].generated.extend(toks)
            for rid, (cancelled, truncated) in answer["ended"].items():
                req = self._reqs.pop(rid)
                req.cancelled, req.truncated = cancelled, truncated
                req.done = True
            later = [self._reqs[op[1]] for op in self._ops if op[0] == "submit"]
            self.queue = [self._reqs[rid] for rid in answer["queue"]] + later
            self.slot_req = [None if rid is None else self._reqs[rid]
                             for rid in answer["slots"]]
            self._stats, self.rank_slots = answer["stats"], answer["rank_slots"]
        if self.profiler is not None:
            for event in answer["events"]:
                self.profiler.record(event)
        return answer["active"]

    def stats(self) -> Dict[str, Any]:
        """Rank 0's ``stats()`` (every rank's agreed) with its kernel
        launch counts, the degree, the world ranks and every rank's slot
        table (a request id or None per slot)."""
        return dict(self._stats, tp=self.tp, ranks=list(self.ranks),
                    rank_slots=self.rank_slots)

    # -- the ranks ------------------------------------------------------------

    def alive(self) -> List[int]:
        """The world ranks of this replica whose process is alive."""
        return [r for r, p in zip(self.ranks, self.procs) if p.is_alive()]

    def _wait(self, what: str):
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                kind, *payload = self._replies.get(timeout=_POLL_S)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in zip(self.ranks, self.procs)
                        if not p.is_alive()]
                if dead:
                    try:  # a report in flight arrives first
                        kind, *payload = self._replies.get(timeout=2.0)
                    except queue_mod.Empty:
                        self._fail(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                   f"during {what}", RuntimeError)
                elif time.monotonic() > deadline:
                    self._fail(f"no answer to {what} within {self.timeout:.0f} s",
                               TimeoutError)
                else:
                    continue
            if kind == "error":
                self._fail(f"rank {payload[0]} failed during {what}:\n{payload[1]}",
                           RuntimeError)
            return payload[0]

    def _fail(self, what: str, exc_type) -> None:
        self.failed = what
        self._kill()
        raise exc_type(f"replica {self.name}: {what}")

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            if p.pid is not None:
                p.join(timeout=10)

    def _stop(self) -> None:
        if self.failed is None:
            for q in self._commands:
                q.put(("stop",))


# ---------------------------------------------------------------------------
# The group
# ---------------------------------------------------------------------------


class TPReplicaGroup:
    """``replicas`` TP replicas of ``tp`` rank processes each, one gloo
    world (see the module docstring). ``build(mesh, device, *args)``
    makes a rank's batcher on ``device``; ``timeout`` bounds the
    start-up, every command and every collective; ``threads`` sets each
    rank's torch threads
    (default: half the host's cores over the ranks); ``profiler``
    records the replicas' trace events. Raises, with every process
    reaped, when a rank fails to start."""

    def __init__(self, build: Callable, args: Sequence = (), *, replicas: int, tp: int,
                 device, timeout: float = 600.0, threads: Optional[int] = None,
                 profiler=None):
        from repro_torch.dist.sharding import replica_device_groups

        n = replicas * tp
        # every rank on the one device: its visible count does not bound them
        grid = replica_device_groups(replicas, tp, devices=[torch.device(device)] * n)
        if threads is None:
            threads = max(1, (os.cpu_count() or 1) // (2 * n))
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="tp-door-")
        store = "file://" + os.path.join(self._tmp.name, "store")
        self.replicas: List[TPReplica] = []
        self.procs = []
        self._queues = []
        self._closed = False
        for r in range(replicas):
            replies = ctx.Queue()
            commands = [ctx.Queue() for _ in range(tp)]
            ranks = list(range(r * tp, (r + 1) * tp))
            procs = [ctx.Process(target=_rank_main, daemon=True, args=(
                w, replicas, tp, store, str(grid[r][i]), build, tuple(args),
                commands[i], replies, timeout, threads))
                for i, w in enumerate(ranks)]
            self.procs += procs
            self._queues += commands + [replies]
            self.replicas.append(TPReplica(f"r{r}", procs, ranks, commands, replies,
                                           timeout, profiler))
        try:
            for p in self.procs:
                p.start()
            for rep in self.replicas:
                rep._ready()
        except BaseException:
            for rep in self.replicas:
                rep._kill()
            self.close()
            raise

    def alive(self) -> List[int]:
        """The world ranks whose process is alive."""
        return [r for rep in self.replicas for r in rep.alive()]

    def close(self) -> None:
        """Stop every rank that is left, kill those that do not exit
        within ``STOP_TIMEOUT_S``, and reap every process (idempotent)."""
        if self._closed:
            return
        self._closed = True
        for rep in self.replicas:
            rep._stop()
        deadline = time.monotonic() + STOP_TIMEOUT_S
        started = [p for p in self.procs if p.pid is not None]
        while any(p.is_alive() for p in started) and time.monotonic() < deadline:
            # drain what the ranks still send, so that none blocks in its
            # queue's flush at exit
            for rep in self.replicas:
                try:
                    while True:
                        rep._replies.get_nowait()
                except (queue_mod.Empty, OSError, ValueError):
                    pass
            for p in started:
                p.join(timeout=0.05)
        for p in self.procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(timeout=10)
        for q in self._queues:
            q.cancel_join_thread()
            q.close()
        self._tmp.cleanup()
