"""Meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

The reference's mesh is a grid of devices that one program shards over.
Here a :class:`TPMesh` is one rank's view of a ``(data, model)`` grid of
gloo ranks, under the reference's axis names ``("data", "model")``: its
model group (the ranks of its row, which split the weights) and its data
group (the ranks of its column, which split the batch), its coordinate
on each axis and the sizes. Global rank ``d * model + m`` sits at
``(d, m)``, the reference's row-major device order. Each rank is a
process of its own: :func:`spawn_mesh` starts ``data * model`` of them
and runs a function on each (:func:`spawn_tp` is its ``(1, tp)`` case),
and :func:`make_mesh` / :func:`make_tp_mesh` set up or join the groups
from inside one.

:func:`make_production_mesh` is the reference's production grid as
sizes only (:class:`AbstractMesh`: no process behind it), for the
sharding rules and :func:`mesh_batch_divisor`; :func:`make_smoke_mesh`
is the reference's test mesh over the ranks this process can see.
:func:`dry_mesh` makes rank 0 of an abstract grid, a :class:`TPMesh`
whose groups are ``dist.collectives.DryGroup`` s, under which the
collectives move nothing (the dry run, ``launch/dryrun.py``).

The backend is gloo on the CPU and on the card alike: NCCL refuses two
ranks on one GPU, and on one H100 the ranks share ``cuda:0``. Nothing
here picks a device; the function a rank runs does.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.dist.collectives import DryGroup
# the reference's launch.mesh exports it; the data axis's rules own it
from repro_torch.dist.sharding import mesh_batch_divisor  # noqa: F401

AXIS_NAMES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """One rank's view of a ``(data, model)`` grid of gloo ranks.

    The model axis: the gloo ``group`` of the rank's row (``None`` for a
    replica this process is not in, see :func:`make_replica_meshes`),
    this process's ``rank`` in it, its ``size`` and the global ``ranks``
    it spans. The data axis: ``data`` rows, this process's row
    ``data_rank``, and ``data_group`` / ``data_ranks``, the ranks of its
    column (``None`` / ``()`` when ``data`` is 1). A tensor-parallel mesh
    has data 1."""

    group: Any
    rank: int
    size: int
    ranks: Tuple[int, ...] = ()
    axis_names: Tuple[str, ...] = AXIS_NAMES
    data: int = 1
    data_rank: int = 0
    data_group: Any = None
    data_ranks: Tuple[int, ...] = ()

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.size}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh as sizes and axis names only: no process stands behind it
    (the reference's production grid, which no single host spawns). It
    serves the sharding rules (``param_specs(axis_sizes=mesh.shape)``)
    and :func:`mesh_batch_divisor`; :func:`spawn_mesh` refuses it."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def dry_mesh(mesh: AbstractMesh) -> TPMesh:
    """Rank 0 of ``mesh`` (an :class:`AbstractMesh`) as a :class:`TPMesh`
    whose groups are ``DryGroup`` s, one for each axis (the data axis's
    spans "pod" and "data"). The model runs on it as on a real rank's
    mesh; its collectives return tensors of the right shape, are counted
    and move nothing (``dist.collectives``)."""
    sizes = mesh.shape
    model = int(sizes.get("model", 1))
    data = int(sizes.get("pod", 1)) * int(sizes.get("data", 1))
    return TPMesh(DryGroup(model, "model"), 0, model, tuple(range(model)),
                  AXIS_NAMES, data, 0, DryGroup(data, "data") if data > 1 else None,
                  tuple(range(0, data * model, model)))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh as sizes: ``(16, 16)`` over
    ``("data", "model")``, or ``(2, 16, 16)`` over ``("pod", "data",
    "model")``."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), AXIS_NAMES)


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def make_tp_mesh(tp: int, *, rank: Optional[int] = None,
                 init_method: Optional[str] = None,
                 timeout: float = 600.0) -> TPMesh:
    """The calling rank's mesh of a ``tp``-rank gloo group. Joins the
    default group if this process has one (its size must be ``tp``);
    else initializes it: at ``init_method`` (a ``file://`` or ``tcp://``
    store) as ``rank``, from the environment (``env://``: RANK,
    MASTER_ADDR, MASTER_PORT) when neither is given, and for ``tp == 1``
    on an in-memory store. ``timeout`` bounds every collective."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if not dist.is_initialized():
        if tp == 1 and init_method is None:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=_timeout(timeout))
        else:
            if rank is None:
                rank = int(os.environ["RANK"])
            dist.init_process_group("gloo", init_method=init_method or "env://",
                                    rank=rank, world_size=tp,
                                    timeout=_timeout(timeout))
    world = dist.get_world_size()
    if world != tp:
        raise ValueError(f"tp={tp} but this process's group has {world} ranks")
    return TPMesh(dist.group.WORLD, dist.get_rank(), tp, tuple(range(tp)))


def make_mesh(data: int, model: int, *, rank: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout: float = 600.0) -> TPMesh:
    """The calling rank's view of a ``(data, model)`` grid of gloo ranks.
    Sets up or joins a ``data * model``-rank default group as
    :func:`make_tp_mesh` does, then makes every row's model group and
    every column's data group (each subgroup is made by all ranks, in
    one order). ``make_mesh(1, tp)`` is ``make_tp_mesh(tp)``."""
    if data < 1 or model < 1:
        raise ValueError(f"need data >= 1 and model >= 1, got data={data} "
                         f"model={model}")
    if data == 1:
        return make_tp_mesh(model, rank=rank, init_method=init_method,
                            timeout=timeout)
    world = make_tp_mesh(data * model, rank=rank, init_method=init_method,
                         timeout=timeout)
    me = world.rank
    d_me, m_me = divmod(me, model)
    model_group = data_group = None
    for d in range(data):
        ranks = list(range(d * model, (d + 1) * model))
        group = dist.new_group(ranks, backend="gloo")
        if d == d_me:
            model_group = group
    for m in range(model):
        ranks = list(range(m, data * model, model))
        group = dist.new_group(ranks, backend="gloo")
        if m == m_me:
            data_group = group
    return TPMesh(model_group, m_me, model,
                  tuple(range(d_me * model, (d_me + 1) * model)), AXIS_NAMES,
                  data, d_me, data_group, tuple(range(m_me, data * model, model)))


def make_smoke_mesh(*, timeout: float = 600.0) -> TPMesh:
    """The reference's test mesh over the ranks this process can see: a
    ``(n // 2, 2)`` grid over the ``n`` ranks of its default group when
    ``n >= 4``, else ``(1, 1)`` (a process with no group gets a 1-rank
    one: one card is ``(1, 1)``). The reference's ``(1, 1)`` over the
    first of 2 or 3 devices has no counterpart for the other ranks of a
    2- or 3-rank group, so those raise."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n >= 4:
        if n % 2:
            raise ValueError(f"a smoke mesh over {n} ranks needs an even count")
        return make_mesh(n // 2, 2, timeout=timeout)
    if n != 1:
        raise ValueError(f"a smoke mesh is (1, 1) below 4 ranks; this group has {n}")
    return make_tp_mesh(1, timeout=timeout)


def make_replica_meshes(replicas: int, tp: int) -> List[TPMesh]:
    """One ``tp``-rank mesh per replica, the rows of the ``(replicas,
    tp)`` grid of ranks (:func:`repro_torch.dist.sharding.
    replica_device_groups` places them on devices). Every rank of a
    ``replicas * tp``-rank default group calls it (each subgroup is made
    by all ranks); a mesh whose row the caller is not in has
    ``group=None`` and ``rank=-1``."""
    if replicas < 1 or tp < 1:
        raise ValueError(f"need replicas >= 1 and tp >= 1, got "
                         f"replicas={replicas} tp={tp}")
    world = dist.get_world_size()
    if world != replicas * tp:
        raise ValueError(f"{replicas} replicas x tp={tp} need {replicas * tp} "
                         f"ranks, the group has {world}")
    me = dist.get_rank()
    meshes = []
    for r in range(replicas):
        ranks = tuple(range(r * tp, (r + 1) * tp))
        group = dist.new_group(list(ranks), backend="gloo")
        inside = me in ranks
        meshes.append(TPMesh(group if inside else None,
                             ranks.index(me) if inside else -1, tp, ranks))
    return meshes


# ---------------------------------------------------------------------------
# Spawning the ranks
# ---------------------------------------------------------------------------


def _to_host(obj):
    """Tensors in a rank's result -> numpy arrays (a tensor sent through a
    queue would be shared memory that dies with its rank)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, data: int, model: int, store: str, fn: Callable,
               args: Sequence, results, timeout: float, threads: int) -> None:
    torch.set_num_threads(threads)
    try:
        mesh = make_mesh(data, model, rank=rank, init_method=store, timeout=timeout)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", _to_host(out) if rank == 0 else None))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, "error", traceback.format_exc()))
        raise


def spawn_tp(fn: Callable, tp: int, *args, timeout: float = 600.0,
             threads: Optional[int] = None):
    """Run ``fn(mesh, *args)`` on ``tp`` new processes, one per rank of a
    gloo group, and return rank 0's result: :func:`spawn_mesh` over a
    ``(1, tp)`` grid."""
    return spawn_mesh(fn, 1, tp, *args, timeout=timeout, threads=threads)


def spawn_mesh(fn: Callable, data: int, model: int, *args, timeout: float = 600.0,
               threads: Optional[int] = None):
    """Run ``fn(mesh, *args)`` on ``data * model`` new processes, one per
    rank of a ``(data, model)`` grid of gloo ranks (:func:`make_mesh`),
    and return rank 0's result (tensors in it come back as numpy
    arrays). ``fn`` and ``args`` are pickled: ``fn`` must be a
    module-level function. The group meets at a ``file://`` store in a
    temporary directory (no port to collide with other groups on the
    host); ``threads`` sets each rank's torch threads (default: half the
    host's cores over the ranks; intra-op threads that outnumber the
    cores spin against the other ranks' collectives).

    Every rank must finish within ``timeout`` seconds, which also bounds
    each collective: a rank that raises, dies or overruns ends every
    rank (killed) and raises here, RuntimeError or TimeoutError."""
    if not (isinstance(data, int) and isinstance(model, int)):
        raise TypeError(f"spawn_mesh takes the grid's sizes, got {data!r} x {model!r}")
    if data < 1 or model < 1:
        raise ValueError(f"need data >= 1 and model >= 1, got data={data} "
                         f"model={model}")
    tp = data * model
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // (2 * tp))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tp-store-") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, data, model, store, fn, args, results,
                                   timeout, threads))
                 for r in range(tp)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done, failure = {}, None
        try:
            while len(done) < tp and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{data}x{model} ranks did not finish within {timeout:.0f} s "
                        f"(finished: {sorted(done)})")
                try:
                    rank, status, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and not p.is_alive()]
                    if dead:
                        # a rank that died without reporting (killed, crashed);
                        # give a report in flight a moment to arrive first
                        try:
                            rank, status, payload = results.get(timeout=2.0)
                        except queue_mod.Empty:
                            failure = (f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no report")
                            break
                    else:
                        continue
                if status == "ok":
                    done[rank] = payload
                else:
                    failure = f"rank {rank} failed:\n{payload}"
        finally:
            for p in procs:
                if failure is not None or len(done) < tp:
                    p.kill()
                p.join(timeout=30)
            results.close()
        if failure is not None:
            raise RuntimeError(failure)
    return done[0]
