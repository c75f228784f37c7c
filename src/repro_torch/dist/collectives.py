"""Explicit collectives over a ``torch.distributed`` process group (port
of ``repro/dist/collectives.py``).

The reference names its collectives inside ``shard_map`` programs; here
each rank is a process of a gloo group (``launch.mesh``), and every
cross-rank reduction of the port goes through this module:

  * :func:`all_reduce` and :func:`all_gather`, the exact primitives of
    tensor-parallel serving (the gather is a copy, so exact for every
    dtype);
  * :func:`tp_allreduce`, the row-parallel partial-sum reduction, exact
    or through :func:`compressed_psum_int8` (a shared scale from a MAX
    all-reduce of the local amax, stochastic rounding from an explicit
    ``torch.Generator``, an int32 sum, the f32 decode);
  * :func:`mean_grads_int8`, the same primitive as a data-parallel
    gradient mean (pinned; the data-parallel step does not use it, as
    the reference's ``train_step`` does not);
  * :func:`bucket_mean`, the data-parallel step's exact gradient mean:
    every tensor in one flat f32 bucket, one all-reduce;
  * :func:`copy`, :func:`gather` and :func:`reduce`, the model axis of
    tensor-parallel training: the same collectives as autograd functions,
    each with the adjoint its place in the model needs (below).

The three autograd functions follow one rule: every replicated tensor
that feeds a rank-partial computation enters it through :func:`copy`
(identity forward, the sum of the ranks' partial gradients backward), a
rank's part of a replicated tensor is made whole by :func:`gather` (an
all-gather forward, the rank's slice of the replicated gradient
backward), and the ranks' partial sums are added by :func:`reduce` (an
all-reduce forward, the identity backward: every rank's partial took the
whole gradient). The serving path keeps the plain calls.

gloo drives its collectives from the host: a CUDA tensor is copied to
host memory, reduced there and copied back (the wire), so no collective
can sit inside a captured CUDA graph. On the H100 with torch 2.11, gloo
took CUDA tensors in all_reduce (sum over f32, bf16, f16, f64, int8,
int32, int64; MAX, MIN, PRODUCT over f32), broadcast, reduce, all_gather,
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single and
barrier. As in the reference, the compressed payload is summed in int32:
its values lie on the int8 grid, its bytes are f32's.

:data:`COUNTS` counts the collectives this process ran, by name: a test
reads how many a step takes.

**The dry seam.** A :class:`DryGroup` stands for one axis of a grid that
no process backs (``launch.mesh.dry_mesh``, rank 0 of the production
mesh in the dry run, ``launch/dryrun.py``). Given one, every function
here returns tensors of the right shape (an all-reduce the rank's own
values, an all-gather the rank's part repeated), counts in
:data:`COUNTS` as a real call does and moves nothing. Only a
``DryGroup`` takes it: a real mesh's groups are gloo groups, which
always run the collective. Real and dry calls alike report (op, result
bytes, group size) to the installed sinks (the op analysis's recorder,
``analysis.op_audit``), under the reference's HLO names
(``"all-reduce"``, ``"all-gather"``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

#: collectives run by this process, by name ("all_reduce", "all_gather";
#: the training functions "copy", "gather" and "reduce" once a forward
#: call, beside the primitives they run forward or backward)
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


#: the recorders of collective calls (``op_audit``'s recorder with
#: ``calls=True`` adds one while it runs): ``sink(op, result_bytes, n)``
_SINKS: list = []


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """One axis of a grid that no process backs: ``size`` ranks, this
    process rank 0 of them (see the module docstring)."""

    size: int
    axis: str = "model"


def _dry(group) -> bool:
    return isinstance(group, DryGroup)


def group_size(group) -> int:
    """The number of ranks in ``group`` (a gloo group or a DryGroup)."""
    return group.size if _dry(group) else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 in a DryGroup)."""
    return 0 if _dry(group) else dist.get_rank(group)


def _note(op: str, out: torch.Tensor, group) -> None:
    if _SINKS:
        nbytes, n = out.numel() * out.element_size(), group_size(group)
        for sink in tuple(_SINKS):
            sink(op, nbytes, n)


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` ("sum" | "max"), out of place. The
    sum is exact where the rank partials add exactly (integer counts, or
    one nonzero contributor per element)."""
    out = x.clone(memory_format=torch.contiguous_format)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if not _dry(group):
        dist.all_reduce(out, op=red, group=group)
    COUNTS["all_reduce"] += 1
    _note("all-reduce", out, group)
    return out


def all_gather(x: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (each
    rank's ``x`` of one shape). A copy: bit-exact for every dtype."""
    x = x.contiguous()
    if _dry(group):
        parts = [x] * group.size
    else:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
    COUNTS["all_gather"] += 1
    out = torch.cat(parts, dim=dim)
    _note("all-gather", out, group)
    return out


def compressed_psum_int8(x: torch.Tensor, group,
                         generator: torch.Generator) -> torch.Tensor:
    """Int8-compressed sum of ``x`` over ``group``, decoded to f32.

    All ranks agree on one scale (a MAX all-reduce of the local amax),
    quantize with unbiased stochastic rounding (uniform noise in [-0.5,
    0.5) from ``generator``, the rank's own stream), and sum the payload
    in int32 (sums of int8 over any realistic group fit). Error per
    element: at most one rounding step, ``amax/127``, per rank."""
    xf = x.to(torch.float32)
    amax = all_reduce(xf.abs().amax().reshape(1), group, op="max")
    scale = torch.clamp(amax, min=1e-12) / 127.0
    noise = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32) - 0.5
    q = torch.clamp(torch.round(xf / scale + noise), -127, 127)
    total = all_reduce(q.to(torch.int32), group)
    return total.to(torch.float32) * scale


def tp_allreduce(x: torch.Tensor, group, *,
                 generator: Optional[torch.Generator] = None,
                 compressed: bool = False) -> torch.Tensor:
    """Tensor-parallel partial-sum all-reduce: the sum of the ranks'
    row-parallel partials. ``compressed=False`` is the exact sum (for the
    CiM formulations the partials are integer ADC event counts, so the
    f32 sum is exact and TP serving stays bit-identical);
    ``compressed=True`` goes through :func:`compressed_psum_int8` and
    needs the ``generator`` of its stochastic rounding."""
    if not compressed:
        return all_reduce(x, group)
    if generator is None:
        raise ValueError("compressed tp_allreduce needs a torch.Generator "
                         "(stochastic-rounding stream)")
    return compressed_psum_int8(x, group, generator)


def mean_grads_int8(grad: torch.Tensor, group,
                    generator: torch.Generator) -> torch.Tensor:
    """The mean of the ranks' ``grad`` over ``group`` with an int8 wire
    format (each rank passes its own gradient and rounding stream);
    returns the f32 mean on every rank. The reference's
    ``mean_grads_int8(mesh, grads, keys)`` takes the stacked shards of
    one program instead."""
    return compressed_psum_int8(grad, group, generator) / group_size(group)


def bucket_mean(tensors, group):
    """The mean over ``group`` of each rank's ``tensors`` (a sequence),
    through one collective: every tensor flattened into one f32 bucket,
    summed by one all-reduce, divided by the group's size and rounded
    back to each tensor's dtype. Returns new tensors in order."""
    tensors = list(tensors)
    bucket = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    if not _dry(group):
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
    COUNTS["all_reduce"] += 1
    _note("all-reduce", bucket, group)
    bucket /= group_size(group)
    out, start = [], 0
    for t in tensors:
        n = t.numel()
        out.append(bucket[start:start + n].view(t.shape).to(t.dtype))
        start += n
    return out


# ---------------------------------------------------------------------------
# The model axis of tensor-parallel training: collectives under autograd
# ---------------------------------------------------------------------------


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (the size over the group)."""
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce(g, ctx.group)
        return _slice(g, ctx.group, ctx.dim), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself forward; backward, the sum over ``group`` of the
    ranks' gradients (each rank's is partial: it reached ``x`` through the
    rank's part of the computation). A replicated tensor enters a
    rank-partial computation through it once."""
    COUNTS["copy"] += 1
    return _Copy.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = -1, partial: bool = False
           ) -> torch.Tensor:
    """:func:`all_gather` forward (every rank's ``x`` along ``dim``, in
    rank order); backward, the rank's block of the gradient. That is the
    adjoint where the gradient is whole on every rank (what follows is
    replicated). ``partial=True``: each rank's gradient is a partial one
    (it reached only the part that rank computes from), so they are
    summed over ``group`` first."""
    COUNTS["gather"] += 1
    dim = dim % x.dim()
    return _Gather.apply(x, group, dim, partial)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_reduce`'s sum forward; backward, the gradient itself:
    each rank's partial took part in the whole sum."""
    COUNTS["reduce"] += 1
    return _Reduce.apply(x, group)
