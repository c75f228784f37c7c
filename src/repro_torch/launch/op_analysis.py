"""Whole-step op accounting: FLOPs by dtype, HBM bytes and collective
bytes of one rank's step (the counterpart of
``repro/launch/hlo_analysis.py``).

The reference parses XLA's optimized HLO of a compiled step. The port
has no HLO: its program is the sequence of aten ops and kernel launches
that one eager step dispatches, which ``analysis.op_audit``'s recorder
writes down (``record``: ``op_audit.record_call``, with kernel calls,
collectives and live bytes). :func:`analyze` walks that trace:

  * ``flops``: 2*M*N*K for every ``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ``_int_mm``, ``mv``, ``dot`` and convolution (einsum
    and matmul reach the dispatcher as these), split by the dtype the op
    runs in (``flops_by_dtype``: "bf16", "f32", "f64", ...), and for
    every call of a hand-written kernel its logical work at the "int8"
    key: a CiM MAC is two ternary products of M*K*N (what the
    reference's ``_blocked_jnp`` lowers to, two ``mki,kin->mkn`` dots,
    ``src/repro/core/execution.py``), an exact MAC one. A kernel counts
    the same launched on the card or run as its plain version on the CPU
    or the meta device (``contracts.plain_call``), so the count does not
    depend on the plain version's slicing; the plain version's own ops
    cost nothing;
  * ``hbm_bytes``: each op's operand bytes plus its result bytes, the
    traffic of an unfused eager step; view ops and allocations cost
    nothing, a kernel call its x, weight and output bytes;
  * ``coll``: bytes by collective type under the reference's ring model
    (:func:`collective_moved`, ``hlo_analysis._collective_moved``
    formula for formula), from the (result bytes, group size) every
    collective of ``dist.collectives`` reports, dry or real.

All numbers are one rank's: the trace is one rank's program, as the
reference's SPMD module is per device. There are no loop trip counts to
multiply: an eager step dispatches every iteration of its layer loop.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Sequence

import torch

from repro_torch.analysis.op_audit import OpRecord
# run a call once and record its ops, its kernel calls with their work,
# its collectives and the peak of its live bytes: record(fn, *args)
from repro_torch.analysis.op_audit import record_call as record  # noqa: F401

#: the reference's collective names (``hlo_analysis.COLLECTIVES``)
COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
#: the dtype keys of ``flops_by_dtype`` (torch's names -> the reference's)
DTYPE_KEYS = {
    "bfloat16": "bf16", "float16": "f16", "float32": "f32", "float64": "f64",
    "int8": "int8", "uint8": "u8", "int32": "s32", "int64": "s64",
}
#: the dtype key a hand-written kernel's work is counted under
KERNEL_DTYPE = "int8"
#: ops that allocate or alias without moving bytes (beside the view ops)
_FREE_OPS = frozenset({
    "detach", "alias", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "lift_fresh", "set_",
    "resize_", "_unsafe_view", "_reshape_alias", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
})

Trace = Sequence[OpRecord]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _bytes(meta) -> int:
    return _numel(meta.shape) * getattr(torch, meta.dtype).itemsize


_VIEW_CACHE: Dict[str, bool] = {}


def _is_view(op: str) -> bool:
    """Whether the aten overload ``op`` ("aten.view.default") returns a
    view of an input (no bytes move)."""
    hit = _VIEW_CACHE.get(op)
    if hit is None:
        hit = False
        parts = op.split(".")
        if len(parts) == 3 and parts[0] == "aten":
            packet = getattr(torch.ops.aten, parts[1], None)
            overload = getattr(packet, parts[2], None) if packet is not None else None
            hit = bool(getattr(overload, "is_view", False))
        _VIEW_CACHE[op] = hit
    return hit


def _dtype_key(meta) -> str:
    return DTYPE_KEYS.get(meta.dtype, meta.dtype)


def _mac_flops(rec: OpRecord) -> float:
    """2*M*N*K of one contraction (0 for any other op)."""
    name, ins = rec.name, rec.inputs
    if name in ("mm", "_int_mm") and len(ins) >= 2:
        (m, k), n = ins[0].shape, ins[1].shape[-1]
        return 2.0 * m * k * n
    if name == "addmm" and len(ins) >= 3:
        (m, k), n = ins[1].shape, ins[2].shape[-1]
        return 2.0 * m * k * n
    if name == "bmm" and len(ins) >= 2:
        (b, m, k), n = ins[0].shape, ins[1].shape[-1]
        return 2.0 * b * m * k * n
    if name == "baddbmm" and len(ins) >= 3:
        (b, m, k), n = ins[1].shape, ins[2].shape[-1]
        return 2.0 * b * m * k * n
    if name == "mv" and len(ins) >= 2:
        return 2.0 * _numel(ins[0].shape)
    if name == "dot" and len(ins) >= 2:
        return 2.0 * _numel(ins[0].shape)
    if name == "convolution" and len(ins) >= 2 and rec.outputs:
        # out_numel x (C_in / groups x kernel taps): the weight's numel
        # over its output channels
        w = ins[1].shape
        return 2.0 * _numel(rec.outputs[0].shape) * _numel(w[1:])
    if name == "convolution_backward" and len(ins) >= 3:
        # the gradients of the input and of the weight: a forward each
        grad_out, w = ins[0].shape, ins[2].shape
        return 2.0 * 2.0 * _numel(grad_out) * _numel(w[1:])
    return 0.0


def collective_moved(op: str, nbytes: float, n: int) -> float:
    """Bytes one rank moves for a collective of ``nbytes`` result bytes
    over ``n`` ranks, the reference's ring model
    (``hlo_analysis._collective_moved``)."""
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return nbytes * (n - 1) / n
    if op == "reduce-scatter":
        return nbytes * (n - 1)
    if op == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if op == "all-to-all":
        return nbytes * (n - 1) / n
    return nbytes  # collective-permute


@dataclasses.dataclass
class OpCost:
    """One rank's step, as :func:`analyze` counts it (the reference's
    ``HloCost``, with the FLOPs split by dtype and the kernel calls)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    #: calls per kernel C entry (launched or plain)
    kernel_calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    #: collective calls by type
    coll_calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "flops_by_dtype": dict(self.flops_by_dtype),
                "hbm_bytes": self.hbm_bytes, "coll": dict(self.coll),
                "kernel_calls": dict(self.kernel_calls),
                "coll_calls": dict(self.coll_calls)}


def _in_kernel(rec: OpRecord) -> bool:
    return any(s.startswith("kernel:") for s in rec.scope)


def analyze(trace: Trace, n_devices: int = 1) -> OpCost:
    """Whole-step accounting of one rank's recorded ``trace``
    (``record``); ``n_devices`` is the group size of a collective
    that reports none."""
    cost = OpCost()
    for rec in trace:
        if rec.is_kernel:
            if not rec.info:
                raise ValueError(f"{rec.op} carries no call work: record the step "
                                 "with op_analysis.record (calls on)")
            m, k, n, products, nbytes = rec.info
            work = 2.0 * products * m * k * n
            cost.flops += work
            cost.flops_by_dtype[KERNEL_DTYPE] += work
            cost.hbm_bytes += nbytes
            cost.kernel_calls[rec.op.split(":", 1)[1]] += 1
            continue
        if rec.is_collective:
            op = rec.op.split(":", 1)[1]
            nbytes, n = rec.info if rec.info else (0, n_devices)
            cost.coll[op] += collective_moved(op, nbytes, n)
            cost.coll_calls[op] += 1
            continue
        if _in_kernel(rec):
            continue  # the plain version of a kernel: its call counts
        f = _mac_flops(rec)
        if f:
            cost.flops += f
            cost.flops_by_dtype[_dtype_key(rec.inputs[0] if rec.name != "addmm"
                                           else rec.inputs[1])] += f
        if rec.name in _FREE_OPS or _is_view(rec.op):
            continue
        cost.hbm_bytes += sum(_bytes(t) for t in rec.inputs) + sum(
            _bytes(t) for t in rec.outputs)
    return cost
