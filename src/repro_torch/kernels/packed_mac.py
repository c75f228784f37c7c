"""Bitplane-packed CiM matmul: wrappers of the CUDA kernels
``csrc/packed_mac.cu`` and ``csrc/packed_stream.cu`` and their plain
PyTorch versions.

  * :func:`packed_cim_matmul_decode` ports the Pallas TPU kernel
    ``repro/kernels/packed_mac.py::packed_cim_matmul_decode`` — M <= 8,
    int32 output;
  * :func:`packed_cim_matmul` ports ``packed_cim_matmul`` — prefill-class
    M, f32 output;
  * :func:`packed_cim_matmul_decode_stream` ports
    ``packed_cim_matmul_decode_stream`` — M <= 8 from ONE plane-interleaved
    (layout 1) array streamed through per-warp rings of ``nbuf`` stages,
    int32 output, bit-identical to the decode kernel #2.

Weights are the (rows, N) uint8 (M1, M2) planes with bit j of byte r =
K row 8r+j (layout 1: byte-row 2r pos, 2r+1 neg), and the weight is
pos - neg (0 where both bits are set); x is (M, K) int8 codes with
K <= 8*rows (missing columns are zero, which is inert). ``n_out`` keeps
only the first logical columns of canonically padded planes. For a CUDA
tensor each wrapper launches its kernel (or raises); for a CPU or meta
tensor it runs the plain version. Each wrapper's ``launches`` attribute
counts its kernel launches and ``last_plan`` holds the grid of its last
launch; every call, launched or plain, reports its logical work
(``kernels.mac_call``) through ``contracts.report_call``. All
three kernels are instances of the tile template of
``csrc/ternary_tile.cuh`` and take their grid from
:func:`repro_torch.kernels.plan.launch_plan` at x's K and the logical
columns, unless the caller passes ``plan=`` (the execution layer does, for
a tile-sweep winner); #2 and #3 read only its cluster (their M tile is 8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.contracts import plain_call, report_call
from repro_torch.core.ternary import deinterleave_planes
from repro_torch.kernels import DECODE_M_MAX, PLAIN_DEVICES, _build, mac_call
from repro_torch.kernels.plan import LaunchPlan, device_plan
from repro_torch.kernels.ref import pad_axis, ref_packed_matmul, ref_packed_matmul_int

DEFAULT_BLOCK = 16
DEFAULT_ADC_MAX = 8
# the stream kernel's ring depths (as the Pallas kernel asserts) and its
# 16-byte copies' alignment
STREAM_NBUF = (2, 3)
STREAM_ALIGN = 16


def _check(x, w_pos, w_neg, n_out):
    if x.dim() != 2 or w_pos.dim() != 2 or w_pos.shape != w_neg.shape:
        raise ValueError(f"need x (M, K) and (rows, N) planes, got "
                         f"{tuple(x.shape)}, {tuple(w_pos.shape)}, "
                         f"{tuple(w_neg.shape)}")
    if x.dtype != torch.int8:
        raise TypeError(f"need int8 activation codes, got {x.dtype}")
    if w_pos.dtype != torch.uint8 or w_neg.dtype != torch.uint8:
        raise TypeError(f"need uint8 planes, got {w_pos.dtype}, {w_neg.dtype}")
    if not (x.device == w_pos.device == w_neg.device):
        raise ValueError("operands on different devices")
    rows, n_cols = w_pos.shape
    if x.shape[1] > rows * 8:
        raise ValueError(f"x K={x.shape[1]} exceeds the planes' {rows * 8} rows")
    n_out = n_cols if n_out is None else int(n_out)
    if not 0 <= n_out <= n_cols:
        raise ValueError(f"n_out={n_out} outside the planes' {n_cols} columns")
    return n_out


def packed_matmul_plain(x: torch.Tensor, w_pos: torch.Tensor,
                        w_neg: torch.Tensor, *, n_out: Optional[int] = None,
                        block: int = DEFAULT_BLOCK,
                        adc_max: int = DEFAULT_ADC_MAX,
                        cim: bool = True) -> torch.Tensor:
    """Both kernels' function in plain PyTorch, f32 (M, n_out)."""
    rows, n_cols = w_pos.shape
    n_out = n_cols if n_out is None else n_out
    k_full = -(-rows * 8 // block) * block
    out = ref_packed_matmul(pad_axis(x, k_full, 1),
                            pad_axis(w_pos, k_full // 8, 0),
                            pad_axis(w_neg, k_full // 8, 0),
                            block=block, adc_max=adc_max, cim=cim)
    return out[:, :n_out]


def packed_decode_plain(x: torch.Tensor, w_pos: torch.Tensor,
                        w_neg: torch.Tensor, *, n_out: Optional[int] = None,
                        block: int = DEFAULT_BLOCK,
                        adc_max: int = DEFAULT_ADC_MAX,
                        cim: bool = True) -> torch.Tensor:
    """The decode kernels' function in plain PyTorch, in integers as they
    count (int32 event counts, int32 accumulation): int32 (M, n_out),
    equal to :func:`packed_matmul_plain`'s values. The wrappers of #2 and
    #3 run it for CPU tensors (integer products need the CPU)."""
    rows, n_cols = w_pos.shape
    n_out = n_cols if n_out is None else n_out
    k_full = -(-rows * 8 // block) * block
    out = ref_packed_matmul_int(pad_axis(x, k_full, 1),
                                pad_axis(w_pos, k_full // 8, 0),
                                pad_axis(w_neg, k_full // 8, 0),
                                block=block, adc_max=adc_max, cim=cim)
    return out[:, :n_out]


def _cuda_ok(x, block):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if block != DEFAULT_BLOCK:
        raise ValueError(f"the CUDA kernel implements block=16, got {block}")


def _planes_ok(x, w_pos, w_neg):
    if w_pos.stride(1) != 1 or w_neg.stride(1) != 1 or not x.is_contiguous():
        raise ValueError("the CUDA kernel needs contiguous x and unit "
                         "column stride planes")


def _launch_decode(x, w_pos, w_neg, n_out, adc_max, cim,
                   plan: Optional[LaunchPlan] = None):
    """Launch #2 into a new int32 (M <= 8, n_out) on ``plan`` (default:
    the card's :func:`device_plan` at x's K and ``n_out``; its 8-row tile
    is the kernel's own); returns (out, the plan launched, None when
    nothing was). A launch that CUDA refuses raises."""
    _planes_ok(x, w_pos, w_neg)
    m, kx = x.shape
    out = torch.empty((m, n_out), dtype=torch.int32, device=x.device)
    if m == 0 or n_out == 0:
        return out, None
    with torch.cuda.device(x.device):
        if plan is None:
            plan = device_plan(m, kx, n_out)
        _build.launch(
            packed_cim_matmul_decode.entry, x.data_ptr(), w_pos.data_ptr(),
            w_neg.data_ptr(), out.data_ptr(), m, kx, w_pos.shape[0],
            w_pos.stride(0), w_neg.stride(0), w_pos.shape[1], n_out,
            int(adc_max), int(cim), plan.cluster, _build.stream_ptr(x.device))
    return out, plan


def _launch_prefill(x, w_pos, w_neg, n_out, adc_max, cim,
                    plan: Optional[LaunchPlan] = None):
    """Launch #4 into a new f32 (M, n_out) on ``plan`` (default: the
    card's :func:`device_plan` at x's K and ``n_out``); returns (out,
    the plan launched, None when nothing was). A launch that CUDA refuses
    raises."""
    _planes_ok(x, w_pos, w_neg)
    m, kx = x.shape
    out = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    if m == 0 or n_out == 0:
        return out, None
    with torch.cuda.device(x.device):
        if plan is None:
            plan = device_plan(m, kx, n_out)
        _build.launch(
            packed_cim_matmul.entry, x.data_ptr(), w_pos.data_ptr(),
            w_neg.data_ptr(), out.data_ptr(), m, kx, w_pos.shape[0],
            w_pos.stride(0), w_neg.stride(0), w_pos.shape[1], n_out,
            int(adc_max), int(cim), plan.rows, plan.cluster,
            _build.stream_ptr(x.device))
    return out, plan


def packed_cim_matmul_decode(x: torch.Tensor, w_pos: torch.Tensor,
                             w_neg: torch.Tensor, *,
                             n_out: Optional[int] = None,
                             block: int = DEFAULT_BLOCK,
                             adc_max: int = DEFAULT_ADC_MAX,
                             cim: bool = True,
                             plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """Decode-class packed MAC: x (M <= 8, K) int8 -> int32 (M, n_out).
    ``plan``: the grid on the card (default :func:`device_plan`)."""
    n_out = _check(x, w_pos, w_neg, n_out)
    if x.shape[0] > DECODE_M_MAX:
        raise ValueError(f"decode kernel takes M <= {DECODE_M_MAX}, "
                         f"got {x.shape[0]}")
    call = mac_call(x.shape[0], x.shape[1], n_out, 2 if cim else 1,
                    w_pos.numel() + w_neg.numel())
    if x.device.type in PLAIN_DEVICES:
        return plain_call(packed_cim_matmul_decode.entry, call, packed_decode_plain, x,
                          w_pos, w_neg, n_out=n_out, block=block, adc_max=adc_max,
                          cim=cim)
    _cuda_ok(x, block)
    out, used = _launch_decode(x, w_pos, w_neg, n_out, adc_max, cim, plan)
    if used is not None:
        packed_cim_matmul_decode.launches += 1
        packed_cim_matmul_decode.last_plan = used
        report_call(packed_cim_matmul_decode.entry, call, out, launched=True)
    return out


def packed_cim_matmul(x: torch.Tensor, w_pos: torch.Tensor,
                      w_neg: torch.Tensor, *, n_out: Optional[int] = None,
                      block: int = DEFAULT_BLOCK,
                      adc_max: int = DEFAULT_ADC_MAX,
                      cim: bool = True,
                      plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """Prefill-class packed MAC: x (M, K) int8 -> f32 (M, n_out).
    ``plan``: the grid on the card (default :func:`device_plan`)."""
    n_out = _check(x, w_pos, w_neg, n_out)
    call = mac_call(x.shape[0], x.shape[1], n_out, 2 if cim else 1,
                    w_pos.numel() + w_neg.numel())
    if x.device.type in PLAIN_DEVICES:
        return plain_call(packed_cim_matmul.entry, call, packed_matmul_plain, x,
                          w_pos, w_neg, n_out=n_out, block=block, adc_max=adc_max,
                          cim=cim)
    _cuda_ok(x, block)
    out, used = _launch_prefill(x, w_pos, w_neg, n_out, adc_max, cim, plan)
    if used is not None:
        packed_cim_matmul.launches += 1
        packed_cim_matmul.last_plan = used
        report_call(packed_cim_matmul.entry, call, out, launched=True)
    return out


def stream_matmul_plain(x: torch.Tensor, w_int: torch.Tensor, *,
                        n_out: Optional[int] = None, block: int = DEFAULT_BLOCK,
                        adc_max: int = DEFAULT_ADC_MAX,
                        cim: bool = True) -> torch.Tensor:
    """The stream kernel's function in plain PyTorch: de-interleave the
    layout-1 array and run :func:`packed_matmul_plain`; f32 (M, n_out)."""
    w_pos, w_neg = deinterleave_planes(w_int)
    return packed_matmul_plain(x, w_pos, w_neg, n_out=n_out, block=block,
                               adc_max=adc_max, cim=cim)


def _launch_stream(x, w_int, n_out, adc_max, cim, nbuf,
                   plan: Optional[LaunchPlan] = None):
    """Launch #3 into a new int32 (M, n_out) on ``plan`` (default: the
    card's :func:`device_plan` at x's K and ``n_out``); returns (out,
    the plan launched, None when nothing was). Only 16-byte copies are
    compiled: an
    array whose pointer, row stride or width is not a multiple of 16
    bytes raises, and x whose K or pointer is not is first copied,
    zero-extended, into one that is. A launch that CUDA refuses raises."""
    if (w_int.stride(1) != 1 or w_int.stride(0) % STREAM_ALIGN
            or w_int.shape[1] % STREAM_ALIGN or w_int.data_ptr() % STREAM_ALIGN
            or not x.is_contiguous()):
        raise ValueError("the stream kernel needs contiguous x and an "
                         "interleaved array with unit column stride whose "
                         "pointer, row stride and width are multiples of 16")
    m, kx = x.shape
    out = torch.empty((m, n_out), dtype=torch.int32, device=x.device)
    if m == 0 or n_out == 0:
        return out, None
    if kx % STREAM_ALIGN or x.data_ptr() % STREAM_ALIGN:
        x = pad_axis(x, STREAM_ALIGN, 1).clone()  # zero columns are inert
    with torch.cuda.device(x.device):
        if plan is None:
            plan = device_plan(m, kx, n_out)
        _build.launch(
            packed_cim_matmul_decode_stream.entry, x.data_ptr(), w_int.data_ptr(),
            out.data_ptr(), m, x.shape[1], w_int.shape[0], w_int.stride(0),
            n_out, int(adc_max), int(cim), int(nbuf), plan.cluster,
            _build.stream_ptr(x.device))
    return out, plan


def packed_cim_matmul_decode_stream(x: torch.Tensor, w_int: torch.Tensor, *,
                                    n_out: Optional[int] = None,
                                    block: int = DEFAULT_BLOCK,
                                    adc_max: int = DEFAULT_ADC_MAX,
                                    cim: bool = True,
                                    nbuf: int = 2,
                                    plan: Optional[LaunchPlan] = None
                                    ) -> torch.Tensor:
    """Streaming decode-class packed MAC: x (M <= 8, K) int8 and ONE
    (K/4, N) uint8 plane-interleaved array -> int32 (M, n_out). ``plan``:
    the grid on the card (default :func:`device_plan`)."""
    if nbuf not in STREAM_NBUF:
        raise ValueError(f"buffer depth {nbuf} not in {{2, 3}}")
    if block != DEFAULT_BLOCK:
        raise ValueError(f"the stream kernel implements block=16, got {block}")
    if w_int.dim() != 2 or w_int.shape[0] % 2 != 0:
        raise ValueError(f"need a (K/4, N) interleaved plane array with an "
                         f"even row count, got {tuple(w_int.shape)}")
    w_pos, w_neg = deinterleave_planes(w_int)
    n_out = _check(x, w_pos, w_neg, n_out)
    if x.shape[0] > DECODE_M_MAX:
        raise ValueError(f"stream decode kernel takes M <= {DECODE_M_MAX}, "
                         f"got {x.shape[0]}")
    call = mac_call(x.shape[0], x.shape[1], n_out, 2 if cim else 1, w_int.numel())
    if x.device.type in PLAIN_DEVICES:
        return plain_call(packed_cim_matmul_decode_stream.entry, call, packed_decode_plain, x,
                          w_pos, w_neg, n_out=n_out, block=block, adc_max=adc_max,
                          cim=cim)
    _cuda_ok(x, block)
    out, used = _launch_stream(x, w_int, n_out, adc_max, cim, nbuf, plan)
    if used is not None:
        packed_cim_matmul_decode_stream.launches += 1
        packed_cim_matmul_decode_stream.last_plan = used
        report_call(packed_cim_matmul_decode_stream.entry, call, out, launched=True)
    return out


packed_cim_matmul_decode.launches = 0
packed_cim_matmul.launches = 0
packed_cim_matmul_decode_stream.launches = 0
packed_cim_matmul_decode.last_plan = None
packed_cim_matmul.last_plan = None
packed_cim_matmul_decode_stream.last_plan = None
# the C entries (csrc/*.cu) the wrappers launch: the op auditor names a
# launch after them, and their plain versions' kernel scopes
packed_cim_matmul_decode.entry = "packed_decode_mac"
packed_cim_matmul.entry = "packed_cim_mac"
packed_cim_matmul_decode_stream.entry = "packed_stream_mac"


# ---------------------------------------------------------------------------
# Tracing contracts (repro_torch.analysis)
#
# The kernel-level invariants, declared next to the kernels they pin:
#
#   * the decode kernels' a/b event counts accumulate in int32: on the
#     CPU their plain version counts in int32 and converts nothing to a
#     float (an f32 accumulator would still be exact, counts are bounded
#     by `block`, but silently abandons the integer ADC pipeline the
#     macro contract costs against); on the card every instance of #2 and
#     #3 multiplies on int8 tensor cores (IMMA, S32 accumulation);
#   * the prefill kernel's plain version accumulates in f32 by design:
#     pinned too, so a change to either side is a conscious contract
#     edit, not drift;
#   * the stream kernel's ring: asynchronous global->shared copies and a
#     wait on them in every instance (the counterpart of the Pallas
#     kernel's 2 dma_start / 1 dma_wait pin).
#
# The builders run on the card where there is one (the kernel launches,
# and the SASS pins apply), else on the CPU (the plain versions).
# ---------------------------------------------------------------------------

from repro_torch.analysis.contracts import (  # noqa: E402
    TraceContract,
    forbid_convert,
    register_trace_contract,
    sass_async_copies,
    sass_int_accum,
)


def _audit_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _decode_kernel_point():
    dev = _audit_device()
    x = torch.ones((8, 256), dtype=torch.int8, device=dev)
    planes = torch.zeros((32, 128), dtype=torch.uint8, device=dev)
    return packed_cim_matmul_decode, (x, planes, planes)


def _prefill_kernel_point():
    dev = _audit_device()
    x = torch.ones((128, 256), dtype=torch.int8, device=dev)
    planes = torch.zeros((32, 128), dtype=torch.uint8, device=dev)
    return packed_cim_matmul, (x, planes, planes)


def _stream_kernel_point():
    dev = _audit_device()
    x = torch.ones((8, 512), dtype=torch.int8, device=dev)
    w_int = torch.zeros((128, 256), dtype=torch.uint8, device=dev)  # (K/4, N) layout 1
    return packed_cim_matmul_decode_stream, (x, w_int)


register_trace_contract(
    "kernels.packed_decode_kernel",
    _decode_kernel_point,
    TraceContract(
        max_host_syncs=0,
        accum_dtype="int32",
        forbid_ops=(
            forbid_convert(
                from_kinds=("int",), to=("float32", "float64", "bfloat16"),
                within="kernel",
                reason="the decode kernel's int8/int32 event-count "
                       "datapath must not promote to float",
            ),
        ),
        sass_pins=(sass_int_accum("packed_decode_mac"),),
    ),
)

register_trace_contract(
    "kernels.packed_prefill_kernel",
    _prefill_kernel_point,
    TraceContract(max_host_syncs=0, accum_dtype="float32"),
)

register_trace_contract(
    "kernels.packed_decode_stream_kernel",
    _stream_kernel_point,
    TraceContract(
        max_host_syncs=0,
        accum_dtype="int32",
        forbid_ops=(
            forbid_convert(
                from_kinds=("int",), to=("float32", "float64", "bfloat16"),
                within="kernel",
                reason="the streaming decode kernel keeps the int8/int32 "
                       "event-count datapath of the decode kernel",
            ),
        ),
        sass_pins=(sass_int_accum("packed_stream_mac"),)
        + sass_async_copies("packed_stream_mac"),
    ),
)
