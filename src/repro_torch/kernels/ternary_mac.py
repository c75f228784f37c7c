"""Signed-ternary matmuls on dense codes: wrappers of the CUDA kernels
and their plain PyTorch versions.

  * :func:`ternary_cim_matmul` (``csrc/ternary_mac.cu``) ports the Pallas
    TPU kernel ``repro/kernels/ternary_mac.py::ternary_cim_matmul`` — the
    clamped CiM MAC;
  * :func:`ternary_exact_matmul` (``csrc/ternary_exact.cu``) ports
    ``ternary_exact_matmul`` — the exact dot of the near-memory baseline.

For a CUDA tensor each wrapper launches its kernel (or raises); for a CPU
or meta tensor it runs the plain version. Each wrapper's ``launches``
attribute counts its kernel launches and nothing else and ``last_plan``
holds the grid of its last launch; every call, launched or plain, reports
its logical work (``kernels.mac_call``) through
``contracts.report_call``. Both kernels take their grid from
:func:`repro_torch.kernels.plan.launch_plan` (16-column tiles, and K
split at 16-row block boundaries across a thread-block cluster of up to 8
blocks, enough for the grid to fill the card's SMs) unless the caller
passes ``plan=`` (the execution layer does, for a tile-sweep winner).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.contracts import plain_call, report_call
from repro_torch.kernels import PLAIN_DEVICES, mac_call
from repro_torch.kernels import _build
from repro_torch.kernels.plan import LaunchPlan, device_plan
from repro_torch.kernels.ref import pad_axis, ref_cim_matmul, ref_exact_matmul

DEFAULT_BLOCK = 16
DEFAULT_ADC_MAX = 8
# the C entries take M, K and N as int; the tile kernels index memory
# with size_t offsets (ternary_tile.cuh), so only the extents themselves
# and the grid's row tiles (CUDA's grid y) are limited. The largest call
# the served models make, llava-next-34b's MLP at 4 x 2896 rows, has
# M*K = 237 M, under 2^31 as well.
INT_MAX = 2 ** 31 - 1
GRID_Y_MAX = 65535


# the plain MAC materializes about six f32 (rows, K/16, N) tensors, so it
# runs over slices of x's rows (independent of each other) whose
# intermediates stay within this many bytes: at prefill M one call at
# once would take ~100 GB (llava-next-34b's MLP at M = 2897)
PLAIN_SLICE_BYTES = 4 << 30


def ternary_cim_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                             block: int = DEFAULT_BLOCK,
                             adc_max: int = DEFAULT_ADC_MAX) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (M, K), w (K, N) ternary
    codes of any dtype (K zero-extended to whole blocks) -> f32 (M, N),
    over slices of x's rows of at most :data:`PLAIN_SLICE_BYTES` of
    intermediates each (one call on the meta device, which holds none)."""
    x, w = pad_axis(x, block, 1), pad_axis(w, block, 0)
    rows = max(1, PLAIN_SLICE_BYTES // (6 * 4 * (x.shape[1] // block) * w.shape[1] or 1))
    if x.shape[0] <= rows or x.is_meta:
        return ref_cim_matmul(x, w, block=block, adc_max=adc_max)
    return torch.cat([ref_cim_matmul(x[i:i + rows], w, block=block, adc_max=adc_max)
                      for i in range(0, x.shape[0], rows)])


def exact_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact kernel's function in plain PyTorch: x (M, K), w (K, N)
    ternary codes of any dtype -> f32 (M, N). Exact in f32: every
    partial sum is an integer of magnitude <= K."""
    return ref_exact_matmul(x, w)


def _check_codes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M, K) and w (K, N), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"need int8 codes, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")


def _launch_codes(fn: str, x: torch.Tensor, w: torch.Tensor, *extra: int,
                  plan: Optional[LaunchPlan] = None
                  ) -> Tuple[torch.Tensor, Optional[LaunchPlan]]:
    """Launch the dense-code kernel ``fn`` on CUDA operands into a new f32
    (M, N) output, on ``plan`` (default: the card's :func:`device_plan`);
    returns (out, the plan launched, None when nothing was). A launch
    that CUDA refuses raises."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA kernel needs contiguous operands")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out, None
    with torch.cuda.device(x.device):
        if plan is None:
            plan = device_plan(m, k, n)
        if max(m, k, n) > INT_MAX or plan.grid[1] > GRID_Y_MAX:
            raise ValueError(f"(M, K, N) = {(m, k, n)} is beyond the kernel's int "
                             f"extents or its grid of {plan.grid}")
        _build.launch(fn, x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                      *extra, plan.rows, plan.cluster, _build.stream_ptr(x.device))
    return out, plan


def ternary_cim_matmul(x: torch.Tensor, w: torch.Tensor, *,
                       block: int = DEFAULT_BLOCK,
                       adc_max: int = DEFAULT_ADC_MAX,
                       plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """Clamped CiM MAC. x (M, K) and w (K, N) int8 codes in {-1, 0, 1},
    contiguous, on one device; any M, K, N. Returns f32 (M, N). ``plan``:
    the grid on the card (default :func:`device_plan`)."""
    _check_codes(x, w)
    call = mac_call(x.shape[0], x.shape[1], w.shape[1], 2, w.numel())
    if x.device.type in PLAIN_DEVICES:
        return plain_call(ternary_cim_matmul.entry, call, ternary_cim_matmul_plain,
                          x, w, block=block, adc_max=adc_max)
    if block != DEFAULT_BLOCK:
        raise ValueError(f"the CUDA kernel implements block=16, got {block}")
    out, used = _launch_codes(ternary_cim_matmul.entry, x, w, int(adc_max), plan=plan)
    if used is not None:
        ternary_cim_matmul.launches += 1
        ternary_cim_matmul.last_plan = used
        report_call(ternary_cim_matmul.entry, call, out, launched=True)
    return out


def ternary_exact_matmul(x: torch.Tensor, w: torch.Tensor, *,
                         plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """Exact ternary dot (no clamp). x (M, K) and w (K, N) int8 codes in
    {-1, 0, 1}, contiguous, on one device; any M, K, N. Returns f32
    (M, N). ``plan``: the grid on the card (default :func:`device_plan`)."""
    _check_codes(x, w)
    call = mac_call(x.shape[0], x.shape[1], w.shape[1], 1, w.numel())
    if x.device.type in PLAIN_DEVICES:
        return plain_call(ternary_exact_matmul.entry, call, exact_matmul_plain, x, w)
    out, used = _launch_codes(ternary_exact_matmul.entry, x, w, plan=plan)
    if used is not None:
        ternary_exact_matmul.launches += 1
        ternary_exact_matmul.last_plan = used
        report_call(ternary_exact_matmul.entry, call, out, launched=True)
    return out


ternary_cim_matmul.launches = 0
ternary_exact_matmul.launches = 0
ternary_cim_matmul.last_plan = None
ternary_exact_matmul.last_plan = None
# the C entries (csrc/*.cu) the wrappers launch: the op auditor names a
# launch after them, and their plain versions' kernel scopes
ternary_cim_matmul.entry = "ternary_cim_mac"
ternary_exact_matmul.entry = "ternary_exact_mac"
