"""Plain PyTorch oracles of the CiM MAC (counterpart of
``repro/kernels/ref.py``): simple, allocation-happy, float32."""
from __future__ import annotations

import torch

DEFAULT_BLOCK = 16   # N_A: rows asserted per CiM cycle
DEFAULT_ADC_MAX = 8  # 3-bit flash ADC + extra sense amp


def pad_axis(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult`` (zero
    rows are inert under the a/b event counts)."""
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def ref_cim_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   block: int = DEFAULT_BLOCK,
                   adc_max: int = DEFAULT_ADC_MAX) -> torch.Tensor:
    """SiTe CiM semantics: per-``block`` event counts a/b clamped at
    ``adc_max`` and accumulated across blocks. x (M, K), w (K, N) ternary;
    returns f32 (M, N)."""
    m_, k = x.shape
    if k % block != 0:
        raise ValueError(f"K={k} is not a multiple of block={block}")
    kb = k // block
    xb = x.to(torch.float32).reshape(m_, kb, block)
    wb = w.to(torch.float32).reshape(kb, block, -1)
    p = torch.einsum("mki,kin->mkn", xb, wb)
    mm = torch.einsum("mki,kin->mkn", xb.abs(), wb.abs())
    a = (mm + p) * 0.5
    b = (mm - p) * 0.5
    part = torch.clamp(a, max=float(adc_max)) - torch.clamp(b, max=float(adc_max))
    return part.sum(dim=1)


def ref_exact_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Near-memory baseline: exact ternary matmul in f32."""
    return x.to(torch.float32) @ w.to(torch.float32)


def unpack_planes_int(w_pos: torch.Tensor, w_neg: torch.Tensor) -> torch.Tensor:
    """(K/8, N) uint8 planes -> (K, N) int32 ternary weights."""
    kp, n = w_pos.shape
    shifts = torch.arange(8, dtype=torch.int32, device=w_pos.device)
    bits_p = ((w_pos.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & 1)
    bits_n = ((w_neg.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & 1)
    return (bits_p - bits_n).reshape(kp * 8, n)


def unpack_planes_f32(w_pos: torch.Tensor, w_neg: torch.Tensor) -> torch.Tensor:
    """(K/8, N) uint8 planes -> (K, N) f32 ternary weights."""
    return unpack_planes_int(w_pos, w_neg).to(torch.float32)


def ref_packed_matmul_int(x: torch.Tensor, w_pos: torch.Tensor,
                          w_neg: torch.Tensor, *, block: int = DEFAULT_BLOCK,
                          adc_max: int = DEFAULT_ADC_MAX,
                          cim: bool = True) -> torch.Tensor:
    """The bitplane-packed MAC in integers, as the decode kernels count:
    x (M, K) integer codes (K a multiple of ``block``), (K/8, N) uint8
    planes; every contraction, clamp and sum in int32. Returns int32
    (M, N), equal to :func:`ref_packed_matmul`'s f32 result."""
    xi = x.to(torch.int32)
    w = unpack_planes_int(w_pos, w_neg)
    if not cim:
        return xi @ w
    m_, k = xi.shape
    if k % block != 0:
        raise ValueError(f"K={k} is not a multiple of block={block}")
    xb, wb = xi.reshape(m_, k // block, block), w.reshape(k // block, block, -1)
    p = torch.einsum("mki,kin->mkn", xb, wb)
    mm = torch.einsum("mki,kin->mkn", xb.abs(), wb.abs())
    a, b = (mm + p) // 2, (mm - p) // 2
    part = torch.clamp(a, max=adc_max) - torch.clamp(b, max=adc_max)
    return part.sum(dim=1, dtype=torch.int32)


def ref_packed_matmul(x: torch.Tensor, w_pos: torch.Tensor,
                      w_neg: torch.Tensor, *, block: int = DEFAULT_BLOCK,
                      adc_max: int = DEFAULT_ADC_MAX,
                      cim: bool = True) -> torch.Tensor:
    """Oracle for the bitplane-packed kernels: w_pos/w_neg (K/8, N) uint8
    planes packed 8 per byte along K."""
    w = unpack_planes_f32(w_pos, w_neg)
    if cim:
        return ref_cim_matmul(x, w, block=block, adc_max=adc_max)
    return ref_exact_matmul(x, w)
