"""Gradient compression with error feedback (port of
``repro/optim/compress.py``).

  * int8 per-leaf linear quantization with stochastic rounding
    (unbiased), its noise drawn from an explicit ``torch.Generator``,
  * a bf16 round trip (cheap 2x),
  * an error-feedback residual, so that compression error does not bias
    long-run training.

The encode/decode round trip models the numerics of a compressed
gradient reduction; the port has no multi-device reduction yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.adamw import tree_map

PyTree = Any


class Int8Encoded(NamedTuple):
    values: torch.Tensor   # int8 payload
    scale: torch.Tensor    # f32 per-leaf scale


def encode_int8(g: torch.Tensor, generator: torch.Generator) -> Int8Encoded:
    """Unbiased stochastic-rounding int8 quantization (per-leaf scale)."""
    gf = g.to(torch.float32)
    amax = torch.clamp(gf.abs().max(), min=1e-12)
    scale = amax / 127.0
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127).to(torch.int8)
    return Int8Encoded(q, scale)


def decode_int8(enc: Int8Encoded, dtype=torch.float32) -> torch.Tensor:
    return (enc.values.to(torch.float32) * enc.scale).to(dtype)


def compress_grads(grads: PyTree, method: Optional[str],
                   generator: Optional[torch.Generator] = None,
                   residual: Optional[PyTree] = None
                   ) -> Tuple[PyTree, Optional[PyTree]]:
    """Apply compression with optional error feedback. Returns
    (decoded_grads, new_residual). int8 draws each leaf's noise from
    ``generator`` in sorted-key order."""
    if method is None or method == "none":
        return grads, residual
    if residual is not None:
        grads = tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    if method == "bf16":
        dec = tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
    elif method == "int8":
        if generator is None:
            raise ValueError("int8 compression needs a torch.Generator")
        dec = tree_map(lambda g: decode_int8(encode_int8(g, generator)), grads)
    else:
        raise ValueError(method)
    new_residual = tree_map(
        lambda g, d: g.to(torch.float32) - d.to(torch.float32), grads, dec)
    return dec, new_residual


def init_residual(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
