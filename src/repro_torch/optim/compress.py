"""Gradient compression with error feedback (port of
``repro/optim/compress.py``).

  * int8 per-leaf linear quantization with stochastic rounding
    (unbiased), its noise drawn from an explicit ``torch.Generator``,
  * a bf16 round trip (cheap 2x),
  * an error-feedback residual, so that compression error does not bias
    long-run training.

The encode/decode round trip models the numerics of a compressed
gradient reduction. It runs after the data axis's exact mean
(``train_step``), as the reference's does, on every rank alike; under a
model axis each rank compresses its shards as the single device
compresses the whole leaf (:func:`compress_grads`' ``split``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.adamw import tree_map

PyTree = Any


class Int8Encoded(NamedTuple):
    values: torch.Tensor   # int8 payload
    scale: torch.Tensor    # f32 per-leaf scale


def encode_int8(g: torch.Tensor, generator: torch.Generator, split=None,
                group=None) -> Int8Encoded:
    """Unbiased stochastic-rounding int8 quantization (per-leaf scale).
    ``split`` (a ``dist.sharding.LeafSplit``) and ``group``: ``g`` is a
    model rank's shard of the leaf; the scale is the whole leaf's amax
    (a max over ``group``) and the noise is drawn at the whole leaf's
    shape from the replicated ``generator`` and cut as ``g`` was, so the
    rank's codes are its part of the single device's."""
    gf = g.to(torch.float32)
    amax = gf.abs().max()
    if split is not None:
        from repro_torch.dist import collectives

        amax = collectives.all_reduce(amax, group, op="max")
    scale = torch.clamp(amax, min=1e-12) / 127.0
    shape = g.shape if split is None else split.shape
    noise = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    if split is not None:
        noise = split.cut(noise)
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127).to(torch.int8)
    return Int8Encoded(q, scale)


def decode_int8(enc: Int8Encoded, dtype=torch.float32) -> torch.Tensor:
    return (enc.values.to(torch.float32) * enc.scale).to(dtype)


def tree_encode_int8(grads: PyTree, generator: torch.Generator) -> PyTree:
    """:func:`encode_int8` of every leaf of ``grads``, in the tree's
    structure. The leaves draw their noise from the one ``generator`` in
    sorted-key order (``adamw.tree_leaves``), each at its own shape, one
    after another; the reference splits its key into one key a leaf
    instead, so the two packages' codes agree only up to the rounding."""
    return tree_map(lambda g: encode_int8(g, generator), grads)


def tree_decode_int8(enc_tree: PyTree, dtype=torch.float32) -> PyTree:
    """:func:`decode_int8` of every :class:`Int8Encoded` leaf."""
    return tree_map(lambda e: decode_int8(e, dtype), enc_tree)


def compress_grads(grads: PyTree, method: Optional[str],
                   generator: Optional[torch.Generator] = None,
                   residual: Optional[PyTree] = None, split: Optional[PyTree] = None,
                   group=None) -> Tuple[PyTree, Optional[PyTree]]:
    """Apply compression with optional error feedback. Returns
    (decoded_grads, new_residual). int8 draws each leaf's noise from
    ``generator`` in sorted-key order. ``split`` (``dist.sharding.
    train_layout``'s tree: None where a leaf is replicated) and ``group``
    (the model group): the leaves are a model rank's shards, each
    encoded as its part of the whole leaf (:func:`encode_int8`); bf16
    is elementwise, so a shard's round trip is its part of the whole
    one's."""
    if method is None or method == "none":
        return grads, residual
    if residual is not None:
        grads = tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    if method == "bf16":
        dec = tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
    elif method == "int8":
        if generator is None:
            raise ValueError("int8 compression needs a torch.Generator")
        if split is None:
            dec = tree_decode_int8(tree_encode_int8(grads, generator))
        else:
            dec = tree_map(lambda g, sp: decode_int8(encode_int8(g, generator, sp, group)),
                           grads, split)
    else:
        raise ValueError(method)
    new_residual = tree_map(
        lambda g, d: g.to(torch.float32) - d.to(torch.float32), grads, dec)
    return dec, new_residual


def init_residual(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
