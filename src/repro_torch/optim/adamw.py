"""AdamW as a functional update over a params tree (port of
``repro/optim/adamw.py``).

The optimizer state mirrors the params tree leaf for leaf: f32 first and
second moments, an int32 step. Each leaf's update runs in f32 and rounds
to the param's dtype once, as the reference does; ``torch.optim.AdamW``
would do its arithmetic in place in the param dtype (bf16), which rounds
differently. A tree is a nested dict of tensors; leaves are visited in
sorted-key order, as ``jax.tree_util`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

PyTree = Any

# elements of a leaf that update() takes at once
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None  # step -> lr scale


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of nested dicts (``rest`` of the same
    structure), keeping the structure; leaves are visited in sorted-key
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: PyTree):
    """The leaves of nested dicts in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def init(params: PyTree) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32, device=next(tree_leaves(params)).device)
    return AdamWState(step, tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _scaled(g, scale), grads), norm


def _rule(cfg: AdamWConfig, grads: PyTree, step: torch.Tensor):
    """(grad_norm, part): ``part(p, g, m, v) -> (p2, m2, v2)``, the clip
    (:func:`clip_by_global_norm`'s rounding) and the update of one leaf
    or slice at the new ``step``. The lr is made on the device from the
    step (a host-to-device copy would stop a graph capture)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip else None
    sf = step.to(torch.float32)
    lr = torch.full_like(sf, cfg.lr)
    if cfg.schedule is not None:
        lr = lr * cfg.schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, sf)
    bc2 = 1.0 - torch.pow(b2, sf)

    def part(p, g, m, v):
        if scale is not None:
            g = _scaled(g, scale)
        gf = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * upd).to(p.dtype), m2, v2

    return gnorm, part


def _slices(p: torch.Tensor):
    """The slices along the first axis that a leaf is updated in: the
    whole leaf up to :data:`SLICE_ELEMS` elements."""
    if p.numel() <= SLICE_ELEMS or p.shape[0] == 1:
        return [slice(None)]
    rows = max(1, SLICE_ELEMS // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState, params: PyTree
           ) -> Tuple[PyTree, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm); the inputs are not
    modified. The clip (:func:`clip_by_global_norm`'s rounding) and the
    update run per leaf, a leaf of more than :data:`SLICE_ELEMS` elements
    in slices along its first axis: the arithmetic is elementwise, so the
    result is the same, and the f32 temporaries stay small beside the
    two copies of the state (zamba2-2.7b's stacked ``w_in`` is 1.44 G
    elements). The plain version of :func:`update_`."""
    step = state.step + 1
    gnorm, part = _rule(cfg, grads, step)

    def leaf(p, g, m, v):
        cuts = _slices(p)
        if len(cuts) == 1:
            return part(p, g, m, v)
        out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        for sl in cuts:
            for o, t in zip(out, part(p[sl], g[sl], m[sl], v[sl])):
                o[sl] = t
        return out

    out = tree_map(leaf, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), AdamWState(step, pick(1), pick(2)), gnorm


def update_(cfg: AdamWConfig, grads: PyTree, state: AdamWState, params: PyTree
            ) -> torch.Tensor:
    """:func:`update` in place: the params, ``mu``, ``nu`` and ``step``
    keep their storage (a captured train step holds it) and take the
    values :func:`update` returns, bit for bit (the same arithmetic per
    leaf and per slice). Returns the grad norm. One copy of the state
    fewer than :func:`update` at the peak."""
    state.step.add_(1)
    gnorm, part = _rule(cfg, grads, state.step)

    def leaf(p, g, m, v):
        for sl in _slices(p):
            for o, t in zip((p, m, v), part(p[sl], g[sl], m[sl], v[sl])):
                o[sl] = t

    tree_map(leaf, params, grads, state.mu, state.nu)
    return gnorm
