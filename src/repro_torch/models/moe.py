"""Token-choice top-k Mixture-of-Experts, deepseek-v2 / grok-1 style (port
of ``repro/models/moe.py``: the reference's grouped dispatch, G routing
groups, one per data shard; under a TP mesh the experts split over the
ranks, see :func:`moe_block`).

Dispatch is the reference's capacity-buffer formulation: the tokens are
cut into G groups of whole batch rows (``dist.sharding.routing_groups``:
the enabled batch divisor, 1 inside a data-parallel rank), and within
its group each (token, expert) assignment takes the next free row of its
expert's ``cap = moe_capacity(T / G)`` rows in the group's (E·cap + 1, D)
buffer; assignments past ``cap`` go to the group's overflow row and are
dropped (the residual path keeps the token), the experts run batched
over E with the groups' rows side by side, and the outputs are gathered
back by slot and combined with the router gates. The cumsum, scatter,
gather and combine never cross a group: G groups in one call give
the G single-group calls on the groups' rows, bit for bit. Every shape is
fixed by (tokens, groups, config), never by the routing: a decode step
that routes is captured into a CUDA graph like any other.

The routed-expert products are plain PyTorch, as they are ``jnp``
outside any Pallas kernel in the reference: per expert, per-out-channel
ternarized weights (:func:`_tern3`) and, under the CiM modes, the
reference's two-product form p = x·w, m = |x|·|w|, each rounded to the
activation dtype, combined as min((m+p)/2, 2^14) − min((m−p)/2, 2^14).
They accumulate in float64 so that a token's result does not depend on
its slot in the buffer or on ``cap``, both of which change between a
batched prefill and a solo ``generate()``. A float64 copy of a whole
expert stack does not fit the card (10 GB for one deepseek-v2 layer's
``w_gate``, 13 GB for grok-1's), so the experts go through in chunks of
as many as fit :data:`CHUNK_BYTES` of float64 weights, at least one
(grok-1's one expert matrix is 1.6 GB in float64). The shared experts
are an ordinary MLP of dense layers (kernel #1 on the card).

Under autograd the expert weights train through :func:`_tern3`'s
straight-through codes, as the reference's do; the products' backward
is autograd's, in float64.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import ternary as tern
from repro_torch.dist import collectives
from repro_torch.dist.sharding import ExpertShard, routing_groups
from repro_torch.models import layers as L

# moe leaves that the reference keeps in float32 under any config dtype
F32_LEAVES = ("router",)
# float64 weight bytes a chunk of experts takes in _expert_matmul (or one
# expert's, where that is more)
CHUNK_BYTES = 1 << 30
_CLAMP = 2.0 ** 14


def moe_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Rows per expert in the dispatch buffer (at least 8)."""
    cap = int(n_tokens * cfg.top_k * cfg.moe_capacity_factor / cfg.n_experts)
    return max(cap, 8)


def init_moe(generator: torch.Generator, cfg: ArchConfig, dtype, device,
             layers: int) -> Dict[str, torch.Tensor]:
    """Stacked (layers, ...) seeded weights: the router (D, E) in float32
    (:data:`F32_LEAVES`), the expert stacks ``w_gate``/``w_up`` (E, D, F)
    and ``w_down`` (E, F, D), and the shared experts' MLP of width
    ``expert_d_ff * n_shared_experts`` when the config has any."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    lead = (layers,)
    p = {name: L.init_dense_weight(
            generator, lead + shape,
            torch.float32 if name in F32_LEAVES else dtype, device)
         for name, shape in (("router", (d, e)), ("w_gate", (e, d, f)),
                             ("w_up", (e, d, f)), ("w_down", (e, f, d)))}
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(generator, d, f * cfg.n_shared_experts, dtype,
                                 device, lead)
    return p


def _tern3(w: torch.Tensor) -> torch.Tensor:
    """Per-expert, per-out-channel ternarization of (E, K, N), the scale
    folded into the ternary weight, with the reference's value-exact STE:
    the codes from ``w.detach()``, ``t + (w - w.detach())`` where w needs
    a gradient (exactly t forward, the identity backward), times the
    detached scale."""
    t, scale = tern.ternarize(w.detach(), axis=(1,))
    if w.requires_grad and torch.is_grad_enabled():
        t = t + (w - w.detach())
    return t * scale


def _expert_matmul(x: torch.Tensor, w: torch.Tensor, qc: L.QuantConfig
                   ) -> torch.Tensor:
    """x (E, C, K) against the expert stack w (E, K, N): (E, C, N) in x's
    dtype, the reference's ``emm`` (see the module docstring), over
    chunks of experts each ternarized and widened to float64 on its own
    (ternarization is per expert, so a chunk's codes are the stack's).
    ``|w64|`` is taken out of place: ``p``'s backward keeps ``w64``."""
    e, k, n = w.shape
    step = max(1, CHUNK_BYTES // (8 * k * n))
    out = torch.empty((e, x.shape[1], n), dtype=x.dtype, device=x.device)
    for e0 in range(0, e, step):
        xc, wc = x[e0:e0 + step], w[e0:e0 + step]
        if qc.mode != "off":
            wc = _tern3(wc)
        w64 = wc.to(x.dtype).to(torch.float64)
        p = torch.matmul(xc.to(torch.float64), w64).to(x.dtype)
        if qc.mode not in ("cim", "cim_fused"):
            out[e0:e0 + step] = p
            continue
        m = torch.matmul(xc.abs().to(torch.float64), w64.abs()).to(x.dtype)
        pf, mf = p.to(torch.float32), m.to(torch.float32)
        out[e0:e0 + step] = (torch.clamp((mf + pf) * 0.5, max=_CLAMP)
                             - torch.clamp((mf - pf) * 0.5, max=_CLAMP))
    return out


def _expert_ffn(params, xe: torch.Tensor, qc: L.QuantConfig) -> torch.Tensor:
    """xe (E, C, D) -> (E, C, D): every expert's SwiGLU FFN on its rows."""
    g = _expert_matmul(xe, params["w_gate"], qc)
    u = _expert_matmul(xe, params["w_up"], qc)
    return _expert_matmul(L.swiglu(g, u), params["w_down"], qc)


def route(params, xt: torch.Tensor, cfg: ArchConfig):
    """Routing of tokens xt (T, D), or of G groups of tokens (G, Tg, D):
    returns ``(gates, slot, keep)`` over each group's Tg·K assignments in
    token order (token i's top-k at [i·K, (i+1)·K)), shaped (T·K,) or
    (G, Tg·K): the renormalized top-k gates (f32), each assignment's row
    in its group's (E·cap + 1, D) buffer, ``cap = moe_capacity(Tg)``
    (E·cap, the overflow row, where dropped) and whether it was kept.
    The router logits come from x against the router cast to x's dtype,
    accumulated in float64, then softmax, top-k and renormalization;
    the buffer positions come from a cumsum within the group."""
    grouped = xt.dim() == 3
    if not grouped:
        xt = xt[None]
    g, t = xt.shape[:2]
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(t, cfg)
    logits = L.accum_einsum("gtd,de->gte", xt, params["router"].to(xt.dtype))
    top_g, top_e = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(g, t * k)
    # position within the expert's buffer: a cumsum over one-hot rows
    onehot = (flat_e[..., None] == torch.arange(e, device=xt.device)).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    gates = top_g.reshape(g, t * k).to(torch.float32)
    if not grouped:
        return gates[0], slot[0], keep[0]
    return gates, slot, keep


def moe_block(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): route each of G groups of whole rows
    (``dist.sharding.routing_groups(B)``), dispatch into its capacity
    buffer, run the experts, gather back and combine, plus the shared
    experts.

    Each token's K contributions are summed in rank order in x's dtype,
    as the reference's in-order scatter-add (``out.at[tok_id].add``)
    rounds them; no atomic ``index_add_``, whose bf16 sums would depend
    on timing on the card.

    On a rank of a TP mesh the expert stacks are its
    :class:`~repro_torch.dist.sharding.ExpertShard` s: the routing is
    computed from the replicated activations on every rank, the rank
    runs its experts' rows of every group's buffer, the outputs are
    gathered over the expert dim, and every rank combines them in the
    order above; the shared experts' MLP splits column and row as the
    dense MLP. In a train step (``ExpertShard.train``) the buffer enters
    the rank's experts through ``collectives.copy`` and their outputs are
    gathered by ``collectives.gather``, so each rank's experts take
    their gradients and the buffer's partial ones are summed."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = routing_groups(b)
    t = b * s
    tg = t // g
    cap = moe_capacity(tg, cfg)
    xt = x.reshape(g, tg, d)
    gates, slot, keep = route(params, xt, cfg)
    rows = torch.arange(g, device=x.device)[:, None]
    buf = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=x.device)
    # rows are unique within a group but for the overflow row, discarded
    buf[rows, slot] = xt.repeat_interleave(k, dim=1)

    def experts(params_, first, count):
        # experts [first, first + count) on every group's rows of their
        # buffers, side by side: (count, G·cap, D) -> (G, count, cap, D)
        xe = buf[:, first * cap:(first + count) * cap].reshape(g, count, cap, d)
        ye = _expert_ffn(params_, xe.transpose(0, 1).reshape(count, g * cap, d),
                         cfg.quant)
        return ye.reshape(count, g, cap, d)

    shard = params["w_gate"]
    if isinstance(shard, ExpertShard):
        # this rank's experts, then every expert's rows gathered in expert
        # order (a copy)
        mine = {name: params[name].w for name in ("w_gate", "w_up", "w_down")}
        if shard.train:
            # a train step: the replicated buffer enters the rank's experts
            # through a copy, the outputs are gathered under autograd
            buf = collectives.copy(buf, shard.mesh.group)
            ye = collectives.gather(experts(mine, shard.first, shard.w.shape[0]),
                                    shard.mesh.group, dim=0)
        else:
            ye = collectives.all_gather(experts(mine, shard.first, shard.w.shape[0]),
                                        shard.mesh.group, dim=0)
    else:
        ye = experts(params, 0, e)
    ye = torch.cat([ye.transpose(0, 1).reshape(g, e * cap, d),
                    ye.new_zeros((g, 1, d))], dim=1)
    weight = (gates * keep.to(torch.float32)).to(ye.dtype)
    contrib = (ye[rows, slot] * weight[..., None]).reshape(g, tg, k, d)
    out = torch.zeros_like(xt)
    for j in range(k):
        out = out + contrib[:, :, j]
    out = out.reshape(t, d)
    if cfg.n_shared_experts:
        out = out + L.mlp(params["shared"], x.reshape(t, d), cfg.quant)
    return out.reshape(b, s, d)


def router_aux_loss(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style), the reference's: E ·
    Σ_e (share of tokens whose top-1 is e) · (mean gate of e), over x
    (B, S, D) against the f32 router. ``train_step`` does not add it, as
    the reference's does not."""
    b, s, d = x.shape
    logits = x.reshape(b * s, d).to(torch.float32) @ params["router"]
    gates = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(gates, dim=-1)
    me = torch.nn.functional.one_hot(top1, cfg.n_experts).to(torch.float32).mean(0)
    pe = gates.mean(0)
    return cfg.n_experts * torch.sum(me * pe)
