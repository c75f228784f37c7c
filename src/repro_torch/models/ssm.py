"""Mamba2 — the SSD (state-space duality) layer, chunked scan and O(1)
decode (port of ``repro/models/ssm.py``).

The minimal SSD form of Mamba-2 (Dao & Gu, arXiv:2405.21060), per head:

  h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T
  y_t = C_t h_t + D x_t

Without a cache it runs the chunked algorithm (a quadratic term inside
each chunk, a recurrence over chunk states; a loop over chunks takes the
place of ``lax.scan``). With a cache it continues a sequential
recurrence from ``cache.state`` for any S >= 1, the conv window seeded
from ``cache.conv``, and writes both leaves in place (``copy_`` into the
caller's tensors, as ``attention.write_cache_rows`` writes k/v), so a
captured step and the looped baseline's row views stay bound to the
batcher's storage.

The projections route through ``layers.dense`` (the ternary/CiM modes
apply: kernel #1 on the card); the recurrence, the conv and the gating
are activation math in plain PyTorch, as they are ``jnp`` outside any
Pallas kernel in the reference. ``A_log``, ``D`` and ``dt_bias`` stay
float32 under a bf16 config (:data:`F32_LEAVES`), and the decay and
``dt`` are computed in float32, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import TrainShard, WeightShard
from repro_torch.models import layers as L

# mamba leaves that the reference keeps in float32 under any config dtype
F32_LEAVES = ("A_log", "D", "dt_bias")


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_channels) rolling window of raw conv inputs
    state: torch.Tensor  # (B, H, P, N) ssm state

    @staticmethod
    def zeros(batch: int, cfg: ArchConfig, device=None,
              layers: Optional[int] = None):
        """Zero f32 conv window and state (f32 under any cache dtype, as in
        the reference); stacked for the layer stack, every leaf gains a
        leading (layers,) axis."""
        lead = () if layers is None else (layers,)
        conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
        return SSMCache(
            torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, conv_ch), device=device),
            torch.zeros(lead + (batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), device=device))


def init_mamba2(generator: torch.Generator, cfg: ArchConfig, dtype, device,
                layers: int):
    """One stacked (layers, ...) set of mamba2 params, seeded draws; the
    leaves of :data:`F32_LEAVES` are float32, the others ``dtype``."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    g, n, h = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads
    conv_ch = di + 2 * g * n
    ones = lambda *shape: torch.ones((layers,) + shape, device=device)
    params = {
        # in_proj -> [z (di), x (di), B (g*n), C (g*n), dt (h)]
        "w_in": L.init_dense_weight(generator, (layers, d, 2 * di + 2 * g * n + h),
                                    dtype, device),
        "conv_w": torch.randn((layers, cfg.ssm_conv_width, conv_ch),
                              generator=generator, device=device) * 0.1,
        "conv_b": torch.zeros((layers, conv_ch), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)).expand(layers, h),
        "D": ones(h),
        "dt_bias": torch.zeros((layers, h), device=device),
        "norm": ones(di),
        "w_out": L.init_dense_weight(generator, (layers, di, d), dtype, device),
    }
    return {k: v.to(torch.float32 if k in F32_LEAVES else dtype).contiguous()
            for k, v in params.items()}


class _Softplus(torch.autograd.Function):
    """:func:`softplus` with the reference's gradient: ``logaddexp``'s
    jvp, g · exp(x − softplus(x)) = g · sigmoid(x), 0.5 at x == 0 (the
    autograd of ``clamp(x, min=0)`` gives 1.0 there)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` computed as JAX does:
    max(x, 0) + log1p(exp(-|x|)) (``torch.nn.functional.softplus``
    returns x above a threshold of 20 instead), with its gradient."""
    return _Softplus.apply(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in x's dtype, each step rounded as the
    reference's. x: (B, S, C), w: (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD. x: (b, l, h, p), dt: (b, l, h), A: (h,) negative decay
    rates, B, C: (b, l, g, n). Returns y (b, l, h, p) and the final state
    (b, h, p, n)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert l % chunk == 0, (l, chunk)
    nc = l // chunk
    Bc = B.repeat_interleave(h // g, dim=2).reshape(b, nc, chunk, h, n)
    Cc = C.repeat_interleave(h // g, dim=2).reshape(b, nc, chunk, h, n)
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)

    cum = torch.cumsum(dtc * A, dim=2)               # (b, nc, c, h), within-chunk
    # within-chunk: L[i, j] = exp(cum_i - cum_j) for j <= i. The argument is
    # masked before exp: masked (j > i) entries are positive and overflow
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    delta = torch.where(mask[None, None, :, :, None],
                        cum[:, :, :, None, :] - cum[:, :, None, :, :], -1e30)
    att = torch.einsum("bzihn,bzjhn->bzijh", Cc, Bc) * torch.exp(delta)
    y_diag = torch.einsum("bzijh,bzjh,bzjhp->bzihp", att, dtc, xc)

    # each chunk's state: every position decayed to the chunk's end
    chunk_sum = cum[:, :, -1, :]                     # (b, nc, h)
    state_w = torch.exp(chunk_sum[:, :, None, :] - cum)
    states = torch.einsum("bzch,bzch,bzchn,bzchp->bzhpn", state_w, dtc, Bc, xc)

    # the recurrence over chunks: the state entering each chunk
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    entering = []
    for z in range(nc):
        entering.append(state)
        state = state * torch.exp(chunk_sum[:, z])[:, :, None, None] + states[:, z]
    h_prevs = torch.stack(entering, dim=1)           # (b, nc, h, p, n)
    y_carry = torch.einsum("bzchn,bzhpn,bzch->bzchp", Cc, h_prevs, torch.exp(cum))

    y = (y_diag + y_carry).reshape(b, l, h, p)
    return y + x * D[None, None, :, None], state


def _split_xbc(xbc: torch.Tensor, cfg: ArchConfig):
    """conv output (B, S, di + 2gn) -> x (B, S, H, P), B and C (B, S, g, n),
    all float32."""
    b, s, _ = xbc.shape
    di, g, n = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state
    return (xbc[..., :di].reshape(b, s, cfg.ssm_n_heads, cfg.ssm_head_dim).float(),
            xbc[..., di:di + g * n].reshape(b, s, g, n).float(),
            xbc[..., di + g * n:].reshape(b, s, g, n).float())


def mamba2_block(params, x: torch.Tensor, cfg: ArchConfig,
                 cache: Optional[SSMCache] = None,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """x: (B, S, D). Without a cache: the chunked form, S padded to a whole
    chunk. With one layer's :class:`SSMCache`: any S >= 1 (S = 1 is the
    O(1) decode step), continued from the cache, which is written in place
    and returned.

    ``valid`` (B, S) marks real columns of a left-padded batched prefill:
    the raw conv inputs and dt of pad columns are zeroed, so they match
    the zero conv window of an unpadded run and freeze the state
    (exp(0·A) = 1, no B·x injection).

    On a rank of a TP mesh ``cfg`` gives the rank's SSM widths
    (``dist.sharding.local_config``) and the params are its shards:
    ``w_in``'s columns of its heads (B and C of its groups), its conv
    channels and head vectors, ``w_out`` row-parallel; the cache holds
    its channels and heads. The scan runs head-local, and the gated
    input of the norm is gathered over the ranks first. In a train step
    (``dist.sharding.TrainShard`` weights) ``x`` enters ``w_in`` through
    ``collectives.copy``, the gated input is gathered by
    ``collectives.gather`` and the normed row enters ``w_out`` through a
    copy; ``w_in``'s and the conv's B and C, held whole by every rank of
    one group, sum their partial gradients over the ranks
    (``LeafSplit.view_of``)."""
    b, s, _ = x.shape
    di, g, n = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state
    h = cfg.ssm_n_heads
    qc = cfg.quant

    w_in = params["w_in"]
    train = isinstance(w_in, TrainShard)
    zxbcdt = L.dense(L.tp_input(x, w_in), w_in, qc, tp="col")
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = softplus(zxbcdt[..., -h:].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    if cache is None:
        xs, B_, C_ = _split_xbc(
            L.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"])), cfg)
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        if pad:
            xs, B_, C_ = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (xs, B_, C_))
            dt = F.pad(dt, (0, 0, 0, pad))
        y, _ = _ssd_chunked(xs, dt, A, B_, C_, params["D"], chunk)
        y = y[:, :s]
    else:
        if valid is not None:
            xbc = torch.where(valid[:, :, None], xbc, torch.zeros((), dtype=xbc.dtype,
                                                                  device=xbc.device))
            dt = torch.where(valid[:, :, None], dt, 0.0)
        # the last W-1 raw conv inputs ride in cache.conv (f32: the
        # reference's concatenate promotes), so the conv runs in f32 here
        conv_in = torch.cat([cache.conv, xbc.to(cache.conv.dtype)], dim=1)
        w = params["conv_w"]
        conv_out = sum(conv_in[:, i:i + s, :] * w[i] for i in range(w.shape[0]))
        xs, B_, C_ = _split_xbc(L.silu(conv_out + params["conv_b"]), cfg)
        Bh = B_.repeat_interleave(h // g, dim=2)       # (b, s, h, n)
        Ch = C_.repeat_interleave(h // g, dim=2)
        dA = torch.exp(dt * A)                          # (b, s, h)
        state = cache.state
        ys = []
        for t in range(s):
            state = (state * dA[:, t, :, None, None]
                     + dt[:, t, :, None, None] * Bh[:, t, :, None, :] * xs[:, t, :, :, None])
            # C·state reduces over N in float64, where the f32 products are
            # exact: a row's y does not depend on the batch it rides in
            # (a GPU reduction's order may change with B)
            ys.append((Ch[:, t, :, None, :].double() * state.double()).sum(-1).float())
        y = torch.stack(ys, dim=1) + xs * params["D"][None, None, :, None]
        cache.conv.copy_(conv_in[:, s:])
        cache.state.copy_(state)

    y = y.reshape(b, s, di).to(x.dtype)
    y = y * L.silu(z.float()).to(y.dtype)
    if train:
        # as below, under autograd; the normed row then feeds the rank's
        # rows of w_out, so its partial gradients are summed by a copy
        y = L.rms_norm(collectives.gather(y, w_in.mesh.group, dim=-1), params["norm"])
        y = collectives.copy(y, w_in.mesh.group)
    else:
        if isinstance(w_in, WeightShard):
            # the gated norm is a statistic over the whole d_inner: gather the
            # ranks' heads (a copy, in head order) and norm whole on every rank
            y = collectives.all_gather(y, w_in.mesh.group, dim=-1)
        y = L.rms_norm(y, params["norm"])
    return L.dense(y, params["w_out"], qc, tp="row"), cache
