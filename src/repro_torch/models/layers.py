"""Shared building blocks (PyTorch counterpart of
``repro/models/layers.py``).

Every weight-bearing matmul flows through :func:`dense`, whose
``QuantConfig`` mode switches the paper's technique on:

  * mode="off"     — plain matmul (fp baseline),
  * mode="ternary" — ternarized weights and activations, exact matmul,
  * mode="cim"     — ternarized weights and activations through the SiTe
                     CiM array semantics (16-row block ADC clamp) via
                     ``core.execution.execute``; on CUDA tensors that is
                     the hand-written kernel of ``csrc/ternary_mac.cu``
                     (``csrc/ternary_exact.cu`` under an ``exact/cuda``
                     spec, the near-memory baseline).

Scales fold after the ternary MAC: output = (x_t @ w_t) * sx * sw, with
a per-tensor (default) or per-row activation scale and a per-output-
channel weight scale. Under autograd the codes carry the value-exact
straight-through estimator ``t + (w - w.detach())`` (the same for x), the
scales are detached, and the MAC's backward is the STE exact matmul of
``core.execution.execute``: the reference's quantization-aware training.
Inside a data-parallel rank (``dist.sharding.data_parallel``) the
per-tensor activation statistic is summed over the data group, so it is
the whole batch's, as the reference's partitioner takes it. On a rank of
a tensor-parallel train step the weight is a
``dist.sharding.TrainShard`` (see :func:`dense`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import ternary as tern
from repro_torch.core.execution import (CiMExecSpec, check_tp_spec, execute_row_shard,
                                        row_shard_input, row_split)
from repro_torch.core.execution import execute as exec_mac
from repro_torch.dist import collectives
from repro_torch.dist.sharding import TrainShard, VocabShard, WeightShard, data_group


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Paper-technique mode switch.

    mode: off | ternary | cim | cim_fused (see the module docstring;
      cim_fused is the fused two-dot formulation, numerically exact).
    act_scale: "per_tensor" couples every row of a batched MAC through
      one amax; "per_row" scales each (..., K) row independently, so
      fused-batch rows are numerically independent.
    exec_spec: explicit execution spec, overriding the mode-derived one.
    pre_quantized: weights were ternarized offline (quant.prepare) with
      the per-channel scale folded in; dense() recovers the codes with
      one max-reduce instead of the threshold quantizer.
    cache_dtype: KV-cache storage (orthogonal to ``mode``: the cache
      holds activations). "bf16" stores the cache in the activation
      dtype; "int8" stores symmetric int8 codes and "ternary" TWN codes
      nibble-packed two per byte, each with one f32 scale per (row,
      position) (``attention.QuantKVCache``).
    tp_reduce: how a row-parallel dense layer sums its partials under a
      TP mesh (``dist.sharding.WeightShard``): "none" the exact sum,
      "int8" the int8-compressed collective
      (``dist.collectives.compressed_psum_int8``, quantization-level
      error, inference only; the batcher sets it under ``compress_tp``).
    """
    mode: str = "off"
    block: int = 16
    adc_max: int = 8
    quantize_activations: bool = True
    act_scale: str = "per_tensor"
    corrected: bool = False
    threshold_factor: float = tern.TWN_THRESHOLD_FACTOR
    exec_spec: Optional[CiMExecSpec] = None
    pre_quantized: bool = False
    tp_reduce: str = "none"      # none | int8
    cache_dtype: str = "bf16"

    def __post_init__(self):
        if self.mode not in ("off", "ternary", "cim", "cim_fused"):
            raise ValueError(self.mode)
        if self.cache_dtype not in ("bf16", "int8", "ternary"):
            raise ValueError(
                f"unknown cache_dtype {self.cache_dtype!r} (bf16 | int8 | ternary)")
        if self.tp_reduce not in ("none", "int8"):
            raise ValueError(f"unknown tp_reduce {self.tp_reduce!r}")
        if self.act_scale not in ("per_tensor", "per_row"):
            raise ValueError(
                f"unknown act_scale {self.act_scale!r} (per_tensor | per_row)")
        if self.tp_reduce != "none" and self.mode == "off":
            raise ValueError(
                "tp_reduce compresses the quantized dense path's TP "
                "all-reduce; mode='off' runs no ternary MAC to compress")
        if self.mode == "off" and self.exec_spec is not None:
            raise ValueError(
                "exec_spec has no effect with mode='off'; pick a quantized "
                "mode (serve.engine.apply_exec_spec upgrades the mode)")

    def resolved_spec(self) -> CiMExecSpec:
        """The CiMExecSpec this config executes ternary MACs under."""
        if self.exec_spec is not None:
            return self.exec_spec
        if self.mode == "off":
            raise ValueError("mode='off' has no CiM execution spec")
        if self.mode == "ternary":
            return CiMExecSpec(formulation="exact", backend="torch",
                               block=self.block, adc_max=self.adc_max)
        if self.mode == "cim_fused":
            return CiMExecSpec(formulation="fused", backend="torch",
                               block=self.block, adc_max=self.adc_max)
        formulation = "corrected" if self.corrected else "blocked"
        backend = "torch" if self.corrected else "auto"
        return CiMExecSpec(formulation=formulation, backend=backend,
                           block=self.block, adc_max=self.adc_max)


def _ste_codes(x: torch.Tensor, axis, factor: float, group=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes in {-1,0,1} in x's dtype, detached scale). When x needs a
    gradient the codes are ``t + (x - x.detach())``: exactly t forward
    (``x + (t - x)`` would round in bf16 and move the CiM event counts),
    the identity backward. ``group``: x is a data-parallel rank's rows
    of the batch, and the per-tensor statistics are summed over it."""
    reduce = None if group is None else functools.partial(
        collectives.all_reduce, group=group)
    t, scale = tern.ternarize(x.detach(), axis=axis, factor=factor, reduce=reduce)
    if x.requires_grad and torch.is_grad_enabled():
        t = t + (x - x.detach())
    return t, scale


def _weight_codes(w: torch.Tensor, qc: QuantConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes in {-1,0,1} in w's dtype, per-output-channel scale (.., 1, N),
    detached)."""
    axes = tuple(range(w.ndim - 1))
    if qc.pre_quantized:
        # folded offline to {-s_n, 0, +s_n}: one max-reduce recovers (t, s);
        # the gradient flows through the division, as in the reference
        sw = w.abs().amax(dim=axes, keepdim=True)
        return w / torch.clamp(sw, min=1e-12), sw.detach()
    return _ste_codes(w, axes, qc.threshold_factor)


#: how :func:`accum_einsum` accumulates: None (the default) in float64;
#: True natively, on the operands as they are; False in float32 casts
_NATIVE_ACCUM: Optional[bool] = None


def set_native_accum(on: Optional[bool]) -> None:
    """Switch :func:`accum_einsum`, as the reference's switch does:
    ``True`` contracts the operands in their own dtype and returns f32,
    the reference's native form (on the card bf16 tensor-core products
    accumulate in f32, though torch rounds the result to bf16 before the
    cast, where the reference keeps f32); ``False`` casts them to f32
    first, the reference's CPU form; ``None`` restores the port's
    default, float64 (exact products, so a row's result does not depend
    on its batch)."""
    global _NATIVE_ACCUM
    _NATIVE_ACCUM = on


def accum_einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` accumulated and returned in float64 by default: the
    counterpart of the reference's f32-accumulating ``accum_einsum``, one
    step wider. Products of bf16 (or f32) values are exact in float64, so
    a row's result does not depend on the reduction order, i.e. on its
    batchmates or the shapes around it; callers round where the
    reference rounds. :func:`set_native_accum` switches to the
    reference's f32 forms."""
    if _NATIVE_ACCUM is None:
        return torch.einsum(spec, *(o.to(torch.float64) for o in ops))
    if _NATIVE_ACCUM:
        return torch.einsum(spec, *ops).to(torch.float32)
    return torch.einsum(spec, *(o.to(torch.float32) for o in ops))


def _row_shard_off(x: torch.Tensor, w: WeightShard) -> torch.Tensor:
    """A mode-"off" row shard: the rank's K slice of ``x`` (as it arrives
    from a column-parallel layer, or cut from a whole ``x``) against its
    rows, the partial in float32, the partials summed in float32 and
    rounded to x's dtype once."""
    k_local = w.w.shape[-2]
    if x.shape[-1] != k_local:
        x = x[..., w.mesh.rank * k_local:(w.mesh.rank + 1) * k_local]
    part = x.to(torch.float32) @ w.w.to(torch.float32)
    return collectives.all_reduce(part, w.mesh.group).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, qc: QuantConfig,
          bias: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None,
          tp: str = "none") -> torch.Tensor:
    """The mode-switched linear layer. x: (..., K), w: (K, N).

    Clamping specs receive the activation codes in f32, as the reference
    passes them, and the weight codes in the weight's dtype; exact specs
    take both in x's dtype (the operand-dtype dot of the reference's
    ``exact/jnp``, and the STE backward's accumulation dtype). The kernel
    backends cast the codes to int8 inside the MAC: one byte per weight
    into the kernel. Gradients reach x and w straight through the codes
    and the MAC (see the module docstring).

    ``tp`` marks how the layer parallelizes under a TP mesh, as the
    reference marks it: "col" (the output dim splits: q/k/v, gate, up),
    "row" (the contraction dim splits: o, down) or "none". It takes
    effect where ``w`` is a rank's :class:`~repro_torch.dist.sharding.
    WeightShard` (serving) or :class:`~repro_torch.dist.sharding.
    TrainShard` (training: :func:`_train_dense`). In a quantized mode the
    serving shard holds
    its part of the whole weight's codes and scale, so a column's
    statistic is the single-device one. A row shard's input arrives split over K
    (the previous column-parallel layer's output) and is gathered first
    (a copy), so the activation statistic (per tensor or per row) is
    taken over the whole row as on one device; its MAC is
    ``execution.execute_row_shard`` (the rank's half of ``execute_tp``),
    whose integer-count partials are summed exactly on the raw MAC
    output, before the cast and the scale fold (int8-compressed under
    ``qc.tp_reduce``). In mode "off" a column shard is ``x @ w`` and a
    row shard :func:`_row_shard_off` (no gather: the partials are float
    products of the rank's K slice). A whole weight runs as on one
    device."""
    if isinstance(w, TrainShard):
        if w.kind != tp:
            raise ValueError(f"a {w.kind}-parallel training shard at a tp={tp!r} call site")
        out = _train_dense(x, w, qc)
        return out if bias is None else out + bias.to(out.dtype)
    shard = isinstance(w, WeightShard)
    if shard and w.kind != tp:
        raise ValueError(f"a {w.kind}-parallel weight shard at a tp={tp!r} call site")
    if qc.mode == "off":
        if shard and w.kind == "row":
            out = _row_shard_off(x, w)
        else:
            out = x @ (w.w if shard else w).to(x.dtype)
    else:
        if shard and w.kind == "row" and x.shape[-1] != w.k:
            x = collectives.all_gather(x, w.mesh.group, dim=-1)
        w_t, sw = (w.w, w.scale) if shard else _weight_codes(w, qc)
        if qc.quantize_activations:
            axis = (x.ndim - 1,) if qc.act_scale == "per_row" else None
            # a data-parallel rank's per-tensor statistic is the whole
            # batch's, as under the reference's batch sharding: the one
            # place in the model that reads the data-parallel switch
            group = data_group() if axis is None else None
            x_t, sx = _ste_codes(x, axis, qc.threshold_factor, group)
        else:
            x_t, sx = x, torch.ones((), dtype=x.dtype, device=x.device)
        spec = qc.resolved_spec()
        if shard:
            check_tp_spec(spec)
        if shard and w.kind == "row":
            # the partials in f32 for every spec: integer counts, summed
            # exactly, rounded to x's dtype once below (as one device's
            # accumulation rounds once)
            out = execute_row_shard(spec, x_t.to(torch.float32), w_t, w.mesh,
                                    compressed=qc.tp_reduce == "int8")
        elif spec.resolve(x.device).clamps:
            out = exec_mac(spec, x_t.to(torch.float32), w_t, generator=generator)
        else:
            out = exec_mac(spec, x_t.to(x.dtype), w_t.to(x.dtype),
                           generator=generator)
        # fold scales in the activation dtype, as the reference does
        out = out.to(x.dtype) * (sx * sw).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _train_dense(x: torch.Tensor, w: TrainShard, qc: QuantConfig) -> torch.Tensor:
    """:func:`dense` on a rank's training shard, every collective an
    autograd function (``dist.collectives``), so the step's gradients
    are the single device's.

    Column-parallel: ``x`` is replicated and has entered the layer
    through ``collectives.copy`` at its caller (once for every consumer
    of it: q/k/v, gate/up); the codes are ``_weight_codes`` of the
    rank's columns, which is the single device's slice (a column's
    statistic runs over K, whole here), and the MAC (#1 on the card) runs
    on them. Row-parallel: the input is gathered over the ranks where it
    arrives split (``collectives.gather``), so the activation statistic
    is the whole row's; the weight's K shards are gathered too and
    ternarized whole, so the rank's codes are its rows of the single
    device's codes bit for bit (a split sum of the per-column statistic
    would equal it only up to the order of its float sums, and flip a
    code at a near tie); the rank's MAC runs on its whole blocks of K,
    and the partial counts are summed by ``collectives.reduce`` before
    the scale fold, exactly, as ``execution.execute_row_shard`` sums
    them. Mode "off": a column shard is ``x @ w``, a row shard its K
    slice's float32 partial, summed by ``collectives.reduce`` and
    rounded once. The sensing-error channel and the int8-compressed sum
    (``qc.tp_reduce``) do not run on a training shard: they raise."""
    mesh = w.mesh
    if qc.tp_reduce != "none":
        raise ValueError("the int8-compressed TP sum (tp_reduce) serves only; a train "
                         "step sums its partials exactly")
    if qc.mode == "off":
        if w.kind == "col":
            return x @ w.w.to(x.dtype)
        k_local = w.w.shape[-2]
        if x.shape[-1] != k_local:
            x = row_shard_input(x, k_local, mesh)
        part = x.to(torch.float32) @ w.w.to(torch.float32)
        return collectives.reduce(part, mesh.group).to(x.dtype)
    if w.kind == "row":
        k_local = w.w.shape[-2]
        if x.shape[-1] != w.k:
            # each rank's gradient of the whole input is its K blocks' part:
            # partial, unless those blocks are the rank's own columns of it
            x = collectives.gather(x, mesh.group, dim=-1,
                                   partial=x.shape[-1] != k_local)
        whole = collectives.gather(w.w, mesh.group, dim=-2).narrow(-2, 0, w.k)
        w_t, sw = _weight_codes(whole, qc)
        w_t = row_split(w_t, qc.block, mesh.size, mesh.rank)
    else:
        w_t, sw = _weight_codes(w.w, qc)
    if qc.quantize_activations:
        axis = (x.ndim - 1,) if qc.act_scale == "per_row" else None
        group = data_group() if axis is None else None
        x_t, sx = _ste_codes(x, axis, qc.threshold_factor, group)
    else:
        x_t, sx = x, torch.ones((), dtype=x.dtype, device=x.device)
    spec = qc.resolved_spec()
    check_tp_spec(spec)
    if w.kind == "row":
        x_loc = row_shard_input(x_t.to(torch.float32), w_t.shape[-2], mesh)
        part = exec_mac(spec, x_loc, w_t)
        out = collectives.reduce(part.to(torch.float32), mesh.group)
    elif spec.resolve(x.device).clamps:
        out = exec_mac(spec, x_t.to(torch.float32), w_t)
    else:
        out = exec_mac(spec, x_t.to(x.dtype), w_t.to(x.dtype))
    return out.to(x.dtype) * (sx * sw).to(x.dtype)


def tp_input(x: torch.Tensor, w) -> torch.Tensor:
    """``x`` as it enters the column-parallel layers that read it (q/k/v,
    gate/up, ``w_in``): through ``collectives.copy`` where ``w`` is a
    column-parallel training shard, once for all of them, so the
    rank-partial gradients of the replicated ``x`` are summed once over
    the model group; else ``x`` itself."""
    if isinstance(w, TrainShard) and w.kind == "col":
        return collectives.copy(x, w.mesh.group)
    return x


# ---------------------------------------------------------------------------
# Norms / activations / embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (population variance), rounded
    to x's dtype before the affine, as the reference's. No block calls
    it: the reference's blocks all use :func:`rms_norm`."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma.to(x.dtype) + beta.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    # x * 1/(1 + exp(-x)), each step rounded in the input dtype:
    # bit-identical to the reference's bf16 silu on the CPU
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return silu(x_gate) * x_up


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (V, D) for ``tokens``; a rank's vocabulary
    shard (``dist.sharding.VocabShard``) looks up its rows and sums the
    ranks' lookups."""
    if isinstance(table, VocabShard):
        return table.lookup(tokens)
    return table[tokens]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, Dh), positions: (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_dense_weight(generator: torch.Generator, shape, dtype,
                      device) -> torch.Tensor:
    """N(0, 1/fan_in) weights, fan_in = shape[-2] (the contraction dim).
    A stacked (L, K, N) weight is drawn one layer at a time into its
    ``dtype`` stack, so the f32 draw never holds more than one layer.
    On the meta device (shapes alone) nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if len(shape) == 2:
        w = torch.randn(shape, generator=generator, device=device) * shape[-2] ** -0.5
        return w.to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = init_dense_weight(generator, shape[1:], dtype, device)
    return out


def init_mlp(generator: torch.Generator, d: int, f: int, dtype, device,
             lead=()):
    """SwiGLU weights ``w_gate``/``w_up`` (d, f) and ``w_down`` (f, d),
    stacked (lead..., K, N) for a layer stack."""
    return {name: init_dense_weight(generator, lead + shape, dtype, device)
            for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                                ("w_down", (f, d)))}


def mlp(params, x: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    x = tp_input(x, params["w_gate"])
    g = dense(x, params["w_gate"], qc, tp="col")
    u = dense(x, params["w_up"], qc, tp="col")
    return dense(swiglu(g, u), params["w_down"], qc, tp="row")
