"""Project the repo's own registry architectures through the CiM system
model — the workload the paper never ran.

``arch_gemms`` maps any :class:`repro_torch.configs.base.ArchConfig` to the
per-forward weight-bearing GEMMs that would execute inside CiM arrays
(DESIGN.md §5: attention QKV/O, MLP and expert FFN weights, MLA
low-rank factors, SSM in/out projections; routers, norms, embeddings
and activation-activation contractions stay digital). ``project`` runs
one (arch, shape) cell through the macro model on a chosen
:class:`~repro_torch.hw.array.ArraySpec` and reports projected throughput and
energy against the iso-capacity and iso-area NM baselines — the same
comparison the paper makes for AlexNet/LSTM (Figs 12/13), now for the
actual transformer / SSM / hybrid / MoE / encdec / VLM configs.

Token accounting per shape kind: ``prefill``/``train`` process
``batch x seq`` tokens per forward (train is costed as its forward pass
— the CiM macro is a weight-stationary inference engine; backward stays
on the digital side), ``decode`` processes ``batch`` tokens per step.
Encoder frames (whisper) and image patches (llava) are separate token
bases that only flow at prefill; at decode their projections are cached.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.hw.array import ArraySpec, array_cost
from repro_torch.hw.macro import (
    GemmLayer,
    MacroSpec,
    PAPER_MACRO,
    iso_area_nm_arrays,
    layer_cost,
)


@dataclasses.dataclass(frozen=True)
class WeightGemm:
    """One weight matrix of an architecture, with its execution count
    per forward pass and the token basis its M dimension scales with."""
    name: str
    k: int
    n: int
    count: int = 1          # executions per forward (usually n_layers)
    basis: str = "tokens"   # tokens | encoder | image


def _attn_gemms(cfg, prefix: str = "attn.") -> List[Tuple[str, int, int]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.mla:
        qk_all = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        out = []
        if cfg.q_lora_rank:
            out += [(prefix + "wq_a", d, cfg.q_lora_rank),
                    (prefix + "wq_b", cfg.q_lora_rank, cfg.n_heads * qk_all)]
        else:
            out += [(prefix + "wq", d, cfg.n_heads * qk_all)]
        out += [
            (prefix + "wkv_a", d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            (prefix + "wkv_b", cfg.kv_lora_rank,
             cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            (prefix + "wo", cfg.n_heads * cfg.v_head_dim, d),
        ]
        return out
    return [
        (prefix + "wq", d, cfg.n_heads * hd),
        (prefix + "wk", d, cfg.n_kv_heads * hd),
        (prefix + "wv", d, cfg.n_kv_heads * hd),
        (prefix + "wo", cfg.n_heads * hd, d),
    ]


def _ffn_gemms(cfg, prefix: str = "ffn.") -> List[Tuple[str, int, int]]:
    d, f = cfg.d_model, cfg.d_ff
    return [(prefix + "gate", d, f), (prefix + "up", d, f),
            (prefix + "down", f, d)]


def _expert_gemms(cfg) -> List[Tuple[str, int, int]]:
    d, f = cfg.d_model, cfg.expert_d_ff
    return [("expert.gate", d, f), ("expert.up", d, f), ("expert.down", f, d)]


def _ssm_gemms(cfg, prefix: str = "ssm.") -> List[Tuple[str, int, int]]:
    d, di = cfg.d_model, cfg.ssm_d_inner
    in_width = 2 * di + 2 * cfg.ssm_n_groups * cfg.ssm_state + cfg.ssm_n_heads
    return [(prefix + "in_proj", d, in_width), (prefix + "out_proj", di, d)]


def arch_gemms(cfg) -> List[WeightGemm]:
    """The weight-bearing GEMMs of one forward pass of ``cfg``."""
    L = cfg.n_layers
    out: List[WeightGemm] = []
    if cfg.family in ("dense", "moe", "encdec", "vlm"):
        out += [WeightGemm(n, k, w, L) for n, k, w in _attn_gemms(cfg)]
        if cfg.n_experts:
            # router stays digital; each token activates top_k routed +
            # the shared experts (MoE capacity dropping ignored: the
            # projection costs the steady-state routed load)
            active = cfg.top_k + cfg.n_shared_experts
            out += [WeightGemm(n, k, w, L * active)
                    for n, k, w in _expert_gemms(cfg)]
        else:
            out += [WeightGemm(n, k, w, L) for n, k, w in _ffn_gemms(cfg)]
    elif cfg.family == "ssm":
        out += [WeightGemm(n, k, w, L) for n, k, w in _ssm_gemms(cfg)]
    elif cfg.family == "hybrid":
        out += [WeightGemm(n, k, w, L) for n, k, w in _ssm_gemms(cfg)]
        shared = max(1, L // cfg.hybrid_attn_every)
        out += [WeightGemm(n, k, w, shared)
                for n, k, w in _attn_gemms(cfg, "shared_attn.")]
        out += [WeightGemm(n, k, w, shared)
                for n, k, w in _ffn_gemms(cfg, "shared_ffn.")]
    else:
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")
    if cfg.family == "encdec":
        d, hd = cfg.d_model, cfg.resolved_head_dim
        # cross attention: q/o per decoded token; k/v once per encoder
        # frame (cached across decode steps)
        out += [
            WeightGemm("cross.wq", d, cfg.n_heads * hd, L),
            WeightGemm("cross.wo", cfg.n_heads * hd, d, L),
            WeightGemm("cross.wk", d, cfg.n_heads * hd, L, basis="encoder"),
            WeightGemm("cross.wv", d, cfg.n_heads * hd, L, basis="encoder"),
        ]
        E = cfg.n_encoder_layers
        out += [WeightGemm(n, k, w, E, basis="encoder")
                for n, k, w in _attn_gemms(cfg, "enc.attn.")]
        out += [WeightGemm(n, k, w, E, basis="encoder")
                for n, k, w in _ffn_gemms(cfg, "enc.ffn.")]
    if cfg.family == "vlm":
        out.append(WeightGemm("projector", cfg.d_vision, cfg.d_model, 1,
                              basis="image"))
    if cfg.quantize_unembed:
        out.append(WeightGemm("unembed", cfg.d_model, cfg.vocab, 1))
    return out


def _token_bases(cfg, shape) -> Dict[str, int]:
    decode = shape.kind == "decode"
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    return {
        # the decoder stream sees the full sequence (incl. image tokens)
        "tokens": shape.batch * (1 if decode else shape.seq),
        "encoder": 0 if decode else shape.batch * getattr(cfg, "encoder_seq", 0),
        "image": 0 if decode else shape.batch * n_img,
    }


def workload_layers(cfg, shape) -> List[Tuple[GemmLayer, int]]:
    """(GemmLayer with resolved M, execution count) for one forward of
    (cfg, shape); zero-M bases (e.g. the encoder at decode) drop out."""
    bases = _token_bases(cfg, shape)
    out = []
    for g in arch_gemms(cfg):
        m = bases[g.basis]
        if m > 0:
            out.append((GemmLayer(g.name, m, g.k, g.n), g.count))
    return out


def _resolve(arch, shape):
    # registry import is lazy: repro_torch.hw itself imports no torch
    from repro_torch.models.registry import SHAPES, get_config

    cfg = get_config(arch) if isinstance(arch, str) else arch
    if isinstance(shape, str):
        try:
            shape = SHAPES[shape]
        except KeyError:
            raise KeyError(
                f"unknown shape {shape!r} (known: {list(SHAPES)})") from None
    return cfg, shape


def project(arch, shape, array: ArraySpec,
            macro: MacroSpec = PAPER_MACRO,
            calibration=None) -> Dict[str, object]:
    """Run one (arch, shape) cell through the system model on ``array``.

    arch: registry id ("yi-34b") or an ArchConfig; shape: registry shape
    name ("decode_32k") or a ShapeCell. Returns a JSON-ready dict with
    the CiM macro's projected time/energy/throughput and the speedup /
    energy-reduction against the iso-capacity and iso-area NM baselines
    built from the same technology.

    ``calibration``: a fitted cost table (``repro_torch.profile.calibrate.
    CalibrationTable`` — anything with ``predict_gemm_us(m, k, n)`` and
    ``version``/``backend`` attributes; a table either package saved).
    When given, the same workload is additionally costed through the
    *measured* kernel fits (on the card: the port's CUDA kernels) and
    reported under ``out["calibrated"]`` next to the analytic CiM
    numbers — the measured-vs-modeled split DESIGN.md §11 describes.
    """
    cfg, shape = _resolve(arch, shape)
    layers = workload_layers(cfg, shape)

    def total(a: ArraySpec, n_arrays: int):
        cost = array_cost(a)
        t = e = 0.0
        macs = 0
        for layer, count in layers:
            lt, le = layer_cost(layer, a, n_arrays, macro, cost=cost)
            t += lt * count
            e += le * count
            macs += layer.macs * count
        return t, e, macs

    t_cim, e_cim, macs = total(array, macro.n_arrays)
    nm = array.with_design("NM")
    t_ic, e_ic, _ = total(nm, macro.n_arrays)
    nm_arrays_ia = iso_area_nm_arrays(array, macro)
    t_ia, e_ia, _ = total(nm, nm_arrays_ia)
    tokens = _token_bases(cfg, shape)["tokens"]
    calibrated = None
    if calibration is not None:
        if not getattr(calibration, "kernels", True):
            # an engine-only trace (e.g. launch/serve --profile) fits no
            # kernels — say so instead of KeyError-ing per layer below
            raise ValueError(
                "calibration table has no kernel fits to cost the workload "
                "with — capture eager execute events (profile.set_profiler) "
                "and fit them with profile.calibrate"
            )
        t_us = sum(
            calibration.predict_gemm_us(layer.m, layer.k, layer.n) * count
            for layer, count in layers
        )
        calibrated = {
            "source": {
                "version": getattr(calibration, "version", None),
                "backend": getattr(calibration, "backend", None),
            },
            "time_us": t_us,
            "tok_s": tokens / max(t_us * 1e-6, 1e-12),
            # measured host kernels vs the analytic CiM projection —
            # how much faster the modeled array is than this host
            "cim_speedup_vs_host": (t_us * 1e3) / max(t_cim, 1e-12),
        }
    return {
        "arch": cfg.name,
        "family": cfg.family,
        "shape": shape.name,
        "kind": shape.kind,
        "array": array.name,
        "design": array.design,
        "tech": array.technology,
        "n_arrays": macro.n_arrays,
        "tokens_per_forward": tokens,
        "macs_per_forward": macs,
        "time_ns": t_cim,
        "energy_pj": e_cim,
        "tok_s": tokens / (t_cim * 1e-9),
        "pj_per_token": e_cim / max(tokens, 1),
        "iso_capacity": {
            "speedup": t_ic / t_cim,
            "energy_reduction": e_ic / e_cim,
        },
        "iso_area": {
            "nm_arrays": nm_arrays_ia,
            "speedup": t_ia / t_cim,
            "energy_reduction": e_ia / e_cim,
        },
        "calibrated": calibrated,
    }
