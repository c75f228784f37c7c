"""Roofline terms of a dry-run cell on the H100 (the counterpart of
``repro/launch/roofline.py``).

The reference prices a TPU v5e-class chip. Here the constants are the
NVIDIA H100 SXM5 80GB's, from its data sheet (dense rates, no
structured sparsity), and each dtype's FLOPs go at that dtype's own
peak. The three terms per (arch x shape x mesh):

    T_compute = sum over dtypes of FLOPs_dtype / (chips * PEAK[dtype])
    T_memory  = bytes / (chips * HBM_BW)
    T_coll    = coll_bytes / NVLINK_BW   [per-device, one direction]

The FLOPs, bytes and collective bytes come from the op accounting of
one rank's step (``launch.op_analysis``): whole-job FLOPs and bytes are
the rank's times the chips, as in the reference. Hand-written kernel
work (the ternary MACs, counted at two ternary products a CiM call) goes
at the int8 tensor-core peak; the float64 contractions of attention, the
unembedding and the experts at the float64 one, whose term
``to_dict()`` shows on its own (``t_compute_f64_s``).

**The link model's limit.** ``T_coll`` prices every collective at one
H100's NVLink rate, the all-to-all fabric of the GPUs of one node. The
production mesh's 256 (or 512) GPUs span many nodes, and a collective
whose group leaves a node crosses the slower inter-node network; this
model does not price that, and a cell's collective term is a lower
bound there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

#: NVIDIA H100 SXM5 80GB data sheet, dense rates (its tensor-core
#: figures are quoted with 2:4 sparsity; the dense rate is half of each)
PEAK_BF16 = 1979e12 / 2  # BF16 tensor core: 1,979 TFLOP/s sparse
PEAK_F16 = 1979e12 / 2   # FP16 tensor core: 1,979 TFLOP/s sparse
PEAK_F32 = 67e12         # FP32: 67 TFLOP/s (torch's f32 matmul runs without TF32)
PEAK_F64 = 67e12         # FP64 tensor core: 67 TFLOP/s (cuBLAS DGEMM)
PEAK_INT8 = 3958e12 / 2  # INT8 tensor core: 3,958 TOP/s sparse (PERF.md's 1,979)
HBM_BW = 3.35e12         # HBM3: 3.35 TB/s
NVLINK_BW = 450e9        # NVLink 4: 900 GB/s both directions, one direction
#: the reference's name: the bf16 peak
PEAK_FLOPS = PEAK_BF16

#: the peak each dtype key of ``op_analysis`` runs at; any other key goes
#: at the f32 CUDA-core rate
PEAKS = {"bf16": PEAK_BF16, "f16": PEAK_F16, "f32": PEAK_F32,
         "f64": PEAK_F64, "int8": PEAK_INT8}


def peak_for(dtype_key: str) -> float:
    return PEAKS.get(dtype_key, PEAK_F32)


def collective_bytes(trace: Sequence, n_devices: int) -> Dict[str, float]:
    """Per-device bytes moved over the links, by collective type (ring
    model), from a recorded step's trace (``op_analysis.record``)."""
    from repro_torch.launch import op_analysis

    cost = op_analysis.analyze(trace, n_devices)
    out = {op: float(cost.coll.get(op, 0.0)) for op in op_analysis.COLLECTIVES}
    out["total"] = sum(out[o] for o in op_analysis.COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    bytes_accessed: float
    coll_bytes: float           # per-device
    coll_breakdown: Dict[str, float]
    model_flops: float          # 6*N*D (or 6*N_active*D) useful flops
    bytes_per_device: Optional[float] = None
    # execution-spec -> array-design cost mapping (repro_torch.hw via
    # repro_torch.core.execution.spec_cost_summary); None for fp cells
    cim_array: Optional[Dict[str, float]] = None
    # canonical name of the ArraySpec the cell was costed on (None when
    # no --array-spec binding was given — default-geometry 8T-SRAM)
    array_spec: Optional[str] = None
    # whole-job FLOPs by dtype key (op_analysis: "bf16", "f32", "f64",
    # "int8" for the kernels); empty: all of ``flops`` at the bf16 peak
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)

    def _by_dtype(self) -> Dict[str, float]:
        return dict(self.flops_by_dtype) if self.flops_by_dtype else {"bf16": self.flops}

    @property
    def t_compute_by_dtype(self) -> Dict[str, float]:
        return {k: v / (self.chips * peak_for(k))
                for k, v in sorted(self._by_dtype().items())}

    @property
    def t_compute(self) -> float:
        return sum(self.t_compute_by_dtype.values())

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """How close the step is to the compute roofline: T_comp / max(T)."""
        peak = max(self.t_compute, self.t_memory, self.t_collective, 1e-30)
        return self.t_compute / peak

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.flops, 1.0)

    def to_dict(self) -> dict:
        by_dtype = self.t_compute_by_dtype
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.flops,
            "hlo_bytes": self.bytes_accessed,
            "coll_bytes_per_device": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
            "bytes_per_device": self.bytes_per_device,
            "cim_array": self.cim_array,
            "array_spec": self.array_spec,
            "flops_by_dtype": self._by_dtype(),
            "t_compute_by_dtype_s": by_dtype,
            "t_compute_f64_s": by_dtype.get("f64", 0.0),
        }


def model_flops_estimate(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for inference tokens
    (N = active params)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.batch


def fmt_table(rows) -> str:
    hdr = (
        f"{'arch':<18} {'shape':<12} {'mesh':<10} {'Tcomp(s)':>10} {'Tmem(s)':>10} "
        f"{'Tcoll(s)':>10} {'bneck':>10} {'roofl%':>7} {'useful%':>8}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<18} {r.shape:<12} {r.mesh:<10} {r.t_compute:>10.3e} "
            f"{r.t_memory:>10.3e} {r.t_collective:>10.3e} {r.bottleneck:>10} "
            f"{100*r.roofline_fraction:>6.1f} {100*r.useful_flops_ratio:>7.1f}"
        )
    return "\n".join(lines)
