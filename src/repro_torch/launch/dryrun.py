"""Dry run: cost every (arch x shape x mesh) cell of the production mesh
without a card (the counterpart of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
        --out results/dryrun

The reference lowers and compiles each cell for 512 placeholder TPU
devices and reads the compiled HLO. Nothing is lowered here, and nothing
is allocated: per cell :func:`lower_cell`

  1. takes the production mesh (16x16, and 2x16x16 with --multi-pod) as
     sizes (``launch.mesh.make_production_mesh``) and stands in for its
     rank 0 with ``launch.mesh.dry_mesh``, whose collectives move
     nothing but are counted (``dist.collectives``' dry seam);
  2. builds that rank's state and inputs on the ``meta`` device (shapes
     and dtypes, no storage): the train state sharded as the model axis
     trains (``dist.sharding.train_layout``), the serving params placed
     as ``shard_params`` places them, the caches of the rank's heads, and
     the rank's rows of the batch where it divides the data axes;
  3. runs the cell's step once (train: ``train_step``; prefill:
     ``forward``; decode: ``serve_step`` over ``init_caches``) under the
     op accounting (``launch.op_analysis``), the kernels' plain versions
     standing in for their launches and counted at their logical work,
     the execution spec resolved for the card;
  4. prints the roofline and the memory estimate and writes the cell's
     JSON.

``memory_analysis`` is the port's own estimate: the bytes of the
arguments the rank holds (state, caches, batch rows; a storage shared by
views once), the parameter bytes the placement rule gives
(``param_specs``, the reference's rule), and the peak of the live bytes
the step's ops make, as the recorder follows them, over the arguments.
Every tensor stays on the meta device, but for the small integer and
boolean index sets a model-axis training step builds on the host
(``host_index_bytes``).

``fsdp=True`` (decode cells, as in the reference) spreads the large
leaves over the data axis by the reference's rule
(``param_specs(fsdp=True)``): a rank holds 1/data of each, and the step
begins with one all-gather over the data axis per such leaf.

The reference sets ``set_native_accum(True)`` for its TPU-target HLO;
the port has one accumulation (float64 where the reference's default
is), and the dry run counts what the card would run.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import AbstractMesh, dry_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.registry import SHAPES, ShapeCell, cell_supported, get_config
from repro_torch.optim import adamw
from repro_torch.quant.prepare import tree_paths
from repro_torch.serve.engine import serve_step

ts = importlib.import_module("repro_torch.train.train_step")

META = torch.device("meta")


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh_name: str
    ok: bool
    seconds: float
    error: Optional[str] = None
    roofline: Optional[dict] = None
    memory_analysis: Optional[str] = None
    #: measured-cost score (launch.hillclimb.score_cell) when the cell
    #: was driven with --calibration; None for analytic-only runs
    calibrated: Optional[dict] = None
    #: the numbers of ``memory_analysis`` (bytes): argument_bytes,
    #: param_bytes, host_index_bytes, step_peak_bytes, peak_bytes,
    #: output_bytes
    memory: Optional[dict] = None
    #: one rank's op accounting (``op_analysis.OpCost.summary()``) and
    #: its collectives by ``dist.collectives.COUNTS`` name
    op_cost: Optional[dict] = None


def input_specs(cfg: ArchConfig, shape: ShapeCell) -> Dict[str, tuple]:
    """The cell's whole inputs as {name: (shape, dtype)} (the reference's
    ``registry.input_specs``): train and prefill (B, S) tokens (less the
    image rows of vlm), train's labels, encdec's frames, vlm's patches;
    decode (B, 1) tokens and encdec's encoder output."""
    b, s = shape.batch, shape.seq
    if shape.kind in ("train", "prefill"):
        n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
        specs = {"tokens": ((b, s - n_img), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = ((b, s - n_img), torch.int32)
        if cfg.family == "encdec":
            specs["frames"] = ((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
        if cfg.family == "vlm":
            specs["patches"] = ((b, n_img, cfg.d_vision), torch.bfloat16)
        return specs
    specs = {"tokens": ((b, 1), torch.int32)}
    if cfg.family == "encdec":
        specs["enc"] = ((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return specs


def _tensors(obj, out):
    """The tensors of a tree of dicts, tuples, NamedTuples and the
    sharding dataclasses, in order."""
    if torch.is_tensor(obj):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


def tree_bytes(*trees) -> int:
    """Bytes of the tensors of ``trees``, each storage once."""
    seen: Dict[int, int] = {}
    for t in _tensors(trees, []):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def param_bytes(params, axis_sizes: Dict[str, int], fsdp: bool = False) -> float:
    """A rank's parameter bytes under the reference's placement rule:
    each leaf's bytes over the product of the axis sizes its spec
    (``param_specs(fsdp=)``) splits it on."""
    specs = dict(tree_paths(shd.param_specs(params, fsdp=fsdp, axis_sizes=axis_sizes)))
    total = 0.0
    for path, leaf in tree_paths(params):
        split = math.prod(int(axis_sizes.get(a, 1)) for a in specs[path] if a)
        total += leaf.numel() * leaf.element_size() / split
    return total


def _fsdp_leaves(params, axis_sizes: Dict[str, int]):
    """The paths of the leaves ``param_specs(fsdp=True)`` spreads over the
    data axis."""
    specs = tree_paths(shd.param_specs(params, fsdp=True, axis_sizes=axis_sizes))
    return [p for p, sp in specs if "data" in sp]


def _node(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _batch(cfg: ArchConfig, shape: ShapeCell, mesh) -> Dict[str, torch.Tensor]:
    """The rank's rows of the cell's inputs on the meta device."""
    whole = {k: torch.empty(s, dtype=dt, device=META)
             for k, (s, dt) in input_specs(cfg, shape).items()}
    return shd.batch_shard(whole, mesh) if mesh is not None else whole


def _serving_params(cfg: ArchConfig, mesh):
    whole = T.init_params(cfg, device=META)
    placed = shd.shard_params(whole, cfg, mesh) if mesh is not None else whole
    return whole, placed


def _cell_step(cfg: ArchConfig, shape: ShapeCell, mesh, amesh: AbstractMesh,
               fsdp: bool):
    """(step thunk, the rank's argument trees, param bytes by the rule,
    the bytes of the arguments that FSDP spreads over the other data
    ranks) of one cell on the meta device."""
    sizes = amesh.shape
    batch = _batch(cfg, shape, mesh)
    if shape.kind == "train":
        # the step takes the global batch and views the rank's rows itself
        rows, batch = batch, _batch(cfg, shape, None)
        whole = T.init_params(cfg, device=META)
        params = shd.shard_tree(whole, shd.train_layout(cfg, mesh)) if mesh else whole
        state = ts.TrainState(params, adamw.init(params), torch.Generator())
        opt_cfg = adamw.AdamWConfig()

        def step():
            return ts.train_step(state, batch, cfg, opt_cfg, mesh=mesh)

        return step, (state.params, state.opt.mu, state.opt.nu, rows), \
            param_bytes(whole, sizes), 0
    rank_cfg = shd.local_config(cfg, mesh) if mesh is not None else cfg
    whole, placed = _serving_params(cfg, mesh)
    pbytes = param_bytes(whole, sizes, fsdp=fsdp and shape.kind == "decode")
    if shape.kind == "prefill":
        def step():
            with torch.no_grad():
                return T.forward(placed, batch["tokens"], rank_cfg,
                                 frames=batch.get("frames"), patches=batch.get("patches"))

        return step, (placed, batch), pbytes, 0
    rows = batch["tokens"].shape[0]
    caches = T.init_caches(rank_cfg, rows, shape.seq, device=META)
    data = int(sizes.get("data", 1))
    spread = []   # the rank's tensors of the leaves FSDP spreads over the data axis
    if fsdp and mesh is not None and data > 1:
        spread = [t for path in _fsdp_leaves(whole, sizes)
                  for t in _tensors(_node(placed, path), [])]
    group = collectives.DryGroup(data, "data")

    def step():
        # FSDP: the rank holds 1/data of each spread leaf and gathers it whole
        for t in spread:
            collectives.all_gather(t.reshape(-1).narrow(0, 0, t.numel() // data), group)
        with torch.no_grad():
            return serve_step(placed, batch["tokens"], caches, shape.seq - 1, rank_cfg,
                              enc=batch.get("enc"))

    away = tree_bytes(spread) * (data - 1) // data if spread else 0
    return step, (placed, caches, batch), pbytes, away


def _check_meta(trace) -> int:
    """Raise unless every tensor the step made is on the meta device or
    empty, but for the integer and boolean index sets the training layout
    builds on the host
    (``dist.sharding.train_layout``, every step, as on the card); returns
    their bytes."""
    host = 0
    for rec in trace:
        for t in rec.outputs:
            if t.device == "meta" or 0 in t.shape:
                continue  # an empty tensor (torch's checkpoint makes one) holds nothing
            dtype = getattr(torch, t.dtype)
            if t.device != "cpu" or dtype.is_floating_point or dtype.is_complex:
                raise RuntimeError(f"the dry step made {t} on {t.device} ({rec.op}): "
                                   "every tensor must stay on the meta device")
            host += math.prod(t.shape) * dtype.itemsize
    return host


def lower_cell(
    arch: Union[str, ArchConfig],
    shape_name: Union[str, ShapeCell],
    multi_pod: bool = False,
    quant_mode: Optional[str] = None,
    remat: Optional[bool] = None,
    verbose: bool = True,
    cfg_overrides: Optional[dict] = None,
    quant_overrides: Optional[dict] = None,
    fsdp: bool = False,
    array_spec=None,
    mesh: Optional[AbstractMesh] = None,
) -> CellResult:
    """Cost one cell on the meta device (see the module docstring).
    ``arch`` is a registry id or an ``ArchConfig`` (a smoke config);
    ``shape_name`` a registry shape or a ``ShapeCell``; ``mesh`` an
    ``AbstractMesh`` in place of the production one (its name is its
    sizes)."""
    # resolve the hardware binding first: a typo'd --array-spec dies with
    # the registered sets listed, before any work
    from repro_torch import hw

    if isinstance(array_spec, str):
        array_spec = hw.parse_array_spec(array_spec)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = arch if isinstance(arch, str) else cfg.name
    if quant_mode is not None:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, mode=quant_mode))
    if quant_overrides:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, **quant_overrides))
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    shape = shape_name if isinstance(shape_name, ShapeCell) else SHAPES[shape_name]
    amesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    mesh_name = ("x".join(map(str, amesh.sizes)) if mesh is not None
                 else ("2x16x16" if multi_pod else "16x16"))
    skip = cell_supported(cfg, shape)
    if skip:
        return CellResult(arch, shape.name, mesh_name, ok=True, seconds=0.0,
                          error=f"SKIP: {skip}")
    t0 = time.time()
    chips = amesh.size
    sizes = amesh.shape
    shd.enable_activation_sharding(
        multi_pod="pod" in sizes, batch_divisor=shd.mesh_batch_divisor(amesh),
        model_size=int(sizes.get("model", 1)))
    try:
        if cfg.quant.mode != "off":
            # the kernels the card runs: their plain versions stand in here
            cfg = cfg.replace(quant=dataclasses.replace(
                cfg.quant, exec_spec=cfg.quant.resolved_spec().resolve("cuda")))
        rank_mesh = dry_mesh(amesh) if chips > 1 else None
        step, args, pbytes, spread = _cell_step(cfg, shape, rank_mesh, amesh, fsdp)
        arg_bytes = tree_bytes(args) - spread
        before = dict(collectives.COUNTS)
        rec = op_analysis.record(step)
        counted = {k: v - before.get(k, 0) for k, v in collectives.COUNTS.items()
                   if v != before.get(k, 0)}
        host = _check_meta(rec.trace)
        cost = op_analysis.analyze(rec.trace, chips)
        cim_array = None
        if cfg.quant.mode != "off":
            from repro_torch.core import execution as xapi

            cim_array = xapi.spec_cost_summary(cfg.quant.resolved_spec(), array=array_spec)
        memory = {"argument_bytes": arg_bytes, "param_bytes": pbytes,
                  "host_index_bytes": host,
                  "step_peak_bytes": rec.peak_bytes,
                  "peak_bytes": arg_bytes + rec.peak_bytes,
                  "output_bytes": rec.end_bytes}
        roof = rl.Roofline(
            arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
            flops=cost.flops * chips,            # whole-job FLOPs
            bytes_accessed=cost.hbm_bytes * chips,
            coll_bytes=cost.coll_bytes,          # per-device
            coll_breakdown=dict(cost.coll),
            model_flops=rl.model_flops_estimate(cfg, shape, shape.kind),
            bytes_per_device=float(memory["peak_bytes"]),
            cim_array=cim_array,
            array_spec=None if array_spec is None else array_spec.name,
            flops_by_dtype={k: v * chips for k, v in cost.flops_by_dtype.items()},
        )
        mem = ("OpMemoryStats(argument_size_in_bytes={argument_bytes}, "
               "param_size_in_bytes={param_bytes:.0f}, "
               "step_peak_live_in_bytes={step_peak_bytes}, "
               "peak_size_in_bytes={peak_bytes}, "
               "output_size_in_bytes={output_bytes})").format(**memory)
        res = CellResult(arch, shape.name, mesh_name, ok=True,
                         seconds=time.time() - t0, roofline=roof.to_dict(),
                         memory_analysis=mem, memory=memory,
                         op_cost=dict(cost.summary(), collective_counts=counted))
        if verbose:
            print(f"[dryrun] {arch} {shape.name} {mesh_name}: OK "
                  f"({res.seconds:.1f}s) bottleneck={roof.bottleneck} "
                  f"Tc={roof.t_compute:.3e} Tm={roof.t_memory:.3e} "
                  f"Tx={roof.t_collective:.3e}")
            print(f"  memory: {mem}")
        return res
    except Exception as e:
        if verbose:
            traceback.print_exc()
        return CellResult(arch, shape.name, mesh_name, ok=False,
                          seconds=time.time() - t0, error=f"{type(e).__name__}: {e}")
    finally:
        shd.disable_activation_sharding()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--quant", default=None,
                    choices=[None, "off", "ternary", "cim", "cim_fused"])
    ap.add_argument("--array-spec", default=None,
                    help="hardware binding for cost cells: "
                         "TECH[/DESIGN][/RxC][/aN][/pP], e.g. 3T-FEMFET/CiM-I "
                         "(see repro_torch.hw; design is overridden by the "
                         "cell's execution spec)")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    args = ap.parse_args(argv)

    if args.array_spec is not None:
        from repro_torch import hw

        try:
            hw.parse_array_spec(args.array_spec)
        except ValueError as e:
            ap.error(f"bad --array-spec: {e}")

    from repro_torch.models.registry import ARCH_IDS

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                res = lower_cell(arch, shape, multi_pod=mp, quant_mode=args.quant,
                                 array_spec=args.array_spec)
                cells.append(res)
                failures += 0 if res.ok else 1
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    tag = f"{arch}__{shape}__{res.mesh_name}"
                    if args.quant:
                        tag += f"__{args.quant}"
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(dataclasses.asdict(res), f, indent=1)
    print(f"\n[dryrun] {len(cells)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
