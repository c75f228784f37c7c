"""Serving launcher: continuous batching over a ternary model on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --requests 8 --slots 4

``--arch`` takes any arch of ``models.registry`` (the dense configs,
``mamba2-780m``, ``zamba2-2.7b``, ``deepseek-v2-236b``, ``grok-1-314b``,
``whisper-large-v3`` and ``llava-next-34b``). As the reference's CLI,
it serves token requests only: whisper as its decoder without cross
attention (the batcher takes no encoder output), llava as its Yi-34B
token stream (image patches enter only ``transformer.forward``).

Runs on ``cuda`` by default and exits with an error without CUDA unless
``--device cpu`` is given (use it with ``--smoke`` on a CPU host). The
serving CiM execution spec is selected with ``--exec-spec`` as
``formulation[/backend[/packing[/flavor]]]``, e.g. ``blocked/cuda``,
``exact/cuda`` (the near-memory baseline) or ``blocked/cuda/bitplane_u8``;
with ``--prepare-weights`` the quantization is folded offline once
(quant.prepare.prepare_for_spec), and a packed spec keeps the stored
planes beside the model (``blocked/cuda_stream/bitplane_u8`` stores
them in the stream kernel's layout 1). On the card the decode step runs
as one captured CUDA graph; its capture time is printed on its own line.
``--loop-decode`` serves the per-slot loop baseline instead (greedy,
eager). The KV cache follows the config's ``quant.cache_dtype`` (the
reference's CLI has no flag for it). Not ported yet: ``--tp``,
``--serve-http`` and ``--profile``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.core.execution import CiMExecSpec
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import ternarize_params
from repro_torch.serve.engine import ContinuousBatcher, Request


def parse_exec_spec(text: str) -> CiMExecSpec:
    """``formulation[/backend[/packing[/flavor]]]`` -> CiMExecSpec."""
    parts = text.split("/")
    if len(parts) > 4:
        raise ValueError(f"bad exec spec {text!r} (at most 4 '/'-fields)")
    fields = ("formulation", "backend", "packing", "flavor")
    return CiMExecSpec(**dict(zip(fields, parts)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--exec-spec", default=None,
                    metavar="FORM[/BACKEND[/PACKING[/FLAVOR]]]")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of sampling")
    ap.add_argument("--loop-decode", action="store_true",
                    help="use the legacy per-slot-loop decode baseline "
                         "instead of the fused ragged-position step")
    ap.add_argument("--prepare-weights", action="store_true",
                    help="run quant.prepare.prepare_for_spec once at startup "
                         "(requires --exec-spec)")
    ap.add_argument("--pre-quantize", action="store_true",
                    help="fold ternarization into weights offline")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for a CPU host)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = T.init_params(cfg, seed=args.seed, device=device)
    if args.pre_quantize:
        import dataclasses

        params = ternarize_params(params)
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, pre_quantized=True))
    exec_spec = parse_exec_spec(args.exec_spec) if args.exec_spec else None
    if args.prepare_weights and exec_spec is None:
        ap.error("--prepare-weights requires --exec-spec")
    batcher = ContinuousBatcher(
        params, cfg, n_slots=args.slots, s_max=args.s_max, exec_spec=exec_spec,
        temperature=args.temperature, seed=args.seed, fused=not args.loop_decode,
        prepare_weights=args.prepare_weights, device=device)
    reqs = [
        Request(i, [1 + (i * 7 + j) % (cfg.vocab - 1) for j in range(1 + i % 4)],
                max_new=2 + i % args.max_new)
        for i in range(args.requests)
    ]
    for r in reqs:
        batcher.submit(r)
    t0 = time.perf_counter()
    batcher.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in reqs)
    stats = batcher.stats()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] {len(reqs)} requests, {toks} tokens, {dt:.3f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s on {where}), "
          f"{stats['decode_steps']} decode steps, "
          f"{stats['prefill_batches']} prefill batches, "
          f"{stats['host_syncs']} host syncs")
    if batcher.capture_seconds is not None:
        print(f"[serve] decode step captured as one CUDA graph in "
              f"{batcher.capture_seconds:.3f}s (warm-up included; part of "
              f"the {dt:.3f}s above)")
    elif args.loop_decode:
        print(f"[serve] decode step is the per-slot loop baseline, run eagerly "
              f"on {where}")
    else:
        print(f"[serve] decode step not captured: it runs eagerly on {where}")
    if not all(r.done for r in reqs):
        raise RuntimeError("some requests did not finish")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
