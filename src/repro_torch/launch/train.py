"""Training launcher of the port (the counterpart of
``repro/launch/train.py``): real steps on one device, ``cuda`` unless
``--device cpu`` is given (without CUDA it raises).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 20 --quant cim
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 3 --ckpt-dir /tmp/ckpt

Every token family trains here; encdec and vlm need frames or patches,
which the token pipeline does not make (nor the reference's): train them
through ``Trainer(batch_transform=...)``. The launcher trains on one
device, and takes no mesh flag, as the reference's has none: a ``(data,
model)`` grid trains through ``Trainer(mesh=)`` in the processes of
``launch.mesh.spawn_mesh``: all six families (dense, ssm, hybrid, moe,
encdec and vlm, the last two with a ``batch_transform``) over a model
axis.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch._device import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default=None, choices=[None, "bf16", "int8"])
    ap.add_argument("--quant", default=None,
                    choices=[None, "off", "ternary", "cim", "cim_fused"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.quant:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, mode=args.quant))
    print(f"[train] {cfg.name}: {cfg.param_count():,} params, "
          f"quant={cfg.quant.mode}, device={device}")

    pipe = TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    opt = AdamWConfig(lr=args.lr, schedule=warmup_cosine(20, args.steps))
    tcfg = TrainConfig(
        num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=10,
        grad_compression=args.grad_compression,
    )
    trainer = Trainer(cfg, opt, tcfg, pipe, device=device)
    log = trainer.run()
    print(f"[train] done: loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f}; "
          f"restarts={trainer.restarts} stragglers={len(trainer.straggler_steps)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
