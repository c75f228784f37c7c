"""End-to-end driver on the port: train a ~100M-param ternary (QAT) LM
with the full substrate — data pipeline, AdamW, checkpoint/restart,
straggler tracking — on the card (default) or the CPU.

The default config is the real smollm-135m (135M params) at a reduced
sequence length; pass --smoke for the tiny config, --steps to change
duration. Checkpoints go to --ckpt-dir, by default a temporary
directory removed at the end.

Run: PYTHONPATH=src python examples/torch/train_ternary_lm.py --steps 300
"""
import argparse
import tempfile

from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", help="tiny config (fast CPU run)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", default=None, choices=[None, "bf16", "int8"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    print(f"training {cfg.name} ({cfg.param_count():,} params), "
          f"quant mode = {cfg.quant.mode}")
    pipe = TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0))
    opt = AdamWConfig(lr=3e-4, schedule=warmup_cosine(20, args.steps))
    with tempfile.TemporaryDirectory(prefix="repro-ckpt-") as tmp:
        tcfg = TrainConfig(
            num_steps=args.steps, ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50,
            log_every=10, grad_compression=args.grad_compression,
        )
        trainer = Trainer(cfg, opt, tcfg, pipe, device=args.device)
        log = trainer.run()
    print(f"\nfinal loss {log[-1]['loss']:.4f} (start {log[0]['loss']:.4f}); "
          f"stragglers: {len(trainer.straggler_steps)}; restarts: {trainer.restarts}")
    return log


if __name__ == "__main__":
    main()
