"""Serving example on the port: continuous batching over a ternary-CiM LM.

Spins up the slot-pool batcher, submits a stream of requests with
different lengths, and decodes them concurrently — finished slots refill
from the queue without stalling the others. Every decode step is ONE
fused call over all slots at their own cache positions (a captured CUDA
graph on the card), with sampling on the device and a single host fetch
per step. The weights are seeded (``transformer.init_params``). The
activations are ternarized with per-row scales (``act_scale="per_row"``),
so each request's tokens do not depend on the requests it shares a step
with: they are the port's ``generate()`` of its prompt alone.

Run: PYTHONPATH=src python examples/torch/serve_ternary.py [--device cpu]
"""
import argparse
import dataclasses
import time

from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.serve.engine import ContinuousBatcher, Request


def requests():
    """The example's ten requests: prompts of 1-3 tokens, 4-9 new tokens."""
    return [Request(i, [1 + i % 7, 2, 3 + i % 5][: 1 + i % 3], max_new=4 + i % 6)
            for i in range(10)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config("smollm-135m", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    params = T.init_params(cfg, seed=0, device=args.device)
    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=64, device=args.device)

    reqs = requests()
    for r in reqs:
        batcher.submit(r)

    t0 = time.perf_counter()
    batcher.run()
    dt = time.perf_counter() - t0
    total_toks = sum(len(r.generated) for r in reqs)
    stats = batcher.stats()
    print(f"served {len(reqs)} requests / {total_toks} tokens in "
          f"{stats['decode_steps']} fused decode steps, "
          f"{stats['host_syncs']} host syncs ({dt:.2f}s)")
    for r in reqs:
        assert r.done
        print(f"  req {r.rid}: prompt {r.prompt} -> {r.generated}")
    return reqs


if __name__ == "__main__":
    main()
