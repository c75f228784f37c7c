"""SiTe CiM array walkthrough on the port: reproduce the paper's Fig 3-5
mechanics.

Shows the differential encoding, the truth table, multi-row MAC with the
3-bit ADC, sense-margin-driven clamping, and the sensing-error channel —
numerically, on the functional model, on the card (default) or the CPU.
Random inputs come from explicit ``torch.Generator`` s.

Run: PYTHONPATH=src python examples/torch/cim_array_demo.py [--device cpu]
"""
import argparse

import torch

from repro_torch import api
from repro_torch._device import resolve_device
from repro_torch.core import site_cim as sc
from repro_torch.core.ternary import block_overflow_rate, to_bitplanes

# the demo's array semantics, as a declarative execution spec
CIM = api.CiMExecSpec(formulation="blocked", backend="torch")


def _signs(gen, shape, p_zero, dev):
    """Random {-1, +1} entries, each zeroed with probability ``p_zero``."""
    sign = torch.randint(0, 2, shape, generator=gen) * 2 - 1
    keep = torch.rand(shape, generator=gen) >= p_zero
    return (sign * keep).to(torch.float32).to(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("=== Fig 3(a): differential weight encoding (M1, M2) ===")
    for w in (1, 0, -1):
        m1, m2 = to_bitplanes(torch.tensor(w, device=dev))
        print(f"  W={w:+d} -> M1={int(m1)} M2={int(m2)}")

    print("\n=== Fig 3(d): scalar product truth table ===")
    print("        W=-1  W=0  W=+1")
    for i in (-1, 0, 1):
        row = [int(sc.scalar_product(torch.tensor(i, device=dev), torch.tensor(w, device=dev)))
               for w in (-1, 0, 1)]
        print(f"  I={i:+d}  {row[0]:+d}    {row[1]:+d}    {row[2]:+d}")

    print("\n=== Fig 4: multi-row MAC with 3-bit ADC (N_A = 16) ===")
    # 16 rows, engineered so a = 11 (+1 events) and b = 2 (-1 events)
    x = torch.tensor([1] * 13 + [-1] * 3, device=dev)
    w = torch.tensor([1] * 11 + [0, 0] + [-1, 1, 0], device=dev)
    a = int(torch.sum((x * w) == 1))
    b = int(torch.sum((x * w) == -1))
    exact = int((x * w).sum())
    cim = int(api.execute(CIM, x[None], w[:, None])[0, 0])
    print(f"  a={a} (+1 events), b={b} (-1 events)")
    print(f"  exact dot = a-b = {exact}")
    print(f"  CiM output = min(a,8)-min(b,8) = {cim}   <-- ADC clamp at 8")

    print("\n=== sparsity keeps overflow rare (Section III.2) ===")
    gen = torch.Generator().manual_seed(0)
    for p_zero in (0.0, 0.3, 0.6):
        xs = _signs(gen, (64, 256), p_zero, dev)
        ws = _signs(gen, (256, 64), p_zero, dev)
        rate = float(block_overflow_rate(xs, ws))
        print(f"  sparsity {p_zero:.1f}: ADC overflow rate {rate:.4f}")

    print("\n=== sensing-error channel (total prob 3.1e-3, Section III.2) ===")
    gen = torch.Generator().manual_seed(1)
    xs = torch.randint(-1, 2, (32, 256), generator=gen).to(dev)
    ws = torch.randint(-1, 2, (256, 32), generator=gen).to(dev)
    clean = api.execute(CIM, xs, ws)
    noisy_spec = api.CiMExecSpec(formulation="blocked", backend="torch",
                                 error_prob=sc.SENSE_ERROR_PROB)
    noise = torch.Generator(device=dev).manual_seed(2)
    noisy = api.execute(noisy_spec, xs, ws, generator=noise)
    n_diff = int(torch.sum(clean != noisy))
    print(f"  outputs perturbed: {n_diff}/{clean.numel()} "
          f"(expected ~= 16 blocks x 3.1e-3 x {clean.numel()} = "
          f"{16 * 3.1e-3 * clean.numel():.0f})")


if __name__ == "__main__":
    main()
