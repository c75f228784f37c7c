"""Quickstart: the paper's technique in five minutes, on the port.

1. Build a ternary weight/input pair from an explicit ``torch.Generator``.
2. Compute the signed-ternary dot product through the declarative
   execution API (``repro_torch.api``): exact near-memory, SiTe CiM array
   semantics (16-row ADC clamp), and the hand-written CUDA kernel #1
   (``ternary_cim_matmul``) — one ``execute`` call each, the spec picks
   the kernel. On the card the kernel launches and is held against its
   plain PyTorch version; with ``--device cpu`` the wrapper runs that
   plain version.
3. Show the array- and system-level cost model (the paper's Figs 9-13),
   mapped from the same specs.

Run: PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import api, hw
from repro_torch._device import resolve_device
from repro_torch.core.ternary import pack_ternary, ternarize
from repro_torch.kernels.ternary_mac import ternary_cim_matmul, ternary_cim_matmul_plain


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    # ternarize some float data (TWN threshold quantization)
    x_f = torch.randn((8, 256), generator=gen).to(dev)
    w_f = torch.randn((256, 64), generator=gen).to(dev)
    x_t, sx = ternarize(x_f)
    w_t, sw = ternarize(w_f, axis=(0,))
    print(f"input sparsity:  {float((x_t == 0).float().mean()):.2f}")
    print(f"weight sparsity: {float((w_t == 0).float().mean()):.2f}")

    # ternary codes as f32: every product and sum below is an exact integer
    xf = x_t.to(torch.float32)
    wf = w_t.to(torch.float32)
    # 1) exact near-memory ternary matmul (the paper's NM baseline)
    exact = api.execute(api.CiMExecSpec(formulation="exact", backend="torch"), xf, wf)
    # 2) SiTe CiM: 16 rows per cycle, 3-bit ADC with clamp at 8
    cim_spec = api.CiMExecSpec(formulation="blocked", backend="torch")
    cim = api.execute(cim_spec, xf, wf)
    # 3) kernel #1 (CUDA on the card) — same spec, different backend
    launched = ternary_cim_matmul.launches
    kern = api.execute(api.CiMExecSpec(formulation="blocked", backend="cuda"), xf, wf)
    agree = bool(torch.equal(cim, kern))
    plain = ternary_cim_matmul_plain(x_t.to(torch.int8), w_t.to(torch.int8))
    clipped = int(torch.sum(cim != exact))
    print(f"kernel == functional model: {agree}")
    print(f"kernel #1 launches: {ternary_cim_matmul.launches - launched} on {dev.type}; "
          f"kernel == plain version: {bool(torch.equal(kern, plain))}")
    print(f"outputs where the ADC clamp engaged: {clipped}/{cim.numel()}")

    # 2-bit differential storage (the memory-macro layout); the packed
    # kernel backend consumes exactly this via packing="bitplane_u8"
    wp, wn = pack_ternary(w_t.to(torch.int8), axis=0)
    print(f"weight bytes: fp32 {w_f.numel() * w_f.element_size()}, packed 2-bit "
          f"{wp.numel() + wn.numel()}")

    # hardware model: the spec binds to a declarative ArraySpec
    design = api.spec_design(cim_spec)
    array = hw.ArraySpec(technology="8T-SRAM", design=design)
    cost = api.spec_cost_summary(cim_spec, array=array)
    print(f"\nspec {cim_spec.name} -> array {array.name}")
    t = hw.paper_validation_table()["8T-SRAM"][design]
    print("8T-SRAM SiTe CiM I vs near-memory (paper Fig 9):")
    print(f"  CiM latency reduction : {t['cim_latency_reduction_pct']:.0f}%  (paper: 88%)")
    print(f"  CiM energy reduction  : {t['cim_energy_reduction_pct']:.0f}%  (paper: 74%)")
    print(f"  MAC pass              : {cost['mac_pass_ns']:.0f} ns")
    s = hw.average_speedup("8T-SRAM", design, "iso-capacity")
    print(f"  system speedup (5 DNNs, iso-capacity): {s:.2f}x (paper: 6.74x)")
    p = hw.project("yi-34b", "decode_32k", array)
    print(f"  projected yi-34b decode on that array: {p['tok_s']:.0f} tok/s, "
          f"{p['iso_capacity']['speedup']:.1f}x vs iso-capacity NM")
    return agree


if __name__ == "__main__":
    main()
