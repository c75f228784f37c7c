"""PyTorch/CUDA port of the SiTe CiM reproduction.

Mirrors the layout of the JAX package ``repro`` module by module; every
signed-ternary MAC on the serving path runs through a hand-written CUDA
kernel (``repro_torch/csrc``) on the card, and through that kernel's
plain PyTorch version for tensors on the CPU. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
