"""Optimizers, schedules, gradient compression (port of ``repro/optim``)."""
from repro_torch.optim.adamw import AdamWConfig, AdamWState, init, update  # noqa: F401
from repro_torch.optim import compress, schedules  # noqa: F401
