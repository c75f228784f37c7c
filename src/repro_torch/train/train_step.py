"""Loss and train step (port of ``repro/train/train_step.py``).

``train_step`` is one eager optimizer step: the loss, its gradients by
autograd (through the STE codes and MAC of ``models.layers.dense``, each
layer checkpointed under ``cfg.remat``), optional gradient compression,
and the functional AdamW update. Every family trains: the moe experts
through ``moe._tern3``'s straight-through codes, the SSM's ``dt``
through ``ssm.softplus``'s reference gradient; encdec and vlm batches
carry ``frames`` or ``patches`` beside the tokens. An unknown family
raises in ``transformer.forward``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim import compress as gcomp
from repro_torch.optim.adamw import tree_leaves, tree_map

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: adamw.AdamWState
    generator: torch.Generator          # the int8 compression's noise
    residual: Optional[PyTree] = None   # error feedback of grad compression


def init_train_state(cfg: ArchConfig, seed: int = 0,
                     grad_compression: Optional[str] = None,
                     device: DeviceLike = None) -> TrainState:
    """Seeded params (``transformer.init_params``), a fresh AdamW state
    and the compression generator, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    params = T.init_params(cfg, seed=seed, device=dev)
    residual = gcomp.init_residual(params) if grad_compression == "int8" else None
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    return TrainState(params, adamw.init(params), generator, residual)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.to(torch.int64)[..., None], dim=-1)[..., 0]
    return (logz - gold).mean()


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = T.forward(params, batch["tokens"], cfg, frames=batch.get("frames"),
                       patches=batch.get("patches"))
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_image_tokens:, :]
    loss = cross_entropy(logits, batch["labels"])
    acc = (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()
    return loss, {"loss": loss.detach(), "accuracy": acc}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
               grad_compression: Optional[str] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step; ``state`` is not modified (the generator
    advances where int8 compression draws from it)."""
    params = tree_map(lambda p: p.detach().requires_grad_(), state.params)
    loss, metrics = loss_fn(params, batch, cfg)
    found = iter(torch.autograd.grad(loss, list(tree_leaves(params))))
    del loss
    with torch.no_grad():
        grads = tree_map(lambda p: next(found), params)
        residual = state.residual
        if grad_compression:
            grads, residual = gcomp.compress_grads(grads, grad_compression,
                                                   state.generator, residual)
        new_params, opt, gnorm = adamw.update(opt_cfg, grads, state.opt, state.params)
    metrics = dict(metrics, grad_norm=gnorm)
    return TrainState(new_params, opt, state.generator, residual), metrics


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    grad_compression: Optional[str] = None):
    """The eager counterpart of the reference's ``make_jit_train_step``:
    ``step(state, batch) -> (state, metrics)``."""
    return functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                             grad_compression=grad_compression)
