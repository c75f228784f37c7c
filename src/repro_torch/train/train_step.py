"""Loss and train step (port of ``repro/train/train_step.py``).

``train_step`` is one eager optimizer step: the loss, its gradients by
autograd (through the STE codes and MAC of ``models.layers.dense``, each
layer checkpointed under ``cfg.remat``), optional gradient compression,
and the functional AdamW update. ``make_jit_train_step`` captures its
in-place twin ``train_step_`` into one CUDA graph, as the reference
jits its step. Every family trains: the moe experts
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
from repro_torch.serve.graph import CapturedStep
from repro_torch.train import checkpoint as ckpt

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: adamw.AdamWState
    generator: torch.Generator          # the int8 compression's noise
    residual: Optional[PyTree] = None   # error feedback of grad compression


def init_train_state(cfg: ArchConfig, seed: int = 0,
                     grad_compression: Optional[str] = None,
                     device: DeviceLike = None) -> TrainState:
    """Seeded params (``transformer.init_params``), a fresh AdamW state,
    the compression generator and, under any gradient compression, a
    zero residual, on ``device`` (default ``cuda``). The reference starts
    bf16 compression without a residual and makes one at the first step;
    a zero residual gives the same values and lets the step update it in
    place."""
    dev = resolve_device(device)
    params = T.init_params(cfg, seed=seed, device=dev)
    residual = (gcomp.init_residual(params)
                if grad_compression not in (None, "none") else None)
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


def _grads(state: TrainState, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
           grad_compression: Optional[str]):
    """The loss's metrics, the gradients (compressed under
    ``grad_compression``, drawing from the state's generator) and the new
    residual; ``state`` is not modified."""
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
    return metrics, grads, residual


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
               grad_compression: Optional[str] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step; ``state`` is not modified (the generator
    advances where int8 compression draws from it)."""
    metrics, grads, residual = _grads(state, batch, cfg, grad_compression)
    with torch.no_grad():
        new_params, opt, gnorm = adamw.update(opt_cfg, grads, state.opt, state.params)
    metrics = dict(metrics, grad_norm=gnorm)
    return TrainState(new_params, opt, state.generator, residual), metrics


def train_step_(state: TrainState, batch: Dict[str, torch.Tensor],
                cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                grad_compression: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """:func:`train_step` in place: the state's tensors keep their storage
    and take the values :func:`train_step` returns, bit for bit
    (``adamw.update_``). Returns the metrics."""
    metrics, grads, residual = _grads(state, batch, cfg, grad_compression)
    with torch.no_grad():
        if residual is not state.residual:
            if state.residual is None:
                raise ValueError("an in-place step under gradient compression "
                                 "needs the state's residual (init_train_state "
                                 "makes one)")
            tree_map(lambda r, new: r.copy_(new), state.residual, residual)
        gnorm = adamw.update_(opt_cfg, grads, state.opt, state.params)
    return dict(metrics, grad_norm=gnorm)


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    grad_compression: Optional[str] = None):
    """The eager, functional counterpart of the reference's
    ``make_jit_train_step``: ``step(state, batch) -> (state, metrics)``,
    a new state each call. The plain version of
    :func:`make_jit_train_step`."""
    return functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                             grad_compression=grad_compression)


def _state_tensors(state: TrainState):
    return [t for t in ckpt.tree_flatten(state) if torch.is_tensor(t)]


def make_jit_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                        grad_compression: Optional[str] = None):
    """:func:`train_step` as a captured CUDA graph, the counterpart of the
    reference's ``make_jit_train_step``: ``step(state, batch) -> (state,
    metrics)``.

    The first call binds the state's storage and the batch's keys,
    shapes and dtypes: it copies the batch into static tensors and, on a
    CUDA device, runs the step for real on a side stream (the warm-up:
    the first step itself) and captures it into one
    ``torch.cuda.CUDAGraph`` (``serve.graph.CapturedStep``): the loss,
    ``torch.autograd.grad`` (remat's recompute included), the gradient
    compression (the state's generator registered with the graph) and
    :func:`train_step_`'s in-place AdamW. Every later call copies its
    batch into the static tensors and replays the graph. The state is
    updated in place and returned (the counterpart of the reference's
    donated state); the metrics are the graph's static outputs, which the
    next call overwrites. A call with another state's storage or another
    batch raises; nothing runs eagerly instead. On the CPU every call runs
    :func:`train_step_` eagerly on the same static tensors.
    ``step.captured`` is the bound :class:`~repro_torch.serve.graph.
    CapturedStep` (None before the first call)."""
    bound: Dict[str, Any] = {}

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if step.captured is None:
            dev = state.opt.step.device
            keys = sorted(batch)
            statics = [torch.as_tensor(batch[k]).to(dev, copy=True) for k in keys]

            def body(*tensors):
                return train_step_(state, dict(zip(keys, tensors)), cfg, opt_cfg,
                                   grad_compression)

            gens = (state.generator,) if grad_compression == "int8" else ()
            bound.update(keys=keys, ptrs=[t.data_ptr() for t in _state_tensors(state)],
                         generator=state.generator)
            step.captured = CapturedStep(body, statics, dev, generators=gens)
            return state, step.captured()
        if (sorted(batch) != bound["keys"] or state.generator is not bound["generator"]
                or [t.data_ptr() for t in _state_tensors(state)] != bound["ptrs"]):
            raise ValueError("a captured train step is bound to the state storage "
                             "and batch keys of its first call")
        for k, static in zip(bound["keys"], step.captured.inputs):
            b = torch.as_tensor(batch[k])
            if b.shape != static.shape or b.dtype != static.dtype:
                raise ValueError(
                    f"a captured train step is bound to the batch of its first call: "
                    f"{k} {tuple(static.shape)} {static.dtype}, got {tuple(b.shape)} "
                    f"{b.dtype}")
            static.copy_(b)
        return state, step.captured()

    step.captured = None
    return step
