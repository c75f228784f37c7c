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

Under a mesh (``mesh=``, ``launch.mesh.spawn_mesh``: one process a
rank of a ``(data, model)`` grid) each step is the reference's sharded
step, with its collectives made explicit. On the data axis the rank
runs the loss on its rows of the global batch (``dist.sharding.
batch_shard``) inside ``dist.sharding.data_parallel``, so every
per-tensor activation statistic is the whole batch's. On the model axis
the rank's state holds its shard of every split leaf
(``dist.sharding.train_layout``: ``shard_state`` cuts it from the whole
one, ``gather_state`` joins it), float master weights that take the
gradients; the model reads them through ``train_views`` and runs the
model-axis collectives inside autograd (``dist.collectives.copy``,
``gather``, ``reduce``; remat's recompute repeats them), so a
replicated leaf's gradient is whole and the same on every model rank
and a split leaf's is its part of the single device's. Then the
gradients' exact mean over the data group, through one flat f32 bucket
(``dist.collectives.bucket_mean``); then the compression and AdamW,
clipped by the whole tree's norm (a sum over the model group) and
elementwise on the shards. This is the reference's order: its reduction
sits inside ``value_and_grad`` and compression straddles it. A batch
that does not divide the data size runs whole on every data rank
(replicated) with no collective of the data axis. Every family trains
over a model axis: encdec's encoder and cross attention and vlm's
projector split as the decoder does (``dist.sharding.train_layout``),
and the encoder output enters the decoder's k/v through one copy
(``transformer.forward``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
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
                     device: DeviceLike = None, mesh=None) -> TrainState:
    """Seeded params (``transformer.init_params``), a fresh AdamW state,
    the compression generator and, under any gradient compression, a
    zero residual, on ``device`` (default ``cuda``). The reference starts
    bf16 compression without a residual and makes one at the first step;
    a zero residual gives the same values and lets the step update it in
    place. ``mesh`` with a model axis: this rank's shards of the seeded
    params (``dist.sharding.shard_tree``) and of the rest; the generator
    is the same on every rank."""
    dev = resolve_device(device)
    params = T.init_params(cfg, seed=seed, device=dev)
    if mesh is not None:
        params = shd.shard_tree(params, shd.train_layout(cfg, mesh))
    residual = (gcomp.init_residual(params)
                if grad_compression not in (None, "none") else None)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    return TrainState(params, adamw.init(params), generator, residual)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.to(torch.int64)[..., None], dim=-1)[..., 0]
    return (logz - gold).mean()


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and metrics of ``batch``. ``mesh`` with a model axis:
    ``params`` are this rank's shards (``dist.sharding.shard_state``), read
    through ``train_views`` at the rank's widths (``local_config``); the
    logits are gathered whole, so the loss is replicated."""
    layout = shd.train_layout(cfg, mesh) if mesh is not None else None
    if layout is not None:
        params, cfg = shd.train_views(params, layout), shd.local_config(cfg, mesh)
    logits = T.forward(params, batch["tokens"], cfg, frames=batch.get("frames"),
                       patches=batch.get("patches"))
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_image_tokens:, :]
    loss = cross_entropy(logits, batch["labels"])
    acc = (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()
    return loss, {"loss": loss.detach(), "accuracy": acc}


def _split(batch: Dict[str, torch.Tensor], mesh) -> bool:
    """Whether the step runs ``batch`` split over ``mesh``'s data axis."""
    if mesh is None:
        return False
    return shd.batch_is_split(len(next(iter(batch.values()))), mesh)


def _model_axis(cfg: ArchConfig, mesh):
    """(group, layout) of ``mesh``'s model axis, (None, None) without one."""
    layout = None if mesh is None else shd.train_layout(cfg, mesh)
    return (None, None) if layout is None else (mesh.group, layout)


def _grads(state: TrainState, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
           grad_compression: Optional[str], mesh=None):
    """The loss's metrics, the gradients (compressed under
    ``grad_compression``, drawing from the state's generator) and the new
    residual; ``state`` is not modified. Under a split batch, the rank's
    rows, the gradients' mean over the data group, and the loss and
    accuracy averaged over it; under a model axis, the rank's shards'
    gradients (see the module docstring)."""
    split = _split(batch, mesh)
    group, layout = _model_axis(cfg, mesh)
    params = tree_map(lambda p: p.detach().requires_grad_(), state.params)
    # remat's recompute runs inside autograd.grad: the data group stays set
    with shd.data_parallel(mesh) if split else contextlib.nullcontext():
        loss, metrics = loss_fn(params, shd.batch_shard(batch, mesh) if split else batch,
                                cfg, mesh)
        found = torch.autograd.grad(loss, list(tree_leaves(params)))
    del loss
    with torch.no_grad():
        if split:
            group = mesh.data_group
            found = collectives.bucket_mean(found, group)
            both = collectives.all_reduce(
                torch.stack([metrics["loss"], metrics["accuracy"]]), group)
            both = both / mesh.shape["data"]
            metrics = {"loss": both[0], "accuracy": both[1]}
        found = iter(found)
        grads = tree_map(lambda p: next(found), params)
        residual = state.residual
        if grad_compression:
            grads, residual = gcomp.compress_grads(grads, grad_compression,
                                                   state.generator, residual,
                                                   layout, group)
    return metrics, grads, residual


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
               grad_compression: Optional[str] = None, mesh=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step; ``state`` is not modified (the generator
    advances where int8 compression draws from it). ``mesh``: this
    process is a rank of it, ``batch`` the global batch and, under a
    model axis, ``state`` the rank's shards (``dist.sharding.
    shard_state``)."""
    metrics, grads, residual = _grads(state, batch, cfg, grad_compression, mesh)
    with torch.no_grad():
        new_params, opt, gnorm = adamw.update(opt_cfg, grads, state.opt, state.params,
                                              *_model_axis(cfg, mesh))
    metrics = dict(metrics, grad_norm=gnorm)
    return TrainState(new_params, opt, state.generator, residual), metrics


def train_step_(state: TrainState, batch: Dict[str, torch.Tensor],
                cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                grad_compression: Optional[str] = None, mesh=None
                ) -> Dict[str, torch.Tensor]:
    """:func:`train_step` in place: the state's tensors keep their storage
    and take the values :func:`train_step` returns, bit for bit
    (``adamw.update_``). Returns the metrics."""
    metrics, grads, residual = _grads(state, batch, cfg, grad_compression, mesh)
    with torch.no_grad():
        if residual is not state.residual:
            if state.residual is None:
                raise ValueError("an in-place step under gradient compression "
                                 "needs the state's residual (init_train_state "
                                 "makes one)")
            tree_map(lambda r, new: r.copy_(new), state.residual, residual)
        gnorm = adamw.update_(opt_cfg, grads, state.opt, state.params,
                              *_model_axis(cfg, mesh))
    return dict(metrics, grad_norm=gnorm)


def bare_train_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                    opt_cfg: adamw.AdamWConfig) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The reference's single-argument form of :func:`train_step` (no
    compression, no mesh), which its dry run jits under shardings."""
    return train_step(state, batch, cfg, opt_cfg)


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    grad_compression: Optional[str] = None, mesh=None):
    """The eager, functional counterpart of the reference's
    ``make_jit_train_step``: ``step(state, batch) -> (state, metrics)``,
    a new state each call. The plain version of
    :func:`make_jit_train_step`. ``mesh``: a rank's step (its state
    sharded under a model axis)."""
    return functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                             grad_compression=grad_compression, mesh=mesh)


def _state_tensors(state: TrainState):
    return [t for t in ckpt.tree_flatten(state) if torch.is_tensor(t)]


def make_jit_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                        grad_compression: Optional[str] = None, mesh=None):
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
    CapturedStep` (None before the first call); ``step.graphed`` says
    whether the step is captured on the card.

    Under ``mesh`` (a rank of a data, model or both axes' grid) no graph
    is captured, and the step says so (``step.graphed`` is False): gloo
    drives its collectives from the host, which no CUDA graph can hold
    (the TP batcher turns its graphs off for the same reason). Every call
    then runs :func:`train_step_` eagerly on the state in place (the
    rank's shards under a model axis), the batch moved to the state's
    device."""
    if mesh is not None:

        def eager(state: TrainState, batch: Dict[str, torch.Tensor]):
            dev = state.opt.step.device
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            return state, train_step_(state, batch, cfg, opt_cfg, grad_compression,
                                      mesh)

        eager.captured = None
        eager.graphed = False
        return eager
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
    step.graphed = True
    return step
