"""Fault-tolerant training loop (port of ``repro/train/trainer.py``).

The step is ``make_jit_train_step``'s, as the reference's Trainer runs
its jitted step: on the card one captured CUDA graph, replayed every
step, that updates the state in place. So the Trainer keeps one state
storage for its life: a restore and a restart from a fresh state copy
into it. Beyond calling the train step:
  * periodic async checkpoints (two-phase commit via ``train.checkpoint``),
  * crash recovery: on any step failure, let a checkpoint in flight
    commit, restore the last committed checkpoint and replay from there
    (the data pipeline is seekable, so every sample is used exactly
    once); a ``FailureInjector`` makes this path deterministic for tests,
  * straggler detection: steps slower than ``straggler_factor`` x the
    trailing median are logged and counted,
  * a metrics log of every step.

``run()`` steps under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` and restores the caller's setting after it: on the
card the embedding's and cross entropy's backward otherwise use atomic
adds, and a replayed step would not equal its first pass bit for bit,
as the reference's replays do by construction. The capture, at the
first step, runs under it too.

Under a mesh (``mesh=``: this process is one rank of a ``(data,
model)`` grid, ``launch.mesh.spawn_mesh``) every rank runs the loop, and
its step is the eager sharded step (``make_jit_train_step(mesh=)``): it
takes its rows of each global batch (``dist.sharding.batch_shard``) and,
under a model axis, holds its shards of the state
(``dist.sharding.shard_state``). The checkpoints hold the whole state:
the ranks of data row 0 gather it from their shards
(``dist.sharding.gather_state``) and rank (0, 0) writes it, with the
mesh in the manifest; the whole grid meets at a barrier after each save
and before each read of the last committed step. A ``FailureInjector``
given to every rank fails every rank at that step, and every rank
restores and replays it.

Elastic restore, the counterpart of the reference's ``shardings=``:
``restore(device=, mesh=)`` reads the last committed checkpoint, whole,
onto the current device or mesh and cuts this rank's shards from it, so
a checkpoint written on any grid resumes on any other: data 2 at data 1
or 4, model 2 on one device, one device at (2, 2).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.dist import sharding as shd
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import TrainState, init_train_state, make_jit_train_step


def _copy_state(dst: TrainState, src: TrainState) -> None:
    """Copy ``src``'s values into ``dst``'s tensors and generator in
    place: ``dst`` keeps its storage, which a captured step holds."""
    for d, v in zip(ckpt.tree_flatten(dst), ckpt.tree_flatten(src)):
        if isinstance(d, torch.Generator):
            d.set_state(v.get_state())
        else:
            d.copy_(v)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


@dataclasses.dataclass
class TrainConfig:
    num_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_last_n: int = 3
    async_ckpt: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0
    grad_compression: Optional[str] = None   # none | bf16 | int8
    max_restarts: int = 3


class FailureInjector:
    """Deterministic failure hook for fault-tolerance tests."""

    def __init__(self, fail_at_steps: Optional[List[int]] = None):
        self.fail_at = set(fail_at_steps or [])
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        opt_cfg: AdamWConfig,
        train_cfg: TrainConfig,
        pipeline: TokenPipeline,
        seed: int = 0,
        failure_injector: Optional[FailureInjector] = None,
        batch_transform: Optional[Callable[[Dict], Dict]] = None,
        device: DeviceLike = None,
        mesh=None,
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.train_cfg = train_cfg
        self.pipeline = pipeline
        self.seed = seed
        self.failure_injector = failure_injector
        self.batch_transform = batch_transform
        self.device = resolve_device(device)
        self.mesh = mesh
        self.step_fn = self._make_step()
        self.state: TrainState = self._fresh_state()
        self.start_step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []
        self.restarts = 0
        self._pending_ckpt = None
        if train_cfg.ckpt_dir and ckpt.latest_step(train_cfg.ckpt_dir) is not None:
            self.restore()

    def _make_step(self):
        return make_jit_train_step(self.cfg, self.opt_cfg,
                                   grad_compression=self.train_cfg.grad_compression,
                                   mesh=self.mesh)

    def _writer(self) -> bool:
        """Whether this process writes the checkpoints: the one process,
        or rank 0 of the mesh."""
        return self.mesh is None or (self.mesh.data_rank == 0 and self.mesh.rank == 0)

    def _barrier(self) -> None:
        """Every rank of the grid meets here (nothing without a mesh of
        more than one rank)."""
        if self.mesh is not None and self.mesh.data * self.mesh.size > 1:
            dist.barrier()

    def _fresh_state(self) -> TrainState:
        return init_train_state(self.cfg, self.seed, self.train_cfg.grad_compression,
                                self.device, mesh=self.mesh)

    # -- checkpoint/restore -------------------------------------------------

    def save(self, step: int):
        tc = self.train_cfg
        if not tc.ckpt_dir:
            return
        state = self.state
        if self.mesh is not None and self.mesh.data_rank == 0:
            # the whole state, gathered over the writer's model group
            state = shd.gather_state(state, self.cfg, self.mesh)
        if self._writer():
            if self._pending_ckpt is not None:
                self._pending_ckpt.result()  # don't overlap two saves
            extra = {"arch": self.cfg.name, "data_step": step}
            if self.mesh is not None:
                extra["mesh"] = self.mesh.shape
            self._pending_ckpt = ckpt.save(tc.ckpt_dir, step, state, extra=extra,
                                           async_=tc.async_ckpt)
            ckpt.gc_old(tc.ckpt_dir, tc.keep_last_n)
        self._barrier()

    def _committed_step(self) -> Optional[int]:
        """The last committed step, read by every rank once rank 0's
        checkpoint in flight has committed."""
        self._drain()  # never read a mid-commit checkpoint
        self._barrier()
        return ckpt.latest_step(self.train_cfg.ckpt_dir)

    def restore(self, device: DeviceLike = None, mesh=None) -> int:
        """Restore the last committed checkpoint onto ``device`` (default:
        the Trainer's) and, given ``mesh``, continue as a rank of it
        (elastic restore: the checkpoint holds the whole state, and this
        rank takes its shards of it for any data and model sizes). Where
        the rank's state keeps its shapes on its own device, it keeps its
        storage (a captured step holds it); else the Trainer makes a state
        there, which takes the checkpoint (its generator too, so the
        checkpoint must come from a device of the same type), and the
        step is made anew."""
        if mesh is not None:
            self.mesh = mesh
            self.step_fn = self._make_step()
        self._committed_step()
        target = self.device if device is None else resolve_device(device)
        if not _same_device(target, self.device):
            self.device = target
            self.state = self._fresh_state()
            self.step_fn = self._make_step()
        whole, step = ckpt.restore(self.train_cfg.ckpt_dir, self.state, device="cpu")
        restored = shd.shard_state(whole, self.cfg, self.mesh)
        shapes = lambda st: [tuple(t.shape) for t in ckpt.tree_flatten(st)
                             if torch.is_tensor(t)]
        if shapes(restored) != shapes(self.state):
            # another model size: the rank's shards have other shapes
            self.state = self._fresh_state()
            self.step_fn = self._make_step()
        _copy_state(self.state, restored)
        self.start_step = step
        return step

    # -- main loop ----------------------------------------------------------

    def _one_step(self, step: int) -> Dict[str, float]:
        batch = self.pipeline.batch(step)
        if self.batch_transform:
            batch = self.batch_transform(batch)
        # host tensors: the step copies them into its static inputs
        # analysis: host-sync ok -- the pipeline's host batch, copied into the step's inputs
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        if self.failure_injector:
            self.failure_injector.maybe_fail(step)
        self.state, metrics = self.step_fn(self.state, batch)
        names = sorted(metrics)
        # analysis: host-sync ok -- one host transfer of a step's metrics, after the step
        values = torch.stack([metrics[k].to(torch.float32) for k in names]).cpu()
        return dict(zip(names, values.tolist()))  # analysis: host-sync ok -- a host tensor

    def _drain(self):
        if self._pending_ckpt is not None:
            self._pending_ckpt.result()
            self._pending_ckpt = None

    def run(self) -> List[Dict[str, float]]:
        enabled = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            return self._run()
        finally:
            torch.use_deterministic_algorithms(enabled, warn_only=warn_only)

    def _run(self) -> List[Dict[str, float]]:
        tc = self.train_cfg
        step = self.start_step
        durations: List[float] = []
        while step < tc.num_steps:
            t0 = time.perf_counter()
            try:
                metrics = self._one_step(step)
            except Exception as e:  # node failure path
                self.restarts += 1
                # drain in-flight checkpoint IO first: callers tear down
                # the directory after a raise, and the restore below must
                # not depend on whether the last commit beat the failure
                self._drain()
                if self.restarts > tc.max_restarts or not tc.ckpt_dir:
                    raise
                if self._committed_step() is not None:
                    step = self.restore()
                else:  # failure before the first checkpoint: restart from 0
                    _copy_state(self.state, self._fresh_state())
                    step = 0
                print(f"[trainer] recovered from failure ({e}); resuming at step {step}")
                continue
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = float(np.median(durations[-20:]))
            if len(durations) > 5 and dt > tc.straggler_factor * med:
                self.straggler_steps.append(step)
                print(f"[trainer] straggler step {step}: {dt:.3f}s vs median {med:.3f}s")
            metrics["step"] = step
            metrics["sec"] = dt
            self.metrics_log.append(metrics)
            if tc.log_every and step % tc.log_every == 0:
                print(f"[trainer] step {step:5d} loss {metrics['loss']:.4f} "
                      f"acc {metrics['accuracy']:.3f} ({dt:.2f}s)")
            step += 1
            if tc.ckpt_dir and step % tc.ckpt_every == 0:
                self.save(step)
        if tc.ckpt_dir:
            self.save(step)
            self._drain()
            self._barrier()
        return self.metrics_log
