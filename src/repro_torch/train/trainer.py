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

Single process on one device: the reference's elastic restore onto
another mesh has no counterpart until the port has tensor parallelism.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import TokenPipeline
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
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.train_cfg = train_cfg
        self.pipeline = pipeline
        self.seed = seed
        self.failure_injector = failure_injector
        self.batch_transform = batch_transform
        self.device = resolve_device(device)
        self.step_fn = make_jit_train_step(cfg, opt_cfg,
                                           grad_compression=train_cfg.grad_compression)
        self.state: TrainState = self._fresh_state()
        self.start_step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []
        self.restarts = 0
        self._pending_ckpt = None
        if train_cfg.ckpt_dir and ckpt.latest_step(train_cfg.ckpt_dir) is not None:
            self.restore()

    def _fresh_state(self) -> TrainState:
        return init_train_state(self.cfg, self.seed, self.train_cfg.grad_compression,
                                self.device)

    # -- checkpoint/restore -------------------------------------------------

    def save(self, step: int):
        tc = self.train_cfg
        if not tc.ckpt_dir:
            return
        if self._pending_ckpt is not None:
            self._pending_ckpt.result()  # don't overlap two saves
        self._pending_ckpt = ckpt.save(
            tc.ckpt_dir, step, self.state,
            extra={"arch": self.cfg.name, "data_step": step},
            async_=tc.async_ckpt)
        ckpt.gc_old(tc.ckpt_dir, tc.keep_last_n)

    def restore(self) -> int:
        if self._pending_ckpt is not None:
            self._pending_ckpt.result()  # never read a mid-commit checkpoint
            self._pending_ckpt = None
        restored, step = ckpt.restore(self.train_cfg.ckpt_dir, self.state,
                                      device="cpu")
        _copy_state(self.state, restored)
        self.start_step = step
        return step

    # -- main loop ----------------------------------------------------------

    def _one_step(self, step: int) -> Dict[str, float]:
        batch = self.pipeline.batch(step)
        if self.batch_transform:
            batch = self.batch_transform(batch)
        # host tensors: the step copies them into its static inputs
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        if self.failure_injector:
            self.failure_injector.maybe_fail(step)
        self.state, metrics = self.step_fn(self.state, batch)
        names = sorted(metrics)
        values = torch.stack([metrics[k].to(torch.float32) for k in names]).cpu()
        return dict(zip(names, values.tolist()))  # one host transfer

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
                if ckpt.latest_step(tc.ckpt_dir) is not None:
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
        return self.metrics_log
