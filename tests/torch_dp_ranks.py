"""Rank functions of the port's data-parallel tests (``test_torch_dp.py``,
``test_torch_cuda.py``), and the single-device runs they are held to.

``launch.mesh.spawn_mesh`` pickles a rank function by its import path and
runs it in fresh processes; this module imports neither JAX nor the JAX
package, so the ranks start with torch only. Each rank function runs
every check of its mesh in one spawned group, holds the replicated state
bit-equal across the data ranks itself (raising otherwise), and returns
plain data for the test process to compare.
"""
import contextlib
import dataclasses
import importlib
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import params_from_numpy
from repro_torch.core import ternary as tern
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ternary_mac as tm
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import FailureInjector, TrainConfig, Trainer

# the module, not the function that repro_torch.train exports by its name
ts = importlib.import_module("repro_torch.train.train_step")

STEPS = 3
SEQ, BATCH = 16, 4
LR = 1e-3
# the Trainer runs: checkpoints at 2 and 4, a failure at 3 replays step 2
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_FAIL_AT = 4, 2, 3


def smoke_cfg(arch, act_scale="per_tensor", dtype="float32", remat=False):
    cfg = get_config(arch, smoke=True)
    return cfg.replace(dtype=dtype, remat=remat,
                       quant=dataclasses.replace(cfg.quant, act_scale=act_scale))


def opt_cfg():
    return adamw.AdamWConfig(lr=LR, schedule=warmup_cosine(2, STEPS))


def batches(vocab, n=STEPS, batch=BATCH, seq=SEQ):
    """Pipeline batches 0..n-1 as host tensors."""
    pipe = TokenPipeline(DataConfig(vocab=vocab, seq_len=seq, global_batch=batch))
    return [{k: torch.from_numpy(v) for k, v in pipe.batch(i).items()} for i in range(n)]


def state_from(tree, cfg, device="cpu"):
    """A fresh train state on the bridged ``tree`` (numpy, f32)."""
    params = params_from_numpy(tree, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    return ts.TrainState(params, adamw.init(params), gen, None)


@contextlib.contextmanager
def recorded_codes():
    """The activation codes of every per-tensor ternarization in the
    body (``dense`` with ``act_scale="per_tensor"``; weights and per-row
    scales take an axis), as int8, in call order."""
    real, codes = tern.ternarize, []

    def spy(x, axis=None, factor=tern.TWN_THRESHOLD_FACTOR, reduce=None):
        t, scale = real(x, axis, factor, reduce)
        if axis is None:
            codes.append(t.detach().to(torch.int8).cpu())
        return t, scale

    tern.ternarize = spy
    try:
        yield codes
    finally:
        tern.ternarize = real


def _flat(tree):
    """{path: numpy copy} of a nested dict of tensors (a copy: a CPU
    tensor's ``numpy()`` shares its storage, which an in-place step
    rewrites)."""
    return {k: (v.detach().float().cpu().numpy().copy() if torch.is_tensor(v) else v)
            for k, v in _paths(tree)}


def _paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def train_record(state, batch_list, cfg, mesh=None, device="cpu"):
    """Step 0's forward codes (per-tensor scales; a data rank's gathered
    over its data group into batch order), loss and gradients, then
    ``len(batch_list)`` steps of ``make_train_step(mesh=)``: the losses,
    grad norms and the params after. On a mesh the params are checked
    bit-equal on every data rank."""
    dev = torch.device(device)
    batch_list = [{k: v.to(dev) for k, v in b.items()} for b in batch_list]
    split = mesh is not None and shd.batch_is_split(len(batch_list[0]["tokens"]), mesh)
    with torch.no_grad(), recorded_codes() as codes:
        if split:
            with shd.data_parallel(mesh):
                ts.loss_fn(state.params, shd.batch_shard(batch_list[0], mesh), cfg)
        else:
            ts.loss_fn(state.params, batch_list[0], cfg)
    if split:
        codes = [C.all_gather(c, mesh.data_group, dim=0) for c in codes]
    metrics, grads, _ = ts._grads(state, batch_list[0], cfg, None, mesh)
    step = ts.make_train_step(cfg, opt_cfg(), mesh=mesh)
    losses, norms = [], []
    for b in batch_list:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    if mesh is not None and mesh.data_group is not None:
        check_replicas(state.params, mesh)
    return {"codes": [c.numpy() for c in codes], "loss0": float(metrics["loss"]),
            "acc0": float(metrics["accuracy"]), "grads0": _flat(grads),
            "losses": losses, "norms": norms, "params": _flat(state.params)}


def check_replicas(tree, mesh):
    """Raise unless every data rank holds ``tree`` bit for bit (all its
    leaves' bytes gathered over the data group)."""
    mine = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in tree_leaves(tree)]).cpu()
    every = [torch.empty_like(mine) for _ in range(mesh.data)]
    dist.all_gather(every, mine, group=mesh.data_group)
    bad = [r for r, other in enumerate(every) if not torch.equal(other, mine)]
    if bad:
        raise RuntimeError(f"data rank {mesh.data_rank}: the state differs from "
                           f"data ranks {bad}")


def dp_rank(mesh, trees, cases, odd_batch, trainer_dir, restore_dir, device="cpu"):
    """One data rank of the test module's mesh: every case of ``cases``
    ({name: (arch, act_scale, remat)}) through :func:`train_record`; smollm on
    ``odd_batch`` (rows not a multiple of the data size: replicated);
    the launch count of #1 in one step; and the Trainer: with
    ``trainer_dir``, a run of TRAINER_STEPS with checkpoints every
    TRAINER_CKPT_EVERY and a failure at TRAINER_FAIL_AT; with
    ``restore_dir``, a Trainer that restores the last checkpoint there
    (written at another data size) and takes one more step. Rank 0's
    results."""
    out = {}
    for name, (arch, act_scale, remat) in cases.items():
        cfg = smoke_cfg(arch, act_scale, remat=remat)
        out[name] = train_record(state_from(trees[arch], cfg, device),
                                 batches(cfg.vocab), cfg, mesh, device)
    cfg = smoke_cfg("smollm-135m", "per_tensor")
    out["odd"] = train_record(state_from(trees["smollm-135m"], cfg, device),
                              [odd_batch], cfg, mesh, device)
    before = tm.ternary_cim_matmul.launches
    C.reset_counts()
    ts.make_train_step(cfg, opt_cfg(), mesh=mesh)(
        state_from(trees["smollm-135m"], cfg, device), batches(cfg.vocab, 1)[0])
    out["launches"] = tm.ternary_cim_matmul.launches - before
    out["collectives"] = dict(C.COUNTS)
    if trainer_dir is not None:
        out["trainer"] = trainer_run(mesh, trainer_dir, device)
    if restore_dir is not None:
        out["restored"] = trainer_restore(mesh, restore_dir, device)
    return out


def _trainer(mesh, ckpt_dir, num_steps, device, fail_at=()):
    cfg = smoke_cfg("smollm-135m", "per_tensor")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
    return Trainer(cfg, opt_cfg(), TrainConfig(
        num_steps=num_steps, ckpt_dir=ckpt_dir, ckpt_every=TRAINER_CKPT_EVERY,
        keep_last_n=5, async_ckpt=True, log_every=0), pipe, seed=0,
        failure_injector=FailureInjector(list(fail_at)), device=device, mesh=mesh)


def _log(trainer):
    return [(m["step"], m["loss"], m["accuracy"], m["grad_norm"])
            for m in trainer.metrics_log]


def trainer_run(mesh, ckpt_dir, device="cpu"):
    """A Trainer under ``mesh`` with an injected failure: its log (every
    rank's the same), restarts, the checkpoints on disk and the state
    after (checked bit-equal on every data rank)."""
    trainer = _trainer(mesh, ckpt_dir, TRAINER_STEPS, device, [TRAINER_FAIL_AT])
    trainer.run()
    log = _log(trainer)
    if mesh is not None and mesh.data_group is not None:
        every = [None] * mesh.data
        dist.all_gather_object(every, log, group=mesh.data_group)
        if any(other != log for other in every):
            raise RuntimeError(f"data rank {mesh.data_rank}: the Trainer logs differ")
        check_replicas(trainer.state.params, mesh)
        check_replicas(trainer.state.opt.mu, mesh)
    return {"log": log, "restarts": trainer.restarts,
            "steps": sorted(os.listdir(ckpt_dir)),
            "params": _flat(trainer.state.params), "mu": _flat(trainer.state.opt.mu),
            "nu": _flat(trainer.state.opt.nu), "opt_step": int(trainer.state.opt.step)}


def trainer_restore(mesh, ckpt_dir, device="cpu"):
    """A Trainer under ``mesh`` on a directory with a checkpoint: the
    state it restored at construction, then one more step (its log)."""
    trainer = _trainer(mesh, ckpt_dir, TRAINER_STEPS + 1, device)
    restored = {"start": trainer.start_step, "params": _flat(trainer.state.params),
                "mu": _flat(trainer.state.opt.mu), "nu": _flat(trainer.state.opt.nu),
                "opt_step": int(trainer.state.opt.step)}
    trainer.run()
    if mesh is not None and mesh.data_group is not None:
        check_replicas(trainer.state.params, mesh)
    return dict(restored, log=_log(trainer))


def moe_halves(tparams, cfg, x, divisor):
    """``moe_block`` on ``x`` at ``divisor`` routing groups, and ``torch.
    cat`` of the ``divisor`` single-group calls on its row blocks."""
    shd.enable_activation_sharding(batch_divisor=divisor)
    try:
        grouped = moe.moe_block(tparams, x, cfg)
    finally:
        shd.disable_activation_sharding()
    n = x.shape[0] // divisor
    parts = torch.cat([moe.moe_block(tparams, x[i * n:(i + 1) * n], cfg)
                       for i in range(divisor)])
    return grouped, parts


def cuda_dp(mesh, tree_np, arch):
    """The test_torch_cuda case on one rank (every rank on cuda:0): smoke
    ``arch`` at f32 under per_row, :func:`train_record` on the card, and
    #1's launches in one step."""
    cfg = smoke_cfg(arch, "per_row")
    dev = torch.device("cuda", 0)
    before = tm.ternary_cim_matmul.launches
    run = train_record(state_from(tree_np, cfg, dev), batches(cfg.vocab), cfg, mesh, dev)
    run["launches"] = tm.ternary_cim_matmul.launches - before
    return run


def numpy_tree(cfg, seed=0):
    """A seeded port param tree as numpy f32 (the card tests' weights)."""
    params = T.init_params(cfg.replace(dtype="float32"), seed=seed, device="cpu")
    return {k: v for k, v in _np(params).items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.float().numpy()
            for k, v in tree.items()}


def moved(a, b):
    """Codes that differ between two runs' code lists (same shapes)."""
    return int(sum(int((np.asarray(x) != np.asarray(y)).sum()) for x, y in zip(a, b)))
