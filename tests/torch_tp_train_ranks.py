"""Rank functions of the port's tensor-parallel training tests
(``test_torch_tp_train.py``, ``test_torch_cuda.py``).

``launch.mesh.spawn_mesh`` pickles a rank function by its import path and
runs it in fresh processes; this module imports neither JAX nor the JAX
package. A rank holds its shards of the state (``dist.sharding.
shard_state``), checks itself that every replicated leaf and gradient is
bit-equal on every rank of its model group (raising otherwise), and
returns whole trees (``gather_state``) for the test process to compare
with one device's.
"""
import dataclasses
import importlib
import os

import numpy as np
import torch
import torch.distributed as dist

import torch_dp_ranks as DP
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ternary_mac as tm
from repro_torch.models import transformer as T
from repro_torch.optim import compress as gcomp
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.trainer import TrainConfig, Trainer

ts = importlib.import_module("repro_torch.train.train_step")

def case_cfg(arch, act_scale="per_tensor", remat=False, mode="cim", fields=None,
             dtype="float32"):
    """A smoke config at f32: ``act_scale``, ``remat``, the quant ``mode``
    and any other ``fields`` of it."""
    cfg = DP.smoke_cfg(arch, act_scale, dtype=dtype, remat=remat).replace(**(fields or {}))
    if mode != "cim":
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, mode=mode))
    return cfg


def add_inputs(cfg):
    """The batch transform of ``cfg``'s family: encdec batches take
    ``frames`` (B, encoder_seq, d_model), vlm batches ``patches`` (B,
    n_image_tokens, d_vision), f32 normals from a generator seeded by the
    batch's token sum, so every rank (and a replay) makes the same ones;
    other families' batches pass as they are. Numpy in, numpy out; torch
    in, torch out."""
    shapes = {"encdec": ("frames", (cfg.encoder_seq, cfg.d_model)),
              "vlm": ("patches", (cfg.n_image_tokens, cfg.d_vision))}

    def add(batch):
        if cfg.family not in shapes:
            return batch
        key, shape = shapes[cfg.family]
        tokens = np.asarray(batch["tokens"], dtype=np.int64)
        rng = np.random.default_rng(int(tokens.sum()))
        extra = rng.standard_normal((tokens.shape[0],) + shape).astype(np.float32)
        if torch.is_tensor(batch["tokens"]):
            extra = torch.from_numpy(extra)
        return dict(batch, **{key: extra})

    return add


def case_batches(cfg, n=DP.STEPS):
    """Pipeline batches 0..n-1 as host tensors, with ``cfg``'s frames or
    patches (:func:`add_inputs`)."""
    add = add_inputs(cfg)
    return [add(b) for b in DP.batches(cfg.vocab, n)]


def _replicated(tree, layout):
    """The leaves of ``tree`` that ``layout`` keeps whole on every rank."""
    return [t for t, sp in zip(tree_leaves(tree), tree_leaves(layout)) if sp is None]


def check_model_replicas(tree, layout, mesh, what):
    """Raise unless every rank of the model group holds the replicated
    leaves of ``tree`` bit for bit."""
    leaves = _replicated(tree, layout)
    mine = torch.cat([t.detach().reshape(-1).view(torch.uint8).cpu() for t in leaves])
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine, group=mesh.group)
    bad = [r for r, other in enumerate(every) if not torch.equal(other, mine)]
    if bad:
        raise RuntimeError(f"model rank {mesh.rank}: replicated {what} differ from "
                           f"model ranks {bad}")


def tp_record(tree, cfg, mesh, device="cpu", steps=DP.STEPS, compression=None):
    """Step 0's loss and whole gradients, then ``steps`` steps of
    ``make_train_step(mesh=)`` on the rank's shards: the losses, grad
    norms and the whole params after. The replicated leaves' gradients
    and values are checked bit-equal over the model group. ``mesh``
    None: one device's run of the same."""
    dev = torch.device(device)
    layout = shd.train_layout(cfg, mesh)
    state = shd.shard_state(DP.state_from(tree, cfg, device), cfg, mesh)
    if compression:
        state = state._replace(residual=gcomp.init_residual(state.params))
    batch_list = [{k: v.to(dev) for k, v in b.items()} for b in case_batches(cfg, steps)]
    metrics, grads, _ = ts._grads(state, batch_list[0], cfg, None, mesh)
    if mesh is not None:
        check_model_replicas(grads, layout, mesh, "gradients")
    step = ts.make_train_step(cfg, DP.opt_cfg(), compression, mesh=mesh)
    losses, norms = [], []
    for b in batch_list:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    if mesh is not None:
        check_model_replicas(state.params, layout, mesh, "params")
    whole = shd.gather_state(state, cfg, mesh)
    return {"loss0": float(metrics["loss"]), "acc0": float(metrics["accuracy"]),
            "grads0": DP._flat(shd.gather_tree(grads, layout)), "losses": losses,
            "norms": norms, "params": DP._flat(whole.params)}


def one_step_counts(tree, cfg, mesh, device="cpu"):
    """One step's collectives (``collectives.COUNTS``) and #1's launches."""
    state = shd.shard_state(DP.state_from(tree, cfg, device), cfg, mesh)
    batch = {k: v.to(device) for k, v in case_batches(cfg, 1)[0].items()}
    step = ts.make_train_step(cfg, DP.opt_cfg(), mesh=mesh)
    before = tm.ternary_cim_matmul.launches
    C.reset_counts()
    step(state, batch)
    return {"collectives": dict(C.COUNTS), "launches": tm.ternary_cim_matmul.launches - before}


def copy_backward_as_identity(tree, cfg, mesh, only_enc=False):
    """The negative control: step 0's whole gradients with ``copy``'s
    backward replaced by the identity (no sum of the partial gradients);
    ``only_enc``: only the encoder output's copy into the decoder's k/v
    (``transformer._enc_entry``: the identity both ways)."""
    if only_enc:
        real, owner, name = T._enc_entry, T, "_enc_entry"
        patched = lambda params, enc: enc
    else:
        real, owner, name = C._Copy.backward, C._Copy, "backward"
        patched = staticmethod(lambda ctx, g: (g, None))
    setattr(owner, name, patched)
    try:
        state = shd.shard_state(DP.state_from(tree, cfg), cfg, mesh)
        _, grads, _ = ts._grads(state, case_batches(cfg, 1)[0], cfg, None, mesh)
    finally:
        setattr(owner, name, real)
    return DP._flat(shd.gather_tree(grads, shd.train_layout(cfg, mesh)))



def compression_round_trip(tree, cfg, mesh):
    """Step 0's whole gradients compressed on the rank's shards (int8 and
    bf16, with a residual) and gathered, beside the whole gradients
    compressed as one device does, from the same generator seed: equal
    bit for bit (checked here); returns the max |difference| per method."""
    layout = shd.train_layout(cfg, mesh)
    state = shd.shard_state(DP.state_from(tree, cfg), cfg, mesh)
    _, grads, _ = ts._grads(state, case_batches(cfg, 1)[0], cfg, None, mesh)
    whole = shd.gather_tree(grads, layout)
    out = {}
    for method in ("int8", "bf16"):
        res_whole = gcomp.init_residual(whole)
        res = shd.shard_tree(res_whole, layout)
        one, one_res = gcomp.compress_grads(whole, method, torch.Generator().manual_seed(3),
                                            res_whole)
        mine, my_res = gcomp.compress_grads(grads, method, torch.Generator().manual_seed(3),
                                            res, layout, mesh.group)
        gap = 0.0
        for a, b in zip(tree_leaves(shd.gather_tree(mine, layout)), tree_leaves(one)):
            gap = max(gap, float((a - b).abs().max()))
        for a, b in zip(tree_leaves(shd.gather_tree(my_res, layout)), tree_leaves(one_res)):
            gap = max(gap, float((a - b).abs().max()))
        out[method] = gap
    return out


def _trainer(mesh, ckpt_dir, num_steps, device="cpu", fail_at=(), arch="smollm-135m"):
    cfg = case_cfg(arch)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=DP.SEQ, global_batch=DP.BATCH))
    return Trainer(cfg, DP.opt_cfg(), TrainConfig(
        num_steps=num_steps, ckpt_dir=ckpt_dir, ckpt_every=DP.TRAINER_CKPT_EVERY,
        keep_last_n=5, async_ckpt=True, log_every=0), pipe, seed=0,
        failure_injector=DP.FailureInjector(list(fail_at)),
        batch_transform=add_inputs(cfg), device=device, mesh=mesh)


def _whole_state(trainer):
    st = shd.gather_state(trainer.state, trainer.cfg, trainer.mesh)
    return {"params": DP._flat(st.params), "mu": DP._flat(st.opt.mu),
            "nu": DP._flat(st.opt.nu), "opt_step": int(st.opt.step)}


def trainer_run(mesh, ckpt_dir, arch="smollm-135m"):
    """A Trainer of ``arch`` under ``mesh`` with a failure injected at
    TRAINER_FAIL_AT: its log, restarts, the checkpoints on disk and the
    whole state after (gathered from the shards)."""
    trainer = _trainer(mesh, ckpt_dir, DP.TRAINER_STEPS, fail_at=[DP.TRAINER_FAIL_AT],
                       arch=arch)
    trainer.run()
    layout = shd.train_layout(trainer.cfg, mesh)
    check_model_replicas(trainer.state.params, layout, mesh, "params")
    return dict(_whole_state(trainer), log=DP._log(trainer), restarts=trainer.restarts,
                steps=sorted(os.listdir(ckpt_dir)))


def trainer_restore(mesh, ckpt_dir):
    """A Trainer under ``mesh`` on a directory with a checkpoint (written
    on another grid): the whole state it restored at construction, then
    one more step (its log)."""
    trainer = _trainer(mesh, ckpt_dir, DP.TRAINER_STEPS + 1)
    restored = dict(_whole_state(trainer), start=trainer.start_step)
    trainer.run()
    return dict(restored, log=DP._log(trainer))


def tp_rank(mesh, trees, cases, extras, dirs):
    """One rank of the test module's ``mesh``: :func:`tp_record` for every
    case of ``cases`` ({name: (arch, act_scale, remat, mode, fields)}, moe at the
    data size's routing groups); then the ``extras`` named: "counts"
    (zamba2's one step), "control" (the negative control), "control_enc"
    (whisper's with only the encoder output's copy made the identity),
    "compress" (the round trip and an int8 step), "compress_families"
    (the round trip for whisper and llava), "trainer" (a Trainer run
    into ``dirs["trainer"]``), "trainer_encdec" (whisper's, into
    ``dirs["trainer_encdec"]``), "restore" (a Trainer restoring
    ``dirs["restore"]``). Rank 0's results."""
    out = {}
    for name, (arch, *case) in cases.items():
        cfg = case_cfg(arch, *case)
        out[name] = tp_record(trees[arch], cfg, mesh)
    smollm = case_cfg("smollm-135m")
    if "counts" in extras:
        out["counts"] = one_step_counts(trees["zamba2-2.7b"], case_cfg("zamba2-2.7b"), mesh)
    if "control" in extras:
        out["control"] = copy_backward_as_identity(trees["smollm-135m"], smollm, mesh)
    if "control_enc" in extras:
        whisper = case_cfg("whisper-large-v3")
        out["control_enc"] = copy_backward_as_identity(trees["whisper-large-v3"], whisper,
                                                       mesh, only_enc=True)
    if "compress_families" in extras:
        out["compress_families"] = {
            arch: compression_round_trip(trees[arch], case_cfg(arch), mesh)
            for arch in ("whisper-large-v3", "llava-next-34b")}
    if "compress" in extras:
        out["compress"] = compression_round_trip(trees["smollm-135m"], smollm, mesh)
        out["int8"] = tp_record(trees["smollm-135m"], smollm, mesh, compression="int8")
    if "trainer" in extras:
        out["trainer"] = trainer_run(mesh, dirs["trainer"])
    if "trainer_encdec" in extras:
        out["trainer_encdec"] = trainer_run(mesh, dirs["trainer_encdec"], "whisper-large-v3")
    if "restore" in extras:
        out["restored"] = trainer_restore(mesh, dirs["restore"])
    return out


def cuda_tp(mesh, tree_np, arch):
    """The test_torch_cuda case on one rank (every rank on cuda:0): smoke
    ``arch`` at f32 under per_row on the card (:func:`tp_record`), and
    #1's launches in the rank."""
    cfg = case_cfg(arch, "per_row")
    before = tm.ternary_cim_matmul.launches
    run = tp_record(tree_np, cfg, mesh, device=torch.device("cuda", 0))
    run["launches"] = tm.ternary_cim_matmul.launches - before
    return run


def max_gap(a, b):
    """The largest |difference| over the leaves of two flat trees."""
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)
