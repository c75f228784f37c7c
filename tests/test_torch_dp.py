"""Data-parallel training of the port (``launch.mesh`` with a data axis,
``dist.sharding``'s activation-sharding state and ``batch_shard``, MoE's
grouped dispatch, the data-parallel ``train_step``, the Trainer under a
mesh and its elastic restore) against the port on one device and
against the JAX package's batch-sharded jitted step.

The port's data ranks are processes of a gloo group on the CPU, spawned
once per data size for the whole module (``launch.mesh.spawn_mesh``, the
rank functions in ``torch_dp_ranks.py``, each rank checking the
replicated state bit-equal over its data group); the JAX side runs here
on 2 of the 8 virtual devices of ``conftest.py``. All at smoke size and
f32. The contract and its tolerances:

  * MoE's grouped dispatch: the port's ``moe_block`` under
    ``enable_activation_sharding(batch_divisor=G)`` against the
    reference's, at ``test_torch_moe.py``'s f32 bound (atol 1e-5), and G
    groups in one call == G single-group calls on the row blocks, bit
    for bit (the invariant that lets a data rank route its rows alone);
  * the data-2 and data-4 steps against the port's single device (moe at
    the same routing groups; at data 2 smollm also per_tensor and under
    remat, whose recompute runs the statistics' collectives again; data
    4 repeats moe): the per-tensor activation codes of step
    0's forward counted where they move (none at this seed), step 0's
    loss at rtol 1e-6 and its gradients at rtol 1e-5 / atol 1e-6 (the
    f32 sums of the split batch run in another order), and after three
    AdamW steps every weight within lr/10 (ROADMAP's training bound);
  * the data-2 step against the reference's ``jax.jit(train_step,
    in_shardings=...)`` over a (2, 1) mesh: step 0's loss at rtol 1e-5,
    the three losses at rtol 1e-3 (the cross-package CiM training bound
    of ``test_torch_train_step.py``: a weight that crosses the TWN
    threshold moves its code);
  * a batch that does not divide the data size runs replicated: one
    device's step, bit for bit;
  * elastic restore: a checkpoint written at data 2 restores bit for bit
    at data 1 and data 4 and steps on; an injected failure replays
    bit-equal on every rank;
  * the mesh helpers and the activation-sharding switch against the
    reference's.
"""
import concurrent.futures
import dataclasses
import functools
import importlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dp_ranks as R
from repro.dist import sharding as jshd
from repro.launch.mesh import mesh_batch_divisor as jmesh_batch_divisor
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.optim.schedules import warmup_cosine as jwarmup_cosine
from repro_torch.bridge import params_from_numpy
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as M
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw
from torch_threads import one_thread  # noqa: F401

jts = importlib.import_module("repro.train.train_step")
ts = importlib.import_module("repro_torch.train.train_step")

SPAWN_TIMEOUT = 240.0
ARCHS = ("smollm-135m", "deepseek-v2-236b")
# {case: (arch, act_scale, remat)}; under remat the per-tensor statistics'
# collectives run again in the backward's recompute
CASES = {"per_row": ("smollm-135m", "per_row", False),
         "per_tensor": ("smollm-135m", "per_tensor", False),
         "remat": ("smollm-135m", "per_tensor", True),
         "moe": ("deepseek-v2-236b", "per_tensor", False)}
# the case the data-4 group repeats: the others run the same collectives
# at data 2; moe's routing groups and per-tensor statistics depend on the
# data size
CASES4 = ("moe",)
MOE_ARCHS = ("deepseek-v2-236b", "grok-1-314b")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jcfg(arch, act_scale="per_tensor"):
    jcfg = jget_config(arch, smoke=True)
    return jcfg.replace(dtype="float32",
                        quant=dataclasses.replace(jcfg.quant, act_scale=act_scale))


@pytest.fixture(scope="module")
def trees():
    # jitted: one compile in place of an eager dispatch per random draw
    init = jax.jit(jT.init_params, static_argnums=1)
    return {a: _np_tree(init(jax.random.PRNGKey(0), _jcfg(a))) for a in ARCHS}


def _odd(rows):
    return R.batches(256, 1, batch=rows)[0]


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    return tmp_path_factory.mktemp("dp2"), tmp_path_factory.mktemp("dp4")


def _spawn_both(trees, ckpt_dirs):
    dp2 = M.spawn_mesh(R.dp_rank, 2, 1, trees, CASES, _odd(3), str(ckpt_dirs[0]), None,
                       timeout=SPAWN_TIMEOUT, threads=1)
    # data 4 restores a copy of the data-2 checkpoints (its Trainer writes)
    four = ckpt_dirs[1] / "ckpt"
    shutil.copytree(ckpt_dirs[0], four)
    dp4 = M.spawn_mesh(R.dp_rank, 4, 1, trees, {k: CASES[k] for k in CASES4}, _odd(6),
                       None, str(four),
                       timeout=SPAWN_TIMEOUT, threads=1)
    return dp2, dp4


@pytest.fixture(scope="module", autouse=True)
def ranks(trees, ckpt_dirs):
    """The data-2 group, then the data-4 group, spawned once for the
    module in a background thread from its start: the ranks are
    processes of their own, so the tests of JAX code before the first
    test that reads them run meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(_spawn_both, trees, ckpt_dirs)


@pytest.fixture(scope="module")
def dp2(ranks):
    return ranks.result(timeout=4 * SPAWN_TIMEOUT)[0]


@pytest.fixture(scope="module")
def dp4(ranks):
    return ranks.result(timeout=4 * SPAWN_TIMEOUT)[1]


def _single_run(trees, case, divisor):
    arch, act_scale, remat = CASES[case]
    cfg = R.smoke_cfg(arch, act_scale, remat=remat)
    # the data size's routing groups, as the reference's dry-run enables them
    shd.enable_activation_sharding(batch_divisor=divisor)
    try:
        return R.train_record(R.state_from(trees[arch], cfg), R.batches(cfg.vocab), cfg)
    finally:
        shd.disable_activation_sharding()


@pytest.fixture(scope="module")
def single(trees):
    # only moe's routing groups depend on the data size
    out = {(case, d): _single_run(trees, case, d) for case in CASES for d in (2, 4)
           if case == "moe" or d == 2}
    out.update({(case, 4): out[(case, 2)] for case in CASES if case != "moe"})
    return out


# ---------------------------------------------------------------------------
# (a) MoE's grouped dispatch
# ---------------------------------------------------------------------------


def _moe_pair(arch, act_scale="per_tensor", **fields):
    jcfg = _jcfg(arch, act_scale).replace(**fields)
    tcfg = R.smoke_cfg(arch, act_scale).replace(**fields)
    jparams = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    tparams = params_from_numpy({"moe": tree}, tcfg, device="cpu")["moe"]
    return jcfg, tcfg, jparams, tparams


def _moe_x(seed=0):
    return np.random.default_rng(seed).standard_normal((4, 16, 64)).astype(np.float32)


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("divisor", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_moe_block_matches_reference(arch, divisor, factor):
    """G routing groups, each with capacity moe_capacity(T/G): the port
    against the reference under the same divisor (f32 atol 1e-5, as
    test_torch_moe.py), at the configs' capacity factor and at 0.5, where
    a group's capacity binds: there the groups drop other assignments
    than one group over the batch would (the result differs from G = 1)."""
    jcfg, tcfg, jparams, tparams = _moe_pair(arch, moe_capacity_factor=factor)
    x = _moe_x()
    jshd.enable_activation_sharding(multi_pod=False, batch_divisor=divisor)
    shd.enable_activation_sharding(batch_divisor=divisor)
    try:
        # jitted, as the reference's step runs it (the divisor is read
        # while it traces)
        want = np.asarray(jax.jit(functools.partial(jmoe.moe_block, cfg=jcfg))(
            jparams, jnp.asarray(x)))
        got = tmoe.moe_block(tparams, torch.from_numpy(x), tcfg).numpy()
    finally:
        jshd.disable_activation_sharding()
        shd.disable_activation_sharding()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if factor < 1:
        ungrouped = tmoe.moe_block(tparams, torch.from_numpy(x), tcfg).numpy()
        assert np.abs(got - ungrouped).max() > 1e-3


@pytest.mark.parametrize("divisor", [2, 4])
@pytest.mark.parametrize("arch,act_scale", [("deepseek-v2-236b", "per_row"),
                                            ("grok-1-314b", "per_row"),
                                            ("grok-1-314b", "per_tensor")])
def test_groups_equal_rank_local_calls_bit_for_bit(arch, act_scale, divisor):
    """moe_block at divisor G == torch.cat of G single-group calls on its
    row blocks, bit for bit: the routed experts never cross a group. The
    shared experts (deepseek-v2) are dense layers over the whole call, so
    under per_tensor their statistic spans the call: held per_row."""
    _, tcfg, _, tparams = _moe_pair(arch, act_scale)
    grouped, parts = R.moe_halves(tparams, tcfg, torch.from_numpy(_moe_x(1)), divisor)
    assert torch.equal(grouped, parts)


def test_routing_groups_rule():
    """The enabled divisor where it divides the batch, else 1; always 1
    inside a data-parallel rank."""
    assert shd.routing_groups(8) == 1
    shd.enable_activation_sharding(batch_divisor=4)
    try:
        assert [shd.routing_groups(b) for b in (8, 4, 6, 1)] == [4, 4, 1, 1]
        mesh = M.TPMesh(None, 0, 1, (0,), M.AXIS_NAMES, 4, 0, "group", (0, 1, 2, 3))
        with shd.data_parallel(mesh):
            assert shd.routing_groups(8) == 1 and shd.data_group() == "group"
        assert shd.data_group() is None
    finally:
        shd.disable_activation_sharding()


# ---------------------------------------------------------------------------
# (f) the mesh helpers and the activation-sharding switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_and_batch_divisor(multi_pod):
    """The reference's production shapes and axis names as sizes; the
    reference's mesh_batch_divisor on the port's abstract mesh agrees
    with the port's; spawn_mesh refuses it."""
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    if multi_pod:
        assert mesh.sizes == (2, 16, 16) and mesh.axis_names == ("pod", "data", "model")
    else:
        assert mesh.sizes == (16, 16) and mesh.axis_names == ("data", "model")
    assert mesh.size == (512 if multi_pod else 256)
    assert M.mesh_batch_divisor(mesh) == jmesh_batch_divisor(mesh) == (32 if multi_pod else 16)
    with pytest.raises(TypeError):
        M.spawn_mesh(R.dp_rank, mesh, 1)


def test_batch_divisor_of_host_meshes():
    """On meshes of the 8 host devices the reference's divisor equals the
    port's on a mesh of the same sizes; a TP mesh's is 1."""
    for shape, names in (((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))):
        jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(shape), names)
        assert M.mesh_batch_divisor(M.AbstractMesh(shape, names)) == jmesh_batch_divisor(jmesh)
    assert M.mesh_batch_divisor(M.TPMesh(None, 0, 3, (0, 1, 2))) == 1
    assert M.TPMesh(None, 0, 3, data=2).shape == {"data": 2, "model": 3}


def test_smoke_mesh_is_one_by_one_for_one_process():
    """The reference's rule below 4 devices: (1, 1) (this process has no
    group, so it gets a 1-rank one)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = M.make_smoke_mesh()
    try:
        assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
        assert M.mesh_batch_divisor(mesh) == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_fsdp_at_production_sizes(arch, multi_pod):
    """param_specs(fsdp=True) at the production mesh's sizes == the
    reference's, leaf for leaf, on the full-size configs' shapes (no
    weight is made: both rules read shapes only)."""
    jcfg = jget_config(arch)
    shapes = jax.eval_shape(lambda k: jT.init_params(k, jcfg), jax.random.PRNGKey(0))
    sizes = M.make_production_mesh(multi_pod=multi_pod).shape
    want = jshd.param_specs(shapes, fsdp=True, axis_sizes=sizes)
    got = shd.param_specs(shapes, fsdp=True, axis_sizes=sizes)
    flat_want = {"/".join(jshd._key_str(k) for k in path): tuple(spec) for path, spec in
                 jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda s: isinstance(s, P))[0]}
    flat_got = dict(R._paths(got))
    assert flat_got.keys() == flat_want.keys()
    for k, spec in flat_want.items():
        assert flat_got[k] == spec, k
    assert any("data" in s for s in flat_got.values())


def test_activation_sharding_disabled_is_identity():
    """The reference's TestActivationSharding.test_disabled_is_identity."""
    shd.disable_activation_sharding()
    x = torch.ones((4, 8, 16))
    assert shd.shard_act(x, "btd") is x
    assert shd.batch_axes() == () and shd.model_axis_size() == 1


def test_activation_sharding_batch_divisor_guard():
    """The reference's test_batch_divisor_guard: a batch that does not
    divide the divisor is not an error; the enabled state reads as the
    reference's does."""
    jshd.enable_activation_sharding(multi_pod=True, batch_divisor=16, model_size=4)
    shd.enable_activation_sharding(multi_pod=True, batch_divisor=16, model_size=4)
    try:
        x = torch.ones((1, 8, 16))
        y = shd.shard_act(x, "btd")
        assert y.shape == x.shape
        assert shd.batch_axes() == jshd.batch_axes() == ("pod", "data")
        assert shd.model_axis_size() == jshd.model_axis_size() == 4
        assert shd._ACT_AXES == jshd._ACT_AXES
        # a mesh still gives its own size
        assert shd.model_axis_size(M.TPMesh(None, 0, 2)) == 2
    finally:
        jshd.disable_activation_sharding()
        shd.disable_activation_sharding()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_train_step_under_a_model_axis_is_eager(arch):
    """The encdec and vlm families train over a model axis as every
    family does (their steps: test_torch_tp_train.py): under a mesh with
    model > 1, as under a data mesh, the jit step is made eagerly, and
    the state holds the rank's shards (fewer elements than the whole)."""
    cfg = R.smoke_cfg(arch)
    opt = adamw.AdamWConfig(lr=R.LR)
    for mesh in (M.TPMesh(None, 0, 2, (0, 1)), M.TPMesh(None, 0, 2, (0, 1), data=2)):
        step = ts.make_jit_train_step(cfg, opt, mesh=mesh)
        assert step.graphed is False and step.captured is None
    size = lambda st: sum(t.numel() for t in adamw.tree_leaves(st.params))
    state = ts.init_train_state(cfg, device="cpu", mesh=M.TPMesh(None, 0, 2, (0, 1)))
    assert size(state) < size(ts.init_train_state(cfg, device="cpu"))


def test_jit_train_step_under_a_data_mesh_is_eager():
    """Under a data mesh the jit step runs eagerly (gloo's collectives
    cannot sit in a CUDA graph); without a mesh it is captured."""
    cfg = R.smoke_cfg("smollm-135m")
    opt = adamw.AdamWConfig(lr=R.LR)
    step = ts.make_jit_train_step(cfg, opt, mesh=M.TPMesh(None, 0, 1, data=2))
    assert step.graphed is False and step.captured is None
    assert ts.make_jit_train_step(cfg, opt).graphed is True


# ---------------------------------------------------------------------------
# (c) against the reference's batch-sharded jitted step
# ---------------------------------------------------------------------------


def _reference_dp(arch, tree, batches):
    """The reference's train_step jitted with in_shardings over a (2, 1)
    ("data", "model") mesh of 2 host devices, under
    enable_activation_sharding(batch_divisor=2), as dryrun.lower_cell
    builds it (params ``tree``, the port's too, and moments from
    param_specs, the batch's dim 0 over "data"): the three losses."""
    jcfg = _jcfg(arch)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    sizes = {"data": 2, "model": 1}
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jts.TrainState(params, jadamw.init(params), jax.random.PRNGKey(1), None)
    pspec = jshd.param_specs(params, axis_sizes=sizes)
    spec = jts.TrainState(pspec, type(state.opt)(step=P(), mu=pspec, nu=pspec), P(), None)
    state_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                            is_leaf=lambda s: isinstance(s, P))
    batch_sh = {k: NamedSharding(mesh, P(("data",), None)) for k in batches[0]}
    opt = jadamw.AdamWConfig(lr=R.LR, schedule=jwarmup_cosine(2, R.STEPS))
    jshd.enable_activation_sharding(multi_pod=False, batch_divisor=2, model_size=1)
    try:
        with jshd.use_mesh(mesh):
            step = jax.jit(lambda s, b: jts.train_step(s, b, jcfg, opt),
                           in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))
            losses = []
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
                losses.append(float(m["loss"]))
    finally:
        jshd.disable_activation_sharding()
    return losses


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_matches_reference_batch_sharded_step(trees, ranks, arch):
    # the reference first: the ranks run on meanwhile
    want = _reference_dp(arch, trees[arch], R.batches(256))
    dp2 = ranks.result(timeout=4 * SPAWN_TIMEOUT)[0]
    run = dp2["moe" if arch == "deepseek-v2-236b" else "per_tensor"]
    np.testing.assert_allclose(run["losses"][0], want[0], rtol=1e-5)
    np.testing.assert_allclose(run["losses"], want, rtol=1e-3)


# ---------------------------------------------------------------------------
# (b) the data-parallel step against the port's single device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,case", [(2, c) for c in CASES] + [(4, c) for c in CASES4])
def test_dp_step_matches_single_device(dp2, dp4, single, data, case):
    run, one = (dp2 if data == 2 else dp4)[case], single[(case, data)]
    moved = R.moved(one["codes"], run["codes"])
    n_codes = sum(c.size for c in one["codes"])
    print(f"{case} at data {data}: {moved} of {n_codes} per-tensor activation codes "
          f"moved in step 0's forward")
    if CASES[case][1] == "per_row":
        assert n_codes == 0 and not run["codes"]
    else:
        assert n_codes > 0 and [c.shape for c in run["codes"]] == [
            c.shape for c in one["codes"]]
    assert moved == 0
    np.testing.assert_allclose(run["loss0"], one["loss0"], rtol=1e-6)
    assert run["acc0"] == one["acc0"]
    assert run["grads0"].keys() == one["grads0"].keys()
    for k in one["grads0"]:
        np.testing.assert_allclose(run["grads0"][k], one["grads0"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=1e-6)
    for k in one["params"]:
        np.testing.assert_allclose(run["params"][k], one["params"][k], rtol=0,
                                   atol=R.LR / 10, err_msg=k)


def test_dp_collectives_a_step(dp2, dp4):
    """A smollm step (per-tensor) at data 2 and 4 runs the same
    all-reduces: two per dense layer (the threshold's sum and count,
    then the kept codes' sum and count; remat is off at smoke size), one
    gradient bucket, one for the loss and accuracy."""
    dense_layers = 7 * get_config("smollm-135m", smoke=True).n_layers
    want = {"all_reduce": 2 * dense_layers + 2}
    assert dp2["collectives"] == want and dp4["collectives"] == want


# ---------------------------------------------------------------------------
# (d) a batch that does not divide the data size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", [2, 4])
def test_indivisible_batch_is_replicated(trees, dp2, dp4, data):
    """3 rows at data 2, 6 at data 4: every rank runs the whole batch,
    with no collective: one device's step, bit for bit."""
    rows = 3 if data == 2 else 6
    assert not shd.batch_is_split(rows, M.TPMesh(None, 0, 1, data=data))
    run = (dp2 if data == 2 else dp4)["odd"]
    cfg = R.smoke_cfg("smollm-135m")
    one = R.train_record(R.state_from(trees["smollm-135m"], cfg), [_odd(rows)], cfg)
    assert run["loss0"] == one["loss0"] and run["losses"] == one["losses"]
    for k in one["params"]:
        np.testing.assert_array_equal(run["params"][k], one["params"][k], err_msg=k)


def test_batch_shard_rule():
    """A rank's block of B / D rows where D divides B (views), else the
    whole batch."""
    batch = {"tokens": torch.arange(8).reshape(4, 2), "labels": torch.arange(8).reshape(4, 2)}
    mesh = M.TPMesh(None, 0, 1, data=2, data_rank=1)
    part = shd.batch_shard(batch, mesh)
    assert torch.equal(part["tokens"], batch["tokens"][2:])
    assert part["tokens"].data_ptr() == batch["tokens"][2:].data_ptr()
    whole = shd.batch_shard(batch, M.TPMesh(None, 0, 1, data=3, data_rank=2))
    assert all(whole[k] is batch[k] for k in batch)
    assert shd.batch_shard(batch, None)["tokens"] is batch["tokens"]
    with pytest.raises(ValueError, match="batch dim"):
        shd.batch_shard({"a": torch.zeros(2), "b": torch.zeros(3)}, mesh)


# ---------------------------------------------------------------------------
# (e) elastic restore and failure under a mesh
# ---------------------------------------------------------------------------


def test_failure_replays_bit_equal_on_every_rank(dp2):
    """A failure at step 3 in every rank: each restores the checkpoint at
    2 and replays step 2 with its first pass's loss, accuracy and grad
    norm (every rank's log is checked equal in the ranks)."""
    run = dp2["trainer"]
    steps = [m[0] for m in run["log"]]
    assert run["restarts"] == 1 and steps == [0, 1, 2, 2, 3]
    assert run["log"][2] == run["log"][3]
    assert run["steps"] == ["LATEST", "step_00000002", "step_00000004"]
    assert run["opt_step"] == R.TRAINER_STEPS


def test_elastic_restore_data2_to_data1(dp2, ckpt_dirs):
    """The data-2 checkpoint at step 4 restores on one device bit for bit
    (params, Adam moments and step), and the Trainer steps on from it."""
    run = dp2["trainer"]
    trainer = R._trainer(None, str(ckpt_dirs[0] / "one"), R.TRAINER_STEPS + 1, "cpu")
    trainer.train_cfg.ckpt_dir = str(ckpt_dirs[0])
    assert trainer.restore(device="cpu") == R.TRAINER_STEPS
    for name in ("params", "mu", "nu"):
        got = R._flat(trainer.state.params if name == "params"
                      else getattr(trainer.state.opt, name))
        assert got.keys() == run[name].keys()
        for k in got:
            np.testing.assert_array_equal(got[k], run[name][k], err_msg=f"{name} {k}")
    assert int(trainer.state.opt.step) == run["opt_step"]
    trainer.train_cfg.ckpt_dir = None
    log = trainer.run()
    assert [m["step"] for m in log] == [R.TRAINER_STEPS] and np.isfinite(log[0]["loss"])


def test_elastic_restore_data2_to_data4(dp2, dp4):
    """Four ranks restore the data-2 checkpoint at construction, bit for
    bit, and take step 4 together (the state checked replicated)."""
    run, back = dp2["trainer"], dp4["restored"]
    assert back["start"] == R.TRAINER_STEPS and back["opt_step"] == run["opt_step"]
    for name in ("params", "mu", "nu"):
        for k in run[name]:
            np.testing.assert_array_equal(back[name][k], run[name][k], err_msg=f"{name} {k}")
    assert [m[0] for m in back["log"]] == [R.TRAINER_STEPS]
    assert np.isfinite(back["log"][0][1])


def test_restore_keeps_storage_and_takes_the_mesh(tmp_path):
    """restore(device=) onto the Trainer's own device copies into the
    state's storage; the mesh given to restore becomes the Trainer's,
    with the eager data-parallel step."""
    trainer = R._trainer(None, str(tmp_path), 2, "cpu")
    trainer.run()
    storage = trainer.state.params["embed"].data_ptr()
    assert trainer.restore(device="cpu") == 2
    assert trainer.state.params["embed"].data_ptr() == storage
    mesh = M.TPMesh(None, 0, 1, data=1)
    trainer.restore(mesh=mesh)
    assert trainer.mesh is mesh and trainer.step_fn.graphed is False


