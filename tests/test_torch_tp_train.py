"""Tensor-parallel training of the port (a model axis under ``train_step``
and a ``(data, model)`` grid: ``dist.sharding``'s training shards,
``dist.collectives``' copy / gather / reduce, ``layers.dense`` on a
``TrainShard``, AdamW's norm over the model group, compression on
shards, the Trainer's gathered checkpoints and elastic restore) against
the port on one device and against the JAX package's sharded jitted step, for all six families (encdec and
vlm with their frames or patches, ``torch_tp_train_ranks.add_inputs``).

The port's ranks are processes of a gloo group on the CPU, spawned once
per mesh for the whole module, (1, 2), (1, 4) and (2, 2), in a background
thread (``launch.mesh.spawn_mesh``, the rank functions in
``torch_tp_train_ranks.py``; each rank checks the replicated leaves and
their gradients bit-equal over its model group). Smoke size, f32. The
contract and its tolerances:

  * against the port's single device (dense, ssm, hybrid, moe with MLA,
    grok-1, encdec (whisper, with and without remat) and vlm (llava);
    (1, 2) splits smoke smollm's 4 heads and 2 kv heads, (1, 4) keeps its
    attention replicated while the MLP and the vocabulary split, as it
    keeps llava's (2 kv heads), and splits whisper's 4 heads, its
    encoder and cross attention with them; (2, 2) splits both axes, moe
    at the data size's routing groups): step 0's loss bit for bit under CiM (rtol 1e-6 in mode
    "off", and over a data axis, whose ranks' losses are averaged), its
    gradients at rtol 1e-5 / atol 1e-6, three losses at rtol
    1e-6 and every weight within lr/10 after them. The ssm and hybrid
    families' gradients are held normwise, each leaf's largest
    |difference| within 1e-5 of its largest |gradient|: the model group
    sums the partial gradients of the shared B and C (one group: every
    rank's heads read them) and of the replicated inputs in another
    order than one device's head sum, and an element where those f32
    sums cancel moves by a few 1e-6. encdec's gradients hold elementwise:
    the encoder output's partial gradients are summed once over the
    ranks, after every decoder layer's k/v added its part on each rank;
  * against the reference's ``jax.jit(train_step, in_shardings=...)``
    under ``param_specs`` with ``enable_activation_sharding(model_size=
    2)`` over (1, 2) and (2, 2) host meshes: step 0's loss at rtol 1e-5,
    three losses at rtol 1e-3;
  * negative controls: ``copy``'s backward as the identity (the ranks'
    partial gradients not summed) fails the gradient check, and so does
    the encoder output's one copy into the decoder's k/v made the
    identity (every encoder leaf's gradient);
  * a step's collectives are the same at tp 2 and tp 4, and the dry
    run's (``launch.dryrun``, meta device) are the real rank step's;
  * elastic restore: a checkpoint written at model 2 restores on one
    device bit for bit (smollm's, and whisper's, whose Trainer takes its
    frames through ``batch_transform`` and replays a failure), and one
    written on one device restores at (2, 2);
  * compression: int8 and bf16 on the shards equal the single device's
    bit for bit (smollm, whisper, llava); an int8-compressed step as the
    uncompressed one;
  * the step, the state and the jit step build for encdec and vlm under
    a model axis, the state holding the rank's shards.
"""
import concurrent.futures
import dataclasses
import importlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dp_ranks as DP
import torch_tp_train_ranks as R
from repro.dist import sharding as jshd
from repro.models.registry import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.optim.schedules import warmup_cosine as jwarmup_cosine
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw
from torch_threads import one_thread  # noqa: F401

jts = importlib.import_module("repro.train.train_step")
ts = importlib.import_module("repro_torch.train.train_step")

SPAWN_TIMEOUT = 240.0
ARCHS = ("smollm-135m", "mamba2-780m", "zamba2-2.7b", "deepseek-v2-236b", "grok-1-314b",
         "whisper-large-v3", "llava-next-34b")
# {case: (arch, act_scale, remat, mode, other config fields)}
CASES = {"dense": ("smollm-135m", "per_tensor", False, "cim", None),
         "per_row": ("smollm-135m", "per_row", False, "cim", None),
         "remat": ("smollm-135m", "per_tensor", True, "cim", None),
         "off": ("smollm-135m", "per_tensor", False, "off", None),
         # the vocabulary's column-parallel quantized dense, its output gathered
         "unembed": ("smollm-135m", "per_tensor", False, "cim", {"quantize_unembed": True}),
         "ssm": ("mamba2-780m", "per_tensor", False, "cim", None),
         "hybrid": ("zamba2-2.7b", "per_tensor", False, "cim", None),
         "mla": ("deepseek-v2-236b", "per_tensor", False, "cim", None),
         "grok": ("grok-1-314b", "per_tensor", False, "cim", None),
         "encdec": ("whisper-large-v3", "per_tensor", False, "cim", None),
         # the decoder under remat: the encoder output's one copy is each
         # checkpointed block's input
         "encdec_remat": ("whisper-large-v3", "per_tensor", True, "cim", None),
         "vlm": ("llava-next-34b", "per_tensor", False, "cim", None)}
# the cases each mesh runs: (1, 2) all; (1, 4) the dense family and llava
# with attention replicated, the hybrid and whisper with everything split;
# (2, 2) both axes, moe at two routing groups
MESHES = {(1, 2): tuple(CASES), (1, 4): ("dense", "hybrid", "encdec", "vlm"),
          (2, 2): ("dense", "mla", "encdec", "vlm")}
EXTRAS = {(1, 2): ("counts", "control", "control_enc", "compress", "compress_families",
                   "trainer", "trainer_encdec"),
          (1, 4): ("counts",), (2, 2): ("restore",)}
# the families whose gradients are held normwise (see the docstring)
NORMWISE = ("ssm", "hybrid")
# the reference's sharded step: (case, mesh)
# (in the order the rank groups finish)
REFERENCE = [("dense", (1, 2)), ("mla", (1, 2)), ("ssm", (1, 2)), ("encdec", (1, 2)),
             ("vlm", (1, 2)), ("dense", (2, 2)), ("encdec", (2, 2)), ("vlm", (2, 2))]


@pytest.fixture(scope="module")
def trees():
    """The port's seeded smoke params as numpy f32 (both packages read
    them: the trees have one layout)."""
    return {a: DP.numpy_tree(R.case_cfg(a)) for a in ARCHS}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {name: str(tmp_path_factory.mktemp(f"tp_{name}"))
            for name in ("trainer", "trainer_encdec", "one", "scratch")}


def _spawn(trees, dirs, data, model):
    restore = dirs["scratch"] + "/ckpt"
    if (data, model) == (2, 2):
        # the one-device checkpoint, and a copy of it that the (2, 2) group
        # restores (its Trainer writes there)
        R._trainer(None, dirs["one"], DP.TRAINER_STEPS).run()
        shutil.copytree(dirs["one"], restore)
    return M.spawn_mesh(R.tp_rank, data, model, trees,
                        {n: CASES[n] for n in MESHES[(data, model)]}, EXTRAS[(data, model)],
                        {"trainer": dirs["trainer"], "trainer_encdec": dirs["trainer_encdec"],
                         "restore": restore},
                        timeout=SPAWN_TIMEOUT, threads=1)


@pytest.fixture(scope="module", autouse=True)
def ranks(trees, dirs):
    """The three rank groups, one after another, spawned once for the
    module in a background thread from its start: {mesh: future}. The
    tests of JAX code before the first test that reads a group run
    meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield {mesh: pool.submit(_spawn, trees, dirs, *mesh) for mesh in MESHES}


@pytest.fixture(scope="module")
def runs(ranks):
    return {mesh: future.result(timeout=6 * SPAWN_TIMEOUT) for mesh, future in ranks.items()}


def _single(trees, name, data=1, compression=None):
    arch, *case = CASES[name]
    cfg = R.case_cfg(arch, *case)
    # the data size's routing groups, as the reference's dry-run enables them
    shd.enable_activation_sharding(batch_divisor=data)
    try:
        return R.tp_record(trees[arch], cfg, None, compression=compression)
    finally:
        shd.disable_activation_sharding()


@pytest.fixture(scope="module")
def single(trees):
    out = {}
    for (data, _), names in MESHES.items():
        for name in names:
            # only moe's routing groups depend on the data size
            d = data if CASES[name][0] in ("deepseek-v2-236b", "grok-1-314b") else 1
            if (name, d) not in out:
                out[(name, d)] = _single(trees, name, d)
    return out


def _grads_close(got, want, normwise):
    for k in want:
        if normwise:
            gap = np.abs(got[k] - want[k]).max()
            assert gap <= 1e-5 * np.abs(want[k]).max(), (k, gap)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# (a) against the reference's sharded jitted step
# ---------------------------------------------------------------------------


def _jcfg(arch, act_scale="per_tensor"):
    jcfg = jget_config(arch, smoke=True)
    return jcfg.replace(dtype="float32",
                        quant=dataclasses.replace(jcfg.quant, act_scale=act_scale))


def _reference_tp(arch, tree, batches, data, model):
    """The reference's train_step jitted with in_shardings over a (data,
    model) ("data", "model") mesh of host devices, under
    enable_activation_sharding(batch_divisor=data, model_size=model), as
    dryrun.lower_cell builds it (params ``tree``, the port's too, and
    moments from param_specs, the batch's dim 0 over "data"): the three
    losses."""
    jcfg = _jcfg(arch)
    mesh = Mesh(np.asarray(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    sizes = {"data": data, "model": model}
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jts.TrainState(params, jadamw.init(params), jax.random.PRNGKey(1), None)
    pspec = jshd.param_specs(params, axis_sizes=sizes)
    spec = jts.TrainState(pspec, type(state.opt)(step=P(), mu=pspec, nu=pspec), P(), None)
    state_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                            is_leaf=lambda s: isinstance(s, P))
    batch_sh = {k: NamedSharding(mesh, P(("data",), None)) for k in batches[0]}
    opt = jadamw.AdamWConfig(lr=DP.LR, schedule=jwarmup_cosine(2, DP.STEPS))
    jshd.enable_activation_sharding(multi_pod=False, batch_divisor=data, model_size=model)
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


@pytest.mark.parametrize("name,mesh", REFERENCE, ids=lambda v: (
    "x".join(map(str, v)) if isinstance(v, tuple) else v))
def test_tp_step_matches_reference_sharded_step(trees, ranks, name, mesh):
    arch = CASES[name][0]
    # the reference first: the ranks run on meanwhile
    want = _reference_tp(arch, trees[arch], R.case_batches(R.case_cfg(arch)), *mesh)
    run = ranks[mesh].result(timeout=6 * SPAWN_TIMEOUT)[name]
    np.testing.assert_allclose(run["losses"][0], want[0], rtol=1e-5)
    np.testing.assert_allclose(run["losses"], want, rtol=1e-3)


# ---------------------------------------------------------------------------
# (b) against the port's single device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,name", [(m, n) for m, names in MESHES.items() for n in names],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_tp_step_matches_single_device(runs, single, mesh, name):
    arch, _, _, mode, _ = CASES[name]
    d = mesh[0] if arch in ("deepseek-v2-236b", "grok-1-314b") else 1
    run, one = runs[mesh][name], single[(name, d)]
    if mode == "off" or mesh[0] > 1:
        # mode "off" sums float partials; a data axis averages its ranks'
        # losses
        np.testing.assert_allclose(run["loss0"], one["loss0"], rtol=1e-6)
    else:
        assert run["loss0"] == one["loss0"]
    assert run["grads0"].keys() == one["grads0"].keys()
    _grads_close(run["grads0"], one["grads0"], name in NORMWISE)
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(run["norms"], one["norms"], rtol=1e-5)
    for k in one["params"]:
        np.testing.assert_allclose(run["params"][k], one["params"][k], rtol=0,
                                   atol=DP.LR / 10, err_msg=k)


def test_negative_control_copy_backward_as_identity(runs, single):
    """Without the sum of the partial gradients at copy the gradient check
    fails: the inputs' partial gradients reach ln1, ln2 and the embedding
    as one rank's part."""
    bad = [k for k, want in single[("dense", 1)]["grads0"].items()
           if not np.allclose(runs[(1, 2)]["control"][k], want, rtol=1e-5, atol=1e-6)]
    assert "embed" in bad and "blocks/ln1" in bad and "blocks/ln2" in bad, bad


def test_negative_control_encoder_output_copy_as_identity(runs, single):
    """Without the one copy of the encoder output into the decoder's k/v
    (its backward the identity) every encoder leaf's gradient is one
    rank's part of the single device's, and the gradient check fails
    there; the decoder's leaves hold."""
    want = single[("encdec", 1)]["grads0"]
    bad = [k for k, w in want.items()
           if not np.allclose(runs[(1, 2)]["control_enc"][k], w, rtol=1e-5, atol=1e-6)]
    enc = [k for k in want if k.startswith("enc")]
    assert enc and set(bad) == set(enc), bad


def test_collectives_a_step_equal_at_tp2_and_tp4(runs):
    """zamba2 splits every head count at 2 and at 4 ranks, and so runs the
    same collectives: per layer the copies into w_in, q/k/v and gate/up,
    the gathers of the row-parallel inputs and K shards, the reductions
    of their partials; the embedding's reduction and the logits' gather;
    the norm's one all-reduce."""
    two, four = runs[(1, 2)]["counts"], runs[(1, 4)]["counts"]
    assert two["collectives"] == four["collectives"], (two, four)
    assert two["launches"] == four["launches"]
    c = two["collectives"]
    assert c["gather"] == c["all_gather"] and c["copy"] > 0 and c["reduce"] > 0


def test_dry_run_collectives_equal_the_rank_step(runs):
    """The dry run (``launch.dryrun.lower_cell`` on the meta device, rank
    0 of a (1, 2) grid that no process backs) calls the collectives of
    zamba2's real rank step, by name and count
    (``collectives.COUNTS`` of the (1, 2) group's one step)."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import ShapeCell

    cfg = R.case_cfg("zamba2-2.7b")
    rows, seq = R.case_batches(cfg, 1)[0]["tokens"].shape
    res = lower_cell(cfg, ShapeCell("counts", "train", seq, rows),
                     mesh=AbstractMesh((1, 2), ("data", "model")), verbose=False)
    assert res.ok, res.error
    assert res.op_cost["collective_counts"] == runs[(1, 2)]["counts"]["collectives"]


# ---------------------------------------------------------------------------
# (c) checkpoints: elastic restore over model sizes, failure replay
# ---------------------------------------------------------------------------


def test_failure_replays_on_every_rank(runs):
    """A failure at step 3 in both model ranks: each restores the gathered
    checkpoint at 2 and replays step 2 with its first pass's metrics."""
    run = runs[(1, 2)]["trainer"]
    assert run["restarts"] == 1 and [m[0] for m in run["log"]] == [0, 1, 2, 2, 3]
    assert run["log"][2] == run["log"][3]
    assert run["steps"] == ["LATEST", "step_00000002", "step_00000004"]
    assert run["opt_step"] == DP.TRAINER_STEPS


def test_elastic_restore_model2_to_one_device(runs, dirs):
    """The model-2 checkpoint (whole, gathered from the shards) at step 4
    restores on one device bit for bit, and the Trainer steps on."""
    run = runs[(1, 2)]["trainer"]
    trainer = R._trainer(None, None, DP.TRAINER_STEPS + 1)
    trainer.train_cfg.ckpt_dir = dirs["trainer"]
    assert trainer.restore(device="cpu") == DP.TRAINER_STEPS
    for name in ("params", "mu", "nu"):
        got = DP._flat(trainer.state.params if name == "params"
                       else getattr(trainer.state.opt, name))
        assert got.keys() == run[name].keys()
        for k in got:
            np.testing.assert_array_equal(got[k], run[name][k], err_msg=f"{name} {k}")
    assert int(trainer.state.opt.step) == run["opt_step"]
    trainer.train_cfg.ckpt_dir = None
    log = trainer.run()
    assert [m["step"] for m in log] == [DP.TRAINER_STEPS] and np.isfinite(log[0]["loss"])


def test_encdec_trainer_replays_a_failure_on_every_rank(runs):
    """whisper's Trainer over (1, 2), its frames made by
    ``batch_transform`` in every rank: a failure at step 3 restores the
    gathered checkpoint at 2 and replays step 2 with its first pass's
    metrics."""
    run = runs[(1, 2)]["trainer_encdec"]
    assert run["restarts"] == 1 and [m[0] for m in run["log"]] == [0, 1, 2, 2, 3]
    assert run["log"][2] == run["log"][3]
    assert run["steps"] == ["LATEST", "step_00000002", "step_00000004"]


def test_elastic_restore_encdec_model2_to_one_device(runs, dirs):
    """whisper's model-2 checkpoint at step 4 restores on one device bit
    for bit, and the single-device Trainer steps on."""
    run = runs[(1, 2)]["trainer_encdec"]
    trainer = R._trainer(None, None, DP.TRAINER_STEPS + 1, arch="whisper-large-v3")
    trainer.train_cfg.ckpt_dir = dirs["trainer_encdec"]
    assert trainer.restore(device="cpu") == DP.TRAINER_STEPS
    for name in ("params", "mu", "nu"):
        got = DP._flat(trainer.state.params if name == "params"
                       else getattr(trainer.state.opt, name))
        assert got.keys() == run[name].keys()
        for k in got:
            np.testing.assert_array_equal(got[k], run[name][k], err_msg=f"{name} {k}")
    assert int(trainer.state.opt.step) == run["opt_step"]
    trainer.train_cfg.ckpt_dir = None
    log = trainer.run()
    assert [m["step"] for m in log] == [DP.TRAINER_STEPS] and np.isfinite(log[0]["loss"])


def test_elastic_restore_one_device_to_2x2(runs, dirs):
    """Four ranks of a (2, 2) grid restore a one-device checkpoint at
    construction, each its shards, bit for bit (gathered whole), and take
    step 4 together."""
    trainer = R._trainer(None, None, DP.TRAINER_STEPS)
    trainer.train_cfg.ckpt_dir = dirs["one"]
    trainer.restore(device="cpu")
    back = runs[(2, 2)]["restored"]
    assert back["start"] == DP.TRAINER_STEPS and back["opt_step"] == DP.TRAINER_STEPS
    for name in ("params", "mu", "nu"):
        want = DP._flat(trainer.state.params if name == "params"
                        else getattr(trainer.state.opt, name))
        for k in want:
            np.testing.assert_array_equal(back[name][k], want[k], err_msg=f"{name} {k}")
    assert [m[0] for m in back["log"]] == [DP.TRAINER_STEPS] and np.isfinite(back["log"][0][1])


# ---------------------------------------------------------------------------
# (d) compression, the families that raise, the layout's round trip
# ---------------------------------------------------------------------------


def test_compression_on_shards_equals_single_device(runs, trees):
    """int8 (the whole leaf's amax, the whole leaf's noise cut as the
    shard) and bf16 on the shards == one device's on the whole gradients,
    bit for bit (values and residuals); and an int8-compressed step on
    (1, 2) as one device's: losses at rtol 1e-6, weights within lr/10."""
    assert runs[(1, 2)]["compress"] == {"int8": 0.0, "bf16": 0.0}
    run = runs[(1, 2)]["int8"]
    one = R.tp_record(trees["smollm-135m"], R.case_cfg("smollm-135m"), None,
                      compression="int8")
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=1e-6)
    for k in one["params"]:
        np.testing.assert_allclose(run["params"][k], one["params"][k], rtol=0,
                                   atol=DP.LR / 10, err_msg=k)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_compression_on_encdec_and_vlm_shards_equals_single_device(runs, arch):
    """int8 and bf16 on whisper's encoder and cross-attention shards and
    llava's projector shards == one device's on the whole gradients, bit
    for bit (values and residuals)."""
    assert runs[(1, 2)]["compress_families"][arch] == {"int8": 0.0, "bf16": 0.0}


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_encdec_and_vlm_build_under_a_model_axis(arch):
    """encdec and vlm take a model axis: the state is the rank's shards
    of the seeded one (whisper's encoder and cross attention, llava's
    projector cut on their columns or rows, the encoder's norms and
    positions whole), and the jit step is eager under it."""
    cfg = DP.smoke_cfg(arch)
    opt = adamw.AdamWConfig(lr=DP.LR)
    tp = M.TPMesh(None, 1, 2, (0, 1))
    state = ts.init_train_state(cfg, device="cpu", mesh=tp)
    whole = ts.init_train_state(cfg, device="cpu")
    layout = shd.train_layout(cfg, tp)
    assert ts.make_jit_train_step(cfg, opt, mesh=tp).graphed is False
    got, want, splits = (dict(DP._paths(t)) for t in (state.params, whole.params, layout))
    assert got.keys() == want.keys()
    for k, sp in splits.items():
        assert torch.equal(got[k], want[k] if sp is None else sp.cut(want[k])), k
    d = cfg.d_model
    if arch == "whisper-large-v3":
        assert got["enc_blocks/attn/wq"].shape == (cfg.n_encoder_layers, d, d // 2)
        assert got["enc_blocks/attn/wo"].shape == (cfg.n_encoder_layers, d // 2, d)
        assert got["blocks/cross/wk"].shape == (cfg.n_layers, d, d // 2)
        assert all(splits[k] is None for k in ("enc_pos", "enc_norm", "blocks/ln_x"))
    else:
        assert got["projector"].shape == (cfg.d_vision, d // 2)


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m", "zamba2-2.7b",
                                  "deepseek-v2-236b", "grok-1-314b", "whisper-large-v3",
                                  "llava-next-34b"])
def test_layout_cuts_and_joins_exactly(arch, tp):
    """Every leaf's shards (one per rank, cut from the whole) join back to
    the whole bit for bit; row splits on whole 16-row blocks of K padded
    to 16·tp; mamba's B and C shared by every rank of one group; a
    replicated leaf is None."""
    cfg = R.case_cfg(arch)
    whole = T.init_params(cfg, seed=0, device="cpu")
    layouts = [shd.train_layout(cfg, M.TPMesh(None, r, tp, tuple(range(tp))))
               for r in range(tp)]
    for path, leaf in DP._paths(whole):
        splits = [dict(DP._paths(lay))[path] for lay in layouts]
        if splits[0] is None:
            continue
        parts = [sp.cut(leaf, r) for r, sp in enumerate(splits)]
        assert all(tuple(p.shape) == tuple(parts[0].shape) for p in parts), path
        assert torch.equal(splits[0].join(parts), leaf), path
        if splits[0].view == "row":
            assert splits[0].padded % (cfg.quant.block * tp) == 0, path
        if "mamba" in path and path.endswith(("w_in", "conv_w", "conv_b")):
            shared = splits[0].shared
            assert shared is not None and len(shared) == 2 * cfg.ssm_state, path
            for sp, part in zip(splits, parts):
                assert torch.equal(part.index_select(sp.dim, sp.shared),
                                   parts[0].index_select(sp.dim, shared)), path


@pytest.mark.parametrize("arch,tp", [("whisper-large-v3", tp) for tp in (2, 3, 4, 5, 8)]
                         + [("llava-next-34b", tp) for tp in (2, 3, 4, 7, 8)])
def test_full_config_splits_on_whole_heads(arch, tp):
    """At the full configs (shapes from the meta device), the encoder's
    and the cross attention's q/k/v/o split exactly where the decoder's
    attention does, on whole heads (whisper's 20 at tp 2, 4 and 5;
    llava's 56 heads and 8 kv heads at 2, 4 and 8), with the rank's heads
    in ``local_config``; else they stay replicated while the MLP, the
    vocabulary and llava's projector split where their widths divide
    (whisper's vocabulary of 51866 at tp 2 alone)."""
    cfg = get_config(arch)
    mesh = M.TPMesh(None, 0, tp, tuple(range(tp)))
    splits = dict(DP._paths(shd.train_layout(cfg, mesh)))
    heads = cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    attn = [k for k in splits if k.split("/")[-1] in ("wq", "wk", "wv", "wo")]
    assert attn and all((splits[k] is not None) == heads for k in attn), (heads, attn)
    local = shd.local_config(cfg, mesh)
    assert local.n_heads == (cfg.n_heads // tp if heads else cfg.n_heads)
    assert (splits["embed"] is not None) == (cfg.vocab % tp == 0)
    assert (splits["blocks/mlp/w_up"] is not None) == (cfg.d_ff % tp == 0)
    if arch == "whisper-large-v3":
        assert all(splits[k] is None for k in ("enc_pos", "enc_norm", "blocks/ln_x"))
        assert (splits["enc_blocks/mlp/w_gate"] is not None) == (cfg.d_ff % tp == 0)
    else:
        assert (splits["projector"] is not None) == (cfg.d_model % tp == 0)
