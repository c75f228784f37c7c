"""Training against the JAX package: the STE wrappers, the gradients of
``dense`` under every mode and spec, ``loss_fn`` and its gradients, and
three ``train_step``s at smollm-135m smoke size (f32), on the same seeded
numpy inputs and bridged params; remat on == remat off. The other
families: test_torch_train_families.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as jtern
from repro.core.execution import CiMExecSpec as JSpec
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.optim.schedules import warmup_cosine as jwarmup_cosine
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import bare_train_step as jbare_train_step
from repro.train.train_step import loss_fn as jloss_fn
from repro.train.train_step import make_jit_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.core import execution
from repro_torch.core import ternary as tern
from repro_torch.core.execution import CiMExecSpec
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.train_step import TrainState, bare_train_step, loss_fn, make_train_step
from repro_torch.train.train_step import make_jit_train_step as make_captured_step
from torch_threads import one_thread  # noqa: F401

STEPS = 3
SEQ, BATCH = 32, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of JAX or torch leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().numpy() if torch.is_tensor(v)
                               else np.asarray(v, np.float32))
    return out


# ---------------------------------------------------------------------------
# STE wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scaled", [True, False], ids=["ste_ternarize", "ste_unit_ternarize"])
def test_ste_ternarize_matches_jax(scaled):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 40)) * 0.8).astype(np.float32)
    g = rng.standard_normal((6, 40)).astype(np.float32)
    jfn = jtern.ste_ternarize if scaled else jtern.ste_unit_ternarize
    tfn = tern.ste_ternarize if scaled else tern.ste_unit_ternarize
    want = np.asarray(jfn(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a) * g))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = tfn(xt)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)
    # the clipped STE: no gradient where |x| > 1, g where |x| <= 1
    assert ((np.abs(x) > 1) == (xt.grad.numpy() == 0)).all()


# ---------------------------------------------------------------------------
# dense: gradients for x and w
# ---------------------------------------------------------------------------

_SPEC_CASES = {
    # id: (QuantConfig kwargs, the reference's exec spec, the port's)
    "off": (dict(mode="off"), None, None),
    "ternary": (dict(mode="ternary"), None, None),
    "cim": (dict(mode="cim"), None, None),
    "cim_fused": (dict(mode="cim_fused"), None, None),
    "corrected": (dict(mode="cim", corrected=True), None, None),
    "bitplane": (dict(mode="cim"), "bitplane/jnp/none", "bitplane/torch/none"),
    "exact": (dict(mode="cim"), "exact/jnp/none", "exact/torch/none"),
    # the kernel specs of the card: on CPU tensors their wrappers run the
    # plain versions, under the same STE Function
    "blocked_cuda": (dict(mode="cim"), "blocked/jnp/none", "blocked/cuda/none"),
    "exact_cuda": (dict(mode="cim"), "exact/jnp/none", "exact/cuda/none"),
    "packed": (dict(mode="cim"), "blocked/jnp/bitplane_u8", "blocked/torch/bitplane_u8"),
    "per_row": (dict(mode="cim", act_scale="per_row"), None, None),
    "per_row_ternary": (dict(mode="ternary", act_scale="per_row"), None, None),
    "pre_quantized": (dict(mode="cim", pre_quantized=True), None, None),
}


def _spec(name, cls):
    if name is None:
        return None
    f, b, p = name.split("/")
    return cls(formulation=f, backend=b, packing=p)


@pytest.mark.parametrize("case", list(_SPEC_CASES))
def test_dense_grads_match_jax(case):
    kw, jspec, tspec = _SPEC_CASES[case]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 24)) * 0.3).astype(np.float32)
    if kw.get("pre_quantized"):
        # folded offline: {-s_n, 0, +s_n} per output channel
        t, s = jtern.ternarize(jnp.asarray(w), axis=(0,))
        w = np.asarray(t * s, np.float32)
    g = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jqc = jL.QuantConfig(**kw, exec_spec=_spec(jspec, JSpec))
    tqc = tL.QuantConfig(**kw, exec_spec=_spec(tspec, CiMExecSpec))

    def jloss(a, b):
        return jnp.sum(jL.dense(a, b, jqc) * g)

    want_out = np.asarray(jL.dense(jnp.asarray(x), jnp.asarray(w), jqc))
    want_dx, want_dw = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tL.dense(xt, wt, tqc)
    (out * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **tol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw), **tol)


def test_dense_without_grad_is_todays_call(monkeypatch):
    """No operand needs a gradient (serving): the MAC is called directly,
    not through the STE Function, and the result equals the grad path's."""
    calls = []
    monkeypatch.setattr(execution._SteExecute, "apply",
                        lambda *a: calls.append(1) or execution._forward(*a))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    qc = tL.QuantConfig(mode="cim")
    plain = tL.dense(x, w, qc)
    assert not calls and not plain.requires_grad
    with torch.no_grad():
        tL.dense(x, w.requires_grad_(), qc)
    assert not calls
    graded = tL.dense(x, w, qc)
    assert calls and torch.equal(graded.detach(), plain)


# ---------------------------------------------------------------------------
# loss_fn and train_step at smollm-135m smoke size, f32
# ---------------------------------------------------------------------------


def _cfgs(mode, remat=False):
    jcfg = jget_config("smollm-135m", smoke=True)
    jcfg = jcfg.replace(dtype="float32", quant=dataclasses.replace(jcfg.quant, mode=mode))
    tcfg = get_config("smollm-135m", smoke=True)
    tcfg = tcfg.replace(dtype="float32", remat=remat,
                        quant=dataclasses.replace(tcfg.quant, mode=mode))
    return jcfg, tcfg


def _batches(vocab):
    jpipe = JPipeline(JDataConfig(vocab=vocab, seq_len=SEQ, global_batch=BATCH))
    tpipe = TokenPipeline(DataConfig(vocab=vocab, seq_len=SEQ, global_batch=BATCH))
    out = []
    for step in range(STEPS):
        jb, tb = jpipe.batch(step), tpipe.batch(step)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        out.append((jb, {k: torch.from_numpy(v) for k, v in tb.items()}))
    return out


@pytest.fixture(scope="module")
def reference_runs():
    """Per mode: the reference's loss and gradients on batch 0 and its
    three jitted train steps, and the bridged initial params. Compiled
    once for the module."""
    runs = {}
    for mode in ("off", "cim"):
        jcfg, tcfg = _cfgs(mode)
        jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = params_from_numpy(_np_tree(jparams), tcfg, device="cpu")
        batches = _batches(jcfg.vocab)
        jb0 = {k: jnp.asarray(v) for k, v in batches[0][0].items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True),
                                   static_argnums=2)(jparams, jb0, jcfg)
        opt = jadamw.AdamWConfig(lr=1e-3, schedule=jwarmup_cosine(2, STEPS))
        step_fn = make_jit_train_step(jcfg, opt, donate=False)
        state = JTrainState(jparams, jadamw.init(jparams), jax.random.PRNGKey(1), None)
        losses = []
        for jb, _ in batches:
            state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in jb.items()})
            losses.append(float(metrics["loss"]))
        runs[mode] = dict(tparams=tparams, batches=batches, loss=float(loss),
                          grads=_flat(grads), losses=losses,
                          params=_flat(state.params))
    return runs


def _port_grads(params, batch, cfg):
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, list(tree_leaves(params)))
    # tree_map rebuilds the dicts in sorted-key order, tree_leaves' order
    return float(loss.detach()), dict(zip(_flat(params), (g.numpy() for g in grads)))


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_loss_fn_and_grads_match_jax(reference_runs, mode):
    """Mode "off": loss and gradients at rtol 1e-5. CiM: the loss at rtol
    1e-5, the gradients at rtol 1e-4 (atol 1e-6): the clamped MAC's
    STE backward is the same product, but the 0.7·mean|x| threshold's
    last-ulp difference between the frameworks (ROADMAP Queue C item 3)
    may move an activation code; none moves at this seed."""
    run = reference_runs[mode]
    _, tcfg = _cfgs(mode)
    loss, grads = _port_grads(run["tparams"], run["batches"][0][1], tcfg)
    np.testing.assert_allclose(loss, run["loss"], rtol=1e-5)
    assert grads.keys() == run["grads"].keys()
    tol = dict(rtol=1e-5, atol=1e-6) if mode == "off" else dict(rtol=1e-4, atol=1e-6)
    for k in grads:
        np.testing.assert_allclose(grads[k], run["grads"][k], err_msg=k, **tol)


def _port_train(run, tcfg, steps=STEPS, make_step=make_train_step):
    params = tree_map(torch.clone, run["tparams"])
    state = TrainState(params, adamw.init(params), torch.Generator().manual_seed(1), None)
    step_fn = make_step(tcfg, adamw.AdamWConfig(
        lr=1e-3, schedule=warmup_cosine(2, STEPS)))
    losses, norms = [], []
    for _, tb in run["batches"][:steps]:
        state, metrics = step_fn(state, tb)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return state, losses, norms


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_train_steps_match_jax(reference_runs, mode):
    """Three steps on the same pipeline batches. Mode "off": every loss
    and the params after at rtol 1e-5, with atol 1e-5 = 1% of lr, and
    their mean difference under 1e-8: Adam's step lr·m/√v does not scale
    with the gradient, so where a gradient nearly cancels across steps
    the two frameworks' sum orders move one weight's update by up to ~1%
    of lr (one of 90,432 weights, at this seed). CiM: the losses at rtol
    1e-3 (an update that moves a weight across the TWN threshold flips
    its code)."""
    run = reference_runs[mode]
    _, tcfg = _cfgs(mode)
    state, losses, norms = _port_train(run, tcfg)
    assert all(np.isfinite(norms))
    if mode == "off":
        np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
        params = _flat(state.params)
        for k in params:
            np.testing.assert_allclose(params[k], run["params"][k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            assert np.abs(params[k] - run["params"][k]).mean() < 1e-8, k
    else:
        np.testing.assert_allclose(losses, run["losses"], rtol=1e-3)
    assert int(state.opt.step) == STEPS


def test_bare_train_step_matches_jax(reference_runs):
    """``bare_train_step``, the reference's single-argument form (no
    compression, no mesh), one step in mode "off" against the
    reference's ``bare_train_step`` jitted on the same params and batch:
    the loss at rtol 1e-5, the params after at test_train_steps_match_jax's
    "off" bound (rtol 1e-5, atol 1e-5)."""
    run = reference_runs["off"]
    jcfg, tcfg = _cfgs("off")
    jb, tb = run["batches"][0]
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), run["tparams"])
    jopt = jadamw.AdamWConfig(lr=1e-3, schedule=jwarmup_cosine(2, STEPS))
    jstate = JTrainState(jparams, jadamw.init(jparams), jax.random.PRNGKey(1), None)
    jstate, jmetrics = jax.jit(lambda st, b: jbare_train_step(st, b, jcfg, jopt))(
        jstate, {k: jnp.asarray(v) for k, v in jb.items()})
    params = tree_map(torch.clone, run["tparams"])
    state = TrainState(params, adamw.init(params), torch.Generator().manual_seed(1), None)
    state, metrics = bare_train_step(state, tb, tcfg, adamw.AdamWConfig(
        lr=1e-3, schedule=warmup_cosine(2, STEPS)))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    got, want = _flat(state.params), _flat(jstate.params)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert int(state.opt.step) == 1


def test_jit_train_steps_match_jax(reference_runs):
    """Two steps of make_jit_train_step (in place; eager on the CPU)
    under "cim" against the reference's jitted steps, at
    test_train_steps_match_jax's CiM bound (losses at rtol 1e-3), and
    bit-equal to make_train_step's."""
    run = reference_runs["cim"]
    _, tcfg = _cfgs("cim")
    state, losses, norms = _port_train(run, tcfg, steps=2, make_step=make_captured_step)
    np.testing.assert_allclose(losses, run["losses"][:2], rtol=1e-3)
    _, want_losses, want_norms = _port_train(run, tcfg, steps=2)
    assert (losses, norms) == (want_losses, want_norms)
    assert int(state.opt.step) == 2


def test_remat_equals_no_remat_bit_for_bit(reference_runs, monkeypatch):
    """cfg.remat checkpoints each layer: the same losses, gradients and
    params bit for bit on the CPU, with every MAC of the step run twice
    (the forward, then the recompute in the backward)."""
    calls = []
    forward = execution._forward
    monkeypatch.setattr(execution, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    run = reference_runs["cim"]
    results = {}
    for remat in (False, True):
        calls.clear()
        _, tcfg = _cfgs("cim", remat=remat)
        results[remat] = _port_train(run, tcfg, steps=2)
        results[remat] += (len(calls),)
    per_step = 7 * get_config("smollm-135m", smoke=True).n_layers
    assert results[False][3] == 2 * per_step
    assert results[True][3] == 2 * 2 * per_step
    assert results[False][1] == results[True][1]
    assert results[False][2] == results[True][2]
    a, b = _flat(results[False][0].params), _flat(results[True][0].params)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_forward_without_grad_ignores_remat():
    """Serving's forward (no grad) runs no checkpoint: the same logits
    with remat on and off, and no autograd graph."""
    cfg = get_config("smollm-135m", smoke=True).replace(dtype="float32")
    params = tT.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = tT.forward(params, tokens, cfg.replace(remat=True))
        b = tT.forward(params, tokens, cfg.replace(remat=False))
    assert not a.requires_grad and torch.equal(a, b)
