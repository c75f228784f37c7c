"""Training of the five families beyond dense against the JAX package:
mamba2-780m (ssm), zamba2-2.7b (hybrid), deepseek-v2-236b (moe with
MLA), grok-1-314b (moe with GQA), whisper-large-v3 (encdec, with frames)
and llava-next-34b (vlm, with patches), at smoke size in f32 on the same
seeded inputs and bridged params: ``loss_fn`` and every gradient against
``jax.value_and_grad``, three ``train_step``s against
``make_jit_train_step``, remat on == off bit for bit; and the pieces the
families train through: ``ssm.softplus``'s gradient, ``moe._tern3``'s
STE, ``router_aux_loss`` and ``_expert_matmul`` without grad.

Tolerances. The loss at rtol 1e-5. Every gradient leaf at rtol 1e-5
under mode "off" and 1e-4 under "cim" (the dense tolerances of
test_torch_train_step.py), each element's error bounded by atol =
max(1e-6, 1e-5 · the leaf's largest |grad|) + rtol · |its grad| in both
modes: the two frameworks sum in another order in f32 (the embedding's
scatter, the SSM's decay sums), which leaves an error proportional to
the leaf's scale, not to each element's. At seed 0 the largest
|Δgrad| of a leaf is 6.6e-6 of its largest |grad| under "off"
(zamba2's A_log) and 4.9e-6 under "cim" (whisper's encoder w_gate);
the error beyond rtol · |grad| is at most 2.9e-6 of the leaf's largest
|grad| (zamba2's A_log under "off"; 6.6e-7 under "cim") and 5.9e-6
absolute (zamba2's embedding under "cim", whose largest |grad| is 23.2;
3.0e-6 under "off"), so a flat atol of 1e-6 fails the embedding. The
moe configs run at ``moe_capacity_factor`` 8.0, where nothing drops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.optim.schedules import warmup_cosine as jwarmup_cosine
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import loss_fn as jloss_fn
from repro.train.train_step import make_jit_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.core import execution
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers as tL
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.train_step import TrainState, loss_fn, make_train_step
from torch_threads import one_thread  # noqa: F401

ARCHS = ("mamba2-780m", "zamba2-2.7b", "deepseek-v2-236b", "grok-1-314b",
         "whisper-large-v3", "llava-next-34b")
STEPS, SEQ, BATCH = 3, 16, 2
LR = 1e-3
RTOL = {"off": 1e-5, "cim": 1e-4}


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


def _cfgs(arch, mode, remat=False, n_layers=None):
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    fields = dict(dtype="float32")
    if n_layers:
        fields["n_layers"] = n_layers
    if jcfg.family == "moe":
        fields["moe_capacity_factor"] = 8.0
    jcfg = jcfg.replace(**fields, quant=dataclasses.replace(jcfg.quant, mode=mode))
    tcfg = tcfg.replace(**fields, remat=remat,
                        quant=dataclasses.replace(tcfg.quant, mode=mode))
    return jcfg, tcfg


def _batches(cfg):
    """STEPS pipeline batches (the two packages' arrays equal), with
    seeded frames (encdec) or patches (vlm): (reference batch, port batch)."""
    jpipe = JPipeline(JDataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
    tpipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
    rng = np.random.default_rng(7)
    out = []
    for step in range(STEPS):
        jb, tb = jpipe.batch(step), tpipe.batch(step)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        if cfg.family == "encdec":
            tb["frames"] = rng.standard_normal(
                (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            tb["patches"] = rng.standard_normal(
                (BATCH, cfg.n_image_tokens, cfg.d_vision)).astype(np.float32)
        out.append(({k: jnp.asarray(v) for k, v in tb.items()},
                    {k: torch.from_numpy(v) for k, v in tb.items()}))
    return out


@pytest.fixture(scope="module")
def reference():
    """``reference(arch, mode, n_layers=None)``: the reference's loss and
    gradients on batch 0 and, under "off" at the smoke depth, its three
    jitted train steps; the bridged initial params. Compiled once per
    (arch, mode, n_layers) for the module."""
    runs = {}
    return lambda arch, mode, n_layers=None: runs.get(
        (arch, mode, n_layers)) or runs.setdefault(
        (arch, mode, n_layers), _reference_run(arch, mode, n_layers))


def _reference_run(arch, mode, n_layers=None):
    jcfg, tcfg = _cfgs(arch, mode, n_layers=n_layers)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    run = dict(tparams=params_from_numpy(tree, tcfg, device="cpu"),
               batches=_batches(jcfg))
    (loss, _), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True),
                               static_argnums=2)(jparams, run["batches"][0][0], jcfg)
    run.update(loss=float(loss), grads=_flat(grads))
    if mode == "off" and n_layers is None:
        step_fn = make_jit_train_step(jcfg, _jopt(), donate=False)
        state = JTrainState(jparams, jadamw.init(jparams), jax.random.PRNGKey(1), None)
        losses = []
        for jb, _ in run["batches"]:
            state, metrics = step_fn(state, jb)
            losses.append(float(metrics["loss"]))
        run.update(losses=losses, params=_flat(state.params))
    return run


def _jopt():
    return jadamw.AdamWConfig(lr=LR, schedule=jwarmup_cosine(2, STEPS))


def _port_train(run, tcfg, steps=STEPS):
    state = TrainState(run["tparams"], adamw.init(run["tparams"]),
                       torch.Generator().manual_seed(1), None)
    step_fn = make_train_step(tcfg, adamw.AdamWConfig(
        lr=LR, schedule=warmup_cosine(2, STEPS)))
    losses, norms = [], []
    for _, tb in run["batches"][:steps]:
        state, metrics = step_fn(state, tb)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return state, losses, norms


# ---------------------------------------------------------------------------
# loss_fn and its gradients, three train steps, remat
# ---------------------------------------------------------------------------


def _assert_grads_match(run, tcfg, mode):
    """The port's loss and every gradient leaf on batch 0 against the
    reference's run; returns the port's gradients."""
    params = tree_map(lambda p: p.detach().requires_grad_(), run["tparams"])
    loss, _ = loss_fn(params, run["batches"][0][1], tcfg)
    found = torch.autograd.grad(loss, list(tree_leaves(params)))
    # tree_map rebuilds the dicts in sorted-key order, tree_leaves' order
    grads = dict(zip(_flat(params), (g.numpy() for g in found)))
    np.testing.assert_allclose(float(loss.detach()), run["loss"], rtol=1e-5)
    assert grads.keys() == run["grads"].keys()
    rtol = RTOL[mode]
    for k, got in grads.items():
        want = run["grads"][k]
        atol = max(1e-6, 1e-5 * float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=k)
    return grads


@pytest.mark.parametrize("mode", ["off", "cim"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(reference, arch, mode):
    _, tcfg = _cfgs(arch, mode)
    _assert_grads_match(reference(arch, mode), tcfg, mode)


def _global_norm(grads):
    return float(np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                             for g in grads.values())))


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_full_depth_mamba2_grads_match_jax(reference, mode):
    """mamba2-780m at its full depth of 48 layers and the smoke widths
    (d 64): the loss, every gradient and the global grad norm against
    the reference. Under "cim" the gradients grow with depth in both
    packages: at seed 0 the reference's global grad norm is 95.72 under
    "off" and 2.2561e6 under "cim" (17.51 and 66.21 at the smoke depth
    of 2), the port's within 1.2e-6 of it, relative."""
    _, tcfg = _cfgs("mamba2-780m", mode, n_layers=48)
    run = reference("mamba2-780m", mode, 48)
    grads = _assert_grads_match(run, tcfg, mode)
    np.testing.assert_allclose(_global_norm(grads), _global_norm(run["grads"]),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(reference, arch):
    """Three steps under mode "off" on the same batches: the losses at
    rtol 1e-5, the params after at rtol 1e-5 with atol lr/10 (Adam's
    step lr·m/√v does not scale with the gradient, so a gradient that
    nearly cancels moves a weight's update by a fraction of lr under
    either framework's sum order)."""
    run = reference(arch, "off")
    _, tcfg = _cfgs(arch, "off")
    state, losses, norms = _port_train(run, tcfg)
    assert all(np.isfinite(norms)) and int(state.opt.step) == STEPS
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    params = _flat(state.params)
    assert params.keys() == run["params"].keys()
    for k in params:
        np.testing.assert_allclose(params[k], run["params"][k], rtol=1e-5,
                                   atol=LR / 10, err_msg=k)


def _macs_per_step(cfg):
    """Quantized dense layers a forward runs, and how many of them sit
    under remat's checkpoint (the decoder or mamba layers; not whisper's
    encoder, zamba2's shared block or llava's projector)."""
    per_layer = {"ssm": 2, "hybrid": 2, "dense": 7, "encdec": 11, "vlm": 7,
                 "moe": (3 if cfg.mla else 4) + (3 if cfg.n_shared_experts else 0)}
    remat = per_layer[cfg.family] * cfg.n_layers
    other = {"hybrid": 7 * (cfg.n_layers // max(cfg.hybrid_attn_every, 1)),
             "encdec": 7 * cfg.n_encoder_layers, "vlm": 1}.get(cfg.family, 0)
    return remat + other, remat


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bit_for_bit(reference, arch, monkeypatch):
    """Under "cim", two steps with cfg.remat on and off: the same losses,
    grad norms and params bit for bit, and every MAC under remat run
    twice (the forward, then the recompute in the backward)."""
    calls = []
    forward = execution._forward
    monkeypatch.setattr(execution, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    run = reference(arch, "cim")
    results = {}
    for remat in (False, True):
        calls.clear()
        _, tcfg = _cfgs(arch, "cim", remat=remat)
        results[remat] = _port_train(run, tcfg, steps=2) + (len(calls),)
    total, under_remat = _macs_per_step(tcfg)
    assert results[False][3] == 2 * total
    assert results[True][3] == 2 * (total + under_remat)
    assert results[False][1] == results[True][1]
    assert results[False][2] == results[True][2]
    a, b = _flat(results[False][0].params), _flat(results[True][0].params)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the pieces: softplus, the expert STE, the aux loss, the expert products
# ---------------------------------------------------------------------------


def test_softplus_gradient_matches_jax():
    """The reference's gradient, exp(x - softplus(x)) = sigmoid(x): 0.5 at
    x == 0 (autograd through clamp(x, min=0) gives 1.0), and the same
    value, with grad or without."""
    x = np.array([0.0, 1e-3, -1e-3, 2.0, -30.0, 30.0], np.float32)
    want = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = tssm.softplus(xt)
    y.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=0)
    assert xt.grad[0] == 0.5
    # the value within one f32 ulp of XLA's log1p(exp(.))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=2e-7, atol=0)
    plain = tssm.softplus(torch.from_numpy(x))
    want_value = torch.clamp(torch.from_numpy(x), min=0) + torch.log1p(
        torch.exp(-torch.from_numpy(x).abs()))
    assert plain.grad_fn is None and torch.equal(plain, y.detach())
    assert torch.equal(plain, want_value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tern3_value_and_gradient_match_jax(dtype):
    """The value-exact STE: the value under grad the no-grad value's bit
    for bit; value and gradient (g · scale per (expert, out-channel))
    the reference's in bf16, within f32's last-ulp sum order of the
    scale in f32 (rtol 1e-6, as test_torch_moe.py's)."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((4, 24, 8)) * 0.2).astype(np.float32)
    g = rng.standard_normal((4, 24, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jw = jnp.asarray(w).astype(jdt)
    want = np.asarray(jmoe._tern3(jw), np.float32)
    want_grad = np.asarray(jax.grad(lambda a: jnp.sum(
        jmoe._tern3(a).astype(jnp.float32) * g))(jw), np.float32)
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    got = tmoe._tern3(wt)
    (got.float() * torch.from_numpy(g)).sum().backward()
    assert torch.equal(got.detach(), tmoe._tern3(wt.detach()))
    rtol = 1e-6 if dtype == "float32" else 0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol, atol=0)
    np.testing.assert_allclose(wt.grad.float().numpy(), want_grad, rtol=rtol, atol=0)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_router_aux_loss_matches_jax(arch):
    """Value and gradients (router and x) at f32 rtol 1e-5, atol 1e-7."""
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    (want, (want_dr, want_dx)) = jax.value_and_grad(
        lambda r, a: jmoe.router_aux_loss({"router": r}, a, jcfg), (0, 1))(
            jparams["router"], jnp.asarray(x))
    router = torch.tensor(np.asarray(jparams["router"]), requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    got = tmoe.router_aux_loss({"router": router}, xt, tcfg)
    got.backward()
    tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got), float(want), **tol)
    np.testing.assert_allclose(router.grad.numpy(), np.asarray(want_dr), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **tol)


def _expert_matmul_in_place(x, w, qc):
    """``_expert_matmul`` before training: |w64| in place."""
    e, k, n = w.shape
    step = max(1, tmoe.CHUNK_BYTES // (8 * k * n))
    out = torch.empty((e, x.shape[1], n), dtype=x.dtype, device=x.device)
    for e0 in range(0, e, step):
        xc, wc = x[e0:e0 + step], w[e0:e0 + step]
        if qc.mode != "off":
            wc = tmoe._tern3(wc)
        w64 = wc.to(x.dtype).to(torch.float64)
        p = torch.matmul(xc.to(torch.float64), w64).to(x.dtype)
        if qc.mode not in ("cim", "cim_fused"):
            out[e0:e0 + step] = p
            continue
        m = torch.matmul(xc.abs().to(torch.float64), w64.abs_()).to(x.dtype)
        pf, mf = p.to(torch.float32), m.to(torch.float32)
        out[e0:e0 + step] = (torch.clamp((mf + pf) * 0.5, max=2.0 ** 14)
                             - torch.clamp((mf - pf) * 0.5, max=2.0 ** 14))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["off", "cim"])
def test_expert_matmul_without_grad_is_unchanged(mode, dtype, monkeypatch):
    """Without grad (serving) the result is the in-place version's bit
    for bit, over one chunk and over chunks of one expert; under grad the
    same value, with gradients."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 6, 32)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((4, 32, 16)).astype(np.float32)).to(dtype)
    qc = tL.QuantConfig(mode=mode)
    for chunk in (tmoe.CHUNK_BYTES, 8 * 32 * 16):
        monkeypatch.setattr(tmoe, "CHUNK_BYTES", chunk)
        want = _expert_matmul_in_place(x, w, qc)
        with torch.no_grad():
            assert torch.equal(tmoe._expert_matmul(x, w.clone().requires_grad_(), qc), want)
        assert torch.equal(tmoe._expert_matmul(x, w, qc), want)
        wg = w.clone().requires_grad_()
        graded = tmoe._expert_matmul(x, wg, qc)
        graded.float().sum().backward()
        assert torch.equal(graded.detach(), want) and torch.isfinite(wg.grad).all()
