"""The captured prefill and train step on the CPU, where the same
functions run eagerly on the same static tensors: the batcher's
prefill (fresh caches reset in the graph, merged in place under a fill
mask) against the old route that allocated fresh caches per fill and
copied the filled rows with ``index_copy_``, rebuilt here as the plain
version; ``make_jit_train_step`` (in-place AdamW) against
``make_train_step`` bit for bit; and the Trainer keeping one state
storage through a restart and a restore. The captures themselves run on
the card (``tests/test_torch_cuda.py``); the steps against the JAX
package: ``tests/test_torch_train_step.py``."""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serve.engine import ContinuousBatcher, Request, sample
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import (init_train_state, make_jit_train_step,
                                          make_train_step)
from repro_torch.train.trainer import FailureInjector, TrainConfig, Trainer

# (arch, cache dtype): dense under bf16 and int8 caches, hybrid, moe (MLA)
SERVE_CASES = [("smollm-135m", "bf16"), ("smollm-135m", "int8"),
               ("zamba2-2.7b", "bf16"), ("deepseek-v2-236b", "bf16")]


class _IndexCopyBatcher(ContinuousBatcher):
    """The prefill as it ran before the capture: fresh caches allocated
    per fill, the filled rows copied with ``index_copy_``."""

    def _prefill(self, tokens, start, fill):
        fresh = T.init_caches(self.cfg, self.n_slots, self.s_max, device=self.device)
        logits, fresh = T.decode_step(self.params, tokens, fresh, 0, self.cfg,
                                      start=start)
        toks = sample(logits[:, -1:, :], self._generator, self.temperature)[:, 0]
        rows = fill.nonzero()[:, 0]
        for old, new in zip(T.cache_leaves(self.caches), T.cache_leaves(fresh)):
            old.index_copy_(1, rows, new.index_select(1, rows))
        return toks


@pytest.fixture(scope="module")
def serve_models():
    """One seeded smoke model per arch (moe at a capacity factor at which
    nothing drops)."""
    out = {}
    for arch in sorted({a for a, _ in SERVE_CASES}):
        cfg = get_config(arch, smoke=True)
        if cfg.family == "moe":
            cfg = cfg.replace(moe_capacity_factor=8.0)
        out[arch] = (cfg, T.init_params(cfg, seed=0, device="cpu"))
    return out


def _leaves(batcher):
    return list(T.cache_leaves(batcher.caches))


@pytest.mark.parametrize("arch,cache_dtype", SERVE_CASES)
def test_prefill_merge_equals_index_copy(serve_models, arch, cache_dtype):
    """Fills of 1-5-token prompts (buckets 4 and 8), a refill of a slot
    whose request was cancelled mid-decode, and refills as requests end:
    after every step the caches and tokens equal the index_copy_ route's
    bit for bit, and the caches, the fresh caches and the static inputs
    keep their storage."""
    cfg, params = serve_models[arch]
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)] for n in (5, 1, 3, 2, 4)]
    max_news = (6, 2, 5, 3, 3)
    runs = []
    for cls in (ContinuousBatcher, _IndexCopyBatcher):
        b = cls(params, cfg, n_slots=3, s_max=16, device="cpu", cache_dtype=cache_dtype)
        reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(zip(prompts, max_news))]
        for r in reqs:
            b.submit(r)
        runs.append((b, reqs))
    (mine, reqs), (plain, plain_reqs) = runs
    ptrs = [a.data_ptr() for a in _leaves(mine) + list(T.cache_leaves(mine._fresh))]
    step = 0
    while mine.queue or any(r is not None for r in mine.slot_req):
        if step == 2:   # request 0 mid-decode: its slot is refilled next step
            assert mine.cancel(0) and plain.cancel(0)
        mine.step()
        plain.step()
        step += 1
        for a, b in zip(_leaves(mine), _leaves(plain)):
            assert torch.equal(a, b), step
        assert [a.data_ptr() for a in _leaves(mine) + list(T.cache_leaves(mine._fresh))
                ] == ptrs
    assert [r.generated for r in reqs] == [r.generated for r in plain_reqs]
    assert reqs[0].cancelled and mine.prefill_batches >= 3
    assert sorted(mine._prefill_steps) == [4, 8]
    for host, prefill in mine._prefill_steps.values():
        assert prefill.inputs[1:] == mine._fill_static
        assert prefill.inputs[0].shape == host.shape
    st = mine.stats()
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_batches"]
    assert mine.prefill_capture_seconds is None      # eager on the CPU


def test_exact_length_fallback_gets_its_own_step(serve_models):
    """A prompt whose bucket would reach s_max prefills at its exact
    length: one step per such length, beside the pow2 buckets."""
    cfg, params = serve_models["smollm-135m"]
    b = ContinuousBatcher(params, cfg, n_slots=1, s_max=8, device="cpu")
    for i, n in enumerate((5, 6, 2)):
        b.submit(Request(i, list(range(1, n + 1)), max_new=2))
    b.run()
    assert sorted(b._prefill_steps) == [4, 5, 6]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _train_setup():
    cfg = get_config("smollm-135m", smoke=True).replace(dtype="float32")
    opt = adamw.AdamWConfig(lr=1e-3, schedule=warmup_cosine(2, 3))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    return cfg, opt, pipe


def _batch(pipe, i):
    return {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}


@pytest.mark.parametrize("compression", [None, "int8"])
def test_jit_train_step_equals_train_step(compression):
    """3 steps of make_jit_train_step == 3 of make_train_step from the
    same state, bit for bit: metrics, params, moments, step, residual and
    the generator's state after. The state keeps its storage and is
    returned itself."""
    cfg, opt, pipe = _train_setup()
    plain_state = init_train_state(cfg, seed=0, grad_compression=compression, device="cpu")
    state = init_train_state(cfg, seed=0, grad_compression=compression, device="cpu")
    ptrs = [t.data_ptr() for t in ckpt.tree_flatten(state) if torch.is_tensor(t)]
    plain = make_train_step(cfg, opt, grad_compression=compression)
    jit = make_jit_train_step(cfg, opt, grad_compression=compression)
    for i in range(3):
        plain_state, want = plain(plain_state, _batch(pipe, i))
        got_state, got = jit(state, _batch(pipe, i))
        assert got_state is state
        assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    for a, b in zip(ckpt.tree_flatten(state), ckpt.tree_flatten(plain_state)):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert torch.equal(a.get_state(), b.get_state())
    assert [t.data_ptr() for t in ckpt.tree_flatten(state) if torch.is_tensor(t)] == ptrs
    assert int(state.opt.step) == 3
    assert jit.captured is not None and jit.captured.graph is None


def test_jit_train_step_raises_on_other_storage_or_batch():
    cfg, opt, pipe = _train_setup()
    state = init_train_state(cfg, seed=0, device="cpu")
    jit = make_jit_train_step(cfg, opt)
    jit(state, _batch(pipe, 0))
    other = init_train_state(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="bound to the state storage"):
        jit(other, _batch(pipe, 1))
    short = {k: v[:, :8] for k, v in _batch(pipe, 1).items()}
    with pytest.raises(ValueError, match="bound to the batch of its first call"):
        jit(state, short)
    assert int(state.opt.step) == 1


def test_in_place_update_needs_the_residual():
    """bf16 compression: init_train_state makes the zero residual that
    the in-place step writes (the reference makes one at the first step;
    the values are the same), and a state without one raises."""
    cfg, opt, pipe = _train_setup()
    state = init_train_state(cfg, seed=0, grad_compression="bf16", device="cpu")
    assert state.residual is not None
    plain_state, want = make_train_step(cfg, opt, "bf16")(state._replace(residual=None),
                                                          _batch(pipe, 0))
    _, got = make_jit_train_step(cfg, opt, "bf16")(state, _batch(pipe, 0))
    assert float(got["loss"]) == float(want["loss"])
    for a, b in zip(adamw.tree_leaves(state.residual),
                    adamw.tree_leaves(plain_state.residual)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs the state's residual"):
        make_jit_train_step(cfg, opt, "bf16")(state._replace(residual=None),
                                              _batch(pipe, 1))


@pytest.mark.parametrize("fail_at,ckpt_every", [(3, 2), (1, 4)],
                         ids=["restore", "restart"])
def test_trainer_keeps_its_state_storage(fail_at, ckpt_every):
    """A failure after a checkpoint restores it, and one before the first
    checkpoint restarts from a fresh state: both copy into the state the
    captured step holds (its storage unchanged, the step not rebuilt),
    and the replayed steps equal their first pass bit for bit."""
    cfg = get_config("smollm-135m", smoke=True)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), TrainConfig(
            num_steps=4, ckpt_dir=d, ckpt_every=ckpt_every, log_every=0,
            grad_compression="int8"), pipe, failure_injector=FailureInjector([fail_at]),
            device="cpu")
        ptrs = [t.data_ptr() for t in ckpt.tree_flatten(tr.state) if torch.is_tensor(t)]
        generator = tr.state.generator
        log = tr.run()
    assert tr.restarts == 1
    assert [t.data_ptr() for t in ckpt.tree_flatten(tr.state) if torch.is_tensor(t)] == ptrs
    assert tr.state.generator is generator and tr.step_fn.captured is not None
    by_step = {}
    for m in log:
        by_step.setdefault(m["step"], []).append((m["loss"], m["grad_norm"]))
    replayed = [v for v in by_step.values() if len(v) == 2]
    assert replayed and all(a == b for a, b in replayed)
