"""The port's training infrastructure against the JAX package and the
counterparts of tests/test_train.py: AdamW (the update within 1 ulp of
the reference's on the same grads), the clip and the schedules, gradient
compression, the token pipeline (the reference's arrays bit for bit),
checkpoints (bf16, two-phase commit, gc, async, and params trees that
cross between the packages), the fault-tolerant Trainer, and the
launcher on the CPU."""
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.optim import compress as jcomp
from repro.optim import schedules as jsched
from repro.train import checkpoint as jckpt
from repro_torch.bridge import params_from_numpy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_config
from repro_torch.optim import compress as gcomp
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamWConfig, AdamWState, clip_by_global_norm, init, update
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import init_train_state
from repro_torch.train.trainer import FailureInjector, TrainConfig, Trainer


def small_cfg():
    return get_config("smollm-135m", smoke=True)


def make_pipe(cfg, seq=32, gb=4):
    return TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb))


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


# ---------------------------------------------------------------------------
# AdamW, clip, schedules
# ---------------------------------------------------------------------------


class TestAdamW:
    def test_descends_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = init(params)
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, state, _ = update(cfg, grads, state, params)
        assert float(params["w"].abs().max()) < 0.1

    def test_update_matches_reference(self):
        """Four steps, each from the same (params, state, grads) in both
        packages, with the schedule: f32 params, moments and norm within 1
        ulp of the reference's, bf16 params equal. The clip runs at a max
        norm above the grads' (scale 1 in both): when it scales, the two
        global norms' last-ulp difference (their sums run in another
        order) moves every clipped gradient, which b1·m + (1-b1)·g
        amplifies where it cancels; test_grad_clip holds the clip itself."""
        rng = np.random.default_rng(0)
        shapes = {"a": ((64, 48), np.float32), "b": ((300,), np.float32),
                  "c": ((32, 16), ml_dtypes.bfloat16)}
        jparams = {k: jnp.asarray(rng.standard_normal(s).astype(d))
                   for k, (s, d) in shapes.items()}
        jstate = jadamw.init(jparams)
        jcfg = jadamw.AdamWConfig(lr=1e-2, grad_clip=100.0,
                                  schedule=jsched.warmup_cosine(2, 6))
        tcfg = AdamWConfig(lr=1e-2, grad_clip=100.0, schedule=schedules.warmup_cosine(2, 6))

        def to_t(a):
            a = np.asarray(a)
            if a.dtype == ml_dtypes.bfloat16:
                return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            return torch.from_numpy(a.copy())

        for _ in range(4):
            jgrads = {k: jnp.asarray(rng.standard_normal(s).astype(d) * 0.3)
                      for k, (s, d) in shapes.items()}
            tparams = {k: to_t(v) for k, v in jparams.items()}
            tstate = AdamWState(torch.tensor(int(jstate.step), dtype=torch.int32),
                                {k: to_t(v) for k, v in jstate.mu.items()},
                                {k: to_t(v) for k, v in jstate.nu.items()})
            tgrads = {k: to_t(v) for k, v in jgrads.items()}
            jparams, jstate, jnorm = jadamw.update(jcfg, jgrads, jstate, jparams)
            tp, ts, tnorm = update(tcfg, tgrads, tstate, tparams)
            np.testing.assert_array_max_ulp(tnorm.numpy(), np.asarray(jnorm), maxulp=1)
            assert int(ts.step) == int(jstate.step)
            for k in shapes:
                np.testing.assert_array_max_ulp(ts.mu[k].numpy(), np.asarray(jstate.mu[k]), 1)
                np.testing.assert_array_max_ulp(ts.nu[k].numpy(), np.asarray(jstate.nu[k]), 1)
                want = np.asarray(jparams[k]).astype(np.float32)
                if shapes[k][1] is np.float32:
                    np.testing.assert_array_max_ulp(tp[k].numpy(), want, maxulp=1)
                else:
                    assert tp[k].dtype == torch.bfloat16
                    np.testing.assert_array_equal(_np(tp[k]), want)

    def test_grad_clip(self):
        g = {"a": torch.full((10,), 100.0)}
        clipped, norm = clip_by_global_norm(g, 1.0)
        assert float(norm) > 100
        assert np.isclose(float(torch.linalg.norm(clipped["a"])), 1.0, rtol=1e-5)
        jclipped, jnorm = jadamw.clip_by_global_norm({"a": jnp.full((10,), 100.0)}, 1.0)
        np.testing.assert_array_equal(clipped["a"].numpy(), np.asarray(jclipped["a"]))
        assert float(norm) == float(jnorm)

    @pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clipped", "unclipped"])
    def test_update_in_slices_is_bit_equal(self, grad_clip, monkeypatch):
        """Leaves above SLICE_ELEMS update in slices along their first
        axis: params, moments and norm bit-equal to the whole-leaf update
        (and to clip_by_global_norm's rounding), bf16 and f32 leaves."""
        from repro_torch.optim import adamw as tadamw

        g = torch.Generator().manual_seed(3)
        params = {"a": torch.randn((7, 5, 6), generator=g),
                  "b": {"c": torch.randn((9, 4), generator=g).to(torch.bfloat16),
                        "d": torch.randn((3,), generator=g)}}
        grads = tadamw.tree_map(lambda p: (torch.randn(p.shape, generator=g) * 4).to(p.dtype),
                                params)
        state = init(params)
        state = AdamWState(state.step + 2, tadamw.tree_map(lambda m: m + 0.01, state.mu),
                           tadamw.tree_map(lambda v: v + 0.02, state.nu))
        cfg = AdamWConfig(lr=1e-2, grad_clip=grad_clip)
        whole = update(cfg, grads, state, params)
        monkeypatch.setattr(tadamw, "SLICE_ELEMS", 8)
        sliced = update(cfg, grads, state, params)
        assert torch.equal(whole[2], sliced[2])
        for x, y in ((whole[0], sliced[0]), (whole[1].mu, sliced[1].mu),
                     (whole[1].nu, sliced[1].nu)):
            for a, b in zip(tadamw.tree_leaves(x), tadamw.tree_leaves(y)):
                assert a.dtype == b.dtype and torch.equal(a, b)
        if grad_clip:
            clipped, _ = clip_by_global_norm(grads, grad_clip)
            want = update(AdamWConfig(lr=1e-2, grad_clip=0.0), clipped, state, params)
            for a, b in zip(tadamw.tree_leaves(want[0]), tadamw.tree_leaves(sliced[0])):
                assert torch.equal(a, b)

    def test_schedule_shape(self):
        f = schedules.warmup_cosine(10, 100)
        assert float(f(torch.tensor(0, dtype=torch.int32))) == 0.0
        assert float(f(torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0)
        assert float(f(torch.tensor(100, dtype=torch.int32))) == pytest.approx(0.1, abs=1e-3)

    @pytest.mark.parametrize("name,args", [
        ("constant", ()), ("linear_warmup", (10,)), ("warmup_cosine", (10, 80)),
        ("inverse_sqrt", (10,))])
    def test_schedules_match_reference(self, name, args):
        """At steps 0-100, within 1.2e-7 (one ulp of 1.0) absolute: the two
        frameworks' f32 cos differ in the last ulp, which 1 + cos(pi·p)
        turns into several ulps of the small values near the end."""
        steps = np.arange(0, 101, dtype=np.int32)
        want = np.array([float(getattr(jsched, name)(*args)(jnp.int32(s))) for s in steps],
                        np.float32)
        fn = getattr(schedules, name)(*args)
        got = np.array([float(fn(torch.tensor(s, dtype=torch.int32))) for s in steps],
                       np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def test_roundtrip_bf16(self):
        tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                "b": {"c": torch.tensor(3.5), "d": torch.arange(4, dtype=torch.int32)}}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 7, tree)
            out, step = ckpt.restore(d, tree)
            assert step == 7
            for x, y in zip(ckpt.tree_flatten(tree), ckpt.tree_flatten(out)):
                assert torch.equal(x, y) and x.dtype == y.dtype

    def test_two_phase_commit_and_latest(self):
        tree = {"a": torch.zeros((4,))}
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 1, tree)
            ckpt.save(d, 2, tree)
            assert ckpt.latest_step(d) == 2
            assert not any(p.endswith(".tmp") for p in os.listdir(d))

    def test_gc_old(self):
        tree = {"a": torch.zeros((4,))}
        with tempfile.TemporaryDirectory() as d:
            for s in range(5):
                ckpt.save(d, s, tree)
            ckpt.gc_old(d, keep_last_n=2)
            steps = sorted(p for p in os.listdir(d) if p.startswith("step_"))
            assert steps == ["step_00000003", "step_00000004"]

    def test_async_save(self):
        tree = {"a": torch.ones((8,))}
        with tempfile.TemporaryDirectory() as d:
            fut = ckpt.save(d, 3, tree, async_=True)
            fut.result()
            out, step = ckpt.restore(d, tree)
            assert step == 3 and torch.equal(out["a"], tree["a"])

    def test_train_state_roundtrip(self):
        """A whole TrainState: params, AdamW state, the generator (its
        state continues the same stream) and the residual."""
        state = init_train_state(small_cfg(), seed=3, grad_compression="int8", device="cpu")
        state.generator.manual_seed(11)
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 5, state)
            expect = torch.rand(4, generator=state.generator)
            like = init_train_state(small_cfg(), seed=4, grad_compression="int8",
                                    device="cpu")
            out, _ = ckpt.restore(d, like)
        assert type(out) is type(state) and type(out.opt) is AdamWState
        for x, y in zip(ckpt.tree_flatten(state.params), ckpt.tree_flatten(out.params)):
            assert torch.equal(x, y) and x.dtype == y.dtype
        assert out.residual is not None and int(out.opt.step) == 0
        assert torch.equal(torch.rand(4, generator=out.generator), expect)

    def test_params_cross_between_packages(self):
        """A bf16 smoke params tree saved by the reference restores bit for
        bit in the port, and the port's save restores in the reference."""
        jcfg = jget_config("smollm-135m", smoke=True)
        jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
        like = params_from_numpy(jax.tree_util.tree_map(np.zeros_like, tree),
                                 small_cfg(), device="cpu")
        with tempfile.TemporaryDirectory() as d:
            jckpt.save(d, 4, jparams)
            got, step = ckpt.restore(d, like)
        assert step == 4
        want = params_from_numpy(tree, small_cfg(), device="cpu")
        for x, y in zip(ckpt.tree_flatten(want), ckpt.tree_flatten(got)):
            assert y.dtype == torch.bfloat16 and torch.equal(x, y)
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 9, got)
            back, step = jckpt.restore(d, jax.tree_util.tree_map(jnp.zeros_like, jparams))
        assert step == 9
        for x, y in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


class TestTrainerFaultTolerance:
    def test_failover_resumes_from_checkpoint(self):
        cfg = small_cfg()
        pipe = make_pipe(cfg)
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, AdamWConfig(lr=1e-3),
                         TrainConfig(num_steps=8, ckpt_dir=d, ckpt_every=3, log_every=0),
                         pipe, failure_injector=FailureInjector([5]), device="cpu")
            log = tr.run()
            assert tr.restarts == 1
            steps = [m["step"] for m in log]
            # the failure at 5 resumes from the checkpoint at 3: 3 and 4 replay
            assert steps == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
            assert ckpt.latest_step(d) == 8
            by_step = {}
            for m in log:
                by_step.setdefault(m["step"], []).append(m["loss"])
            assert by_step[3][0] == by_step[3][1] and by_step[4][0] == by_step[4][1]

    def test_failure_waits_for_the_checkpoint_in_flight(self, monkeypatch):
        """A failure while the checkpoint at 2 is still committing resumes
        from it, not from step 0: the restore does not depend on the
        IO's timing (a commit that takes 0.5 s here)."""
        inner = ckpt._EXECUTOR

        class Slow:
            def submit(self, fn):
                return inner.submit(lambda: (time.sleep(0.5), fn())[1])

        monkeypatch.setattr(ckpt, "_EXECUTOR", Slow())
        cfg = small_cfg()
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, AdamWConfig(lr=1e-3),
                         TrainConfig(num_steps=4, ckpt_dir=d, ckpt_every=2, log_every=0),
                         make_pipe(cfg), failure_injector=FailureInjector([2]),
                         device="cpu")
            log = tr.run()
        assert tr.restarts == 1 and [m["step"] for m in log] == [0, 1, 2, 3]

    def test_too_many_failures_raises(self):
        cfg = small_cfg()
        pipe = make_pipe(cfg)

        class Always:
            def __init__(self):
                self.count = 0

            def maybe_fail(self, step):
                if step == 2 and self.count < 3:
                    self.count += 1
                    raise RuntimeError("boom")

        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, AdamWConfig(), TrainConfig(num_steps=6, ckpt_dir=d,
                         ckpt_every=2, log_every=0, max_restarts=1), pipe,
                         failure_injector=Always(), device="cpu")
            with pytest.raises(RuntimeError, match="boom"):
                tr.run()
            assert tr.restarts == 2

    def test_resume_across_trainer_instances(self):
        cfg = small_cfg()
        pipe = make_pipe(cfg)
        with tempfile.TemporaryDirectory() as d:
            t1 = Trainer(cfg, AdamWConfig(lr=1e-3),
                         TrainConfig(num_steps=4, ckpt_dir=d, ckpt_every=2, log_every=0),
                         pipe, device="cpu")
            t1.run()
            t2 = Trainer(cfg, AdamWConfig(lr=1e-3),
                         TrainConfig(num_steps=6, ckpt_dir=d, ckpt_every=2, log_every=0),
                         pipe, device="cpu")
            assert t2.start_step == 4  # picked up the committed checkpoint
            for x, y in zip(ckpt.tree_flatten(t1.state.params),
                            ckpt.tree_flatten(t2.state.params)):
                assert torch.equal(x, y)
            log = t2.run()
            assert log[-1]["step"] == 5


class TestTrainerFamilies:
    """The Trainer beyond the dense family, and its deterministic mode."""

    @staticmethod
    def _det():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())

    @pytest.mark.parametrize("setting", [(False, False), (True, False), (True, True)],
                             ids=["off", "strict", "warn_only"])
    def test_run_restores_the_callers_deterministic_setting(self, setting):
        """Steps run under deterministic mode (warn only); run() leaves
        the caller's setting as it found it, also when it raises."""
        before = self._det()
        torch.use_deterministic_algorithms(setting[0], warn_only=setting[1])
        try:
            cfg = small_cfg()
            tr = Trainer(cfg, AdamWConfig(), TrainConfig(num_steps=2, log_every=0),
                         make_pipe(cfg), device="cpu")
            inner, seen = tr.step_fn, []
            tr.step_fn = lambda state, batch: seen.append(self._det()) or inner(state, batch)
            tr.run()
            assert seen == [(True, True)] * 2 and self._det() == setting

            def boom(state, batch):
                raise RuntimeError("boom")

            tr = Trainer(cfg, AdamWConfig(), TrainConfig(num_steps=1, log_every=0),
                         make_pipe(cfg), device="cpu")
            tr.step_fn = boom
            with pytest.raises(RuntimeError, match="boom"):
                tr.run()
            assert self._det() == setting
        finally:
            torch.use_deterministic_algorithms(before[0], warn_only=before[1])

    @pytest.mark.parametrize("arch,key", [("whisper-large-v3", "frames"),
                                          ("llava-next-34b", "patches")])
    def test_batch_transform_supplies_frames_or_patches(self, arch, key):
        """The token pipeline makes no frames or patches: encdec and vlm
        train through ``batch_transform``; without it their forward
        raises."""
        cfg = get_config(arch, smoke=True)
        shape = ((cfg.encoder_seq, cfg.d_model) if key == "frames"
                 else (cfg.n_image_tokens, cfg.d_vision))

        def add(batch):
            rng = np.random.default_rng(int(batch["tokens"].sum()))
            b = batch["tokens"].shape[0]
            return dict(batch, **{key: rng.standard_normal((b,) + shape).astype(np.float32)})

        pipe = make_pipe(cfg, seq=16, gb=2)
        tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainConfig(num_steps=3, log_every=0),
                     pipe, batch_transform=add, device="cpu")
        # the step updates the params in place: keep copies of the first
        first = [a.clone() for a in ckpt.tree_flatten(tr.state.params)]
        log = tr.run()
        assert [m["step"] for m in log] == [0, 1, 2]
        assert all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in log)
        assert any(not torch.equal(a, b) for a, b in
                   zip(first, ckpt.tree_flatten(tr.state.params)))
        tr = Trainer(cfg, AdamWConfig(), TrainConfig(num_steps=1, log_every=0), pipe,
                     device="cpu")
        with pytest.raises(ValueError, match=f"needs {key}"):
            tr.run()

    @pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b", "deepseek-v2-236b"])
    def test_failover_replays_bit_equal(self, arch):
        """A failure at 3 resumes from the checkpoint at 2: step 2 replays
        with its first pass's loss and grad norm."""
        cfg = get_config(arch, smoke=True)
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, AdamWConfig(lr=1e-3),
                         TrainConfig(num_steps=4, ckpt_dir=d, ckpt_every=2, log_every=0),
                         make_pipe(cfg, seq=16, gb=2),
                         failure_injector=FailureInjector([3]), device="cpu")
            log = tr.run()
        assert tr.restarts == 1 and [m["step"] for m in log] == [0, 1, 2, 2, 3]
        assert (log[2]["loss"], log[2]["grad_norm"]) == (log[3]["loss"], log[3]["grad_norm"])


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


class TestGradCompression:
    def test_int8_unbiased_roundtrip(self):
        g = torch.randn(1000, generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        decs = torch.stack([gcomp.decode_int8(gcomp.encode_int8(g, gen)) for _ in range(64)])
        bias = (decs.mean(0) - g).abs().max()
        amax = float(g.abs().max())
        assert float(bias) < 0.05 * amax  # stochastic rounding ~unbiased
        # each value rounds to one of its two neighbouring int8 levels
        scale = amax / 127.0
        assert float((decs - g).abs().max()) <= scale * (1 + 1e-5)

    def test_error_feedback_reduces_drift(self):
        grads = {"w": torch.randn(512, generator=torch.Generator().manual_seed(2))}
        res = gcomp.init_residual(grads)
        total_dec = torch.zeros(512)
        total_g = torch.zeros(512)
        gen = torch.Generator().manual_seed(3)
        for _ in range(32):
            dec, res = gcomp.compress_grads(grads, "int8", gen, res)
            total_dec = total_dec + dec["w"]
            total_g = total_g + grads["w"]
        # cumulative compressed updates track cumulative true gradient
        rel = float(torch.linalg.norm(total_dec - total_g) / torch.linalg.norm(total_g))
        assert rel < 0.02

    def test_bf16_mode(self):
        """The bf16 round trip equals the reference's exactly, and so does
        its error-feedback residual."""
        x = np.random.default_rng(4).standard_normal(64).astype(np.float32) * 1.2345678
        r = np.random.default_rng(5).standard_normal(64).astype(np.float32) * 1e-3
        dec, res = gcomp.compress_grads({"w": torch.from_numpy(x)}, "bf16", None,
                                        {"w": torch.from_numpy(r)})
        jdec, jres = jcomp.compress_grads({"w": jnp.asarray(x)}, "bf16", None,
                                          {"w": jnp.asarray(r)})
        np.testing.assert_array_equal(dec["w"].numpy(), np.asarray(jdec["w"]))
        np.testing.assert_array_equal(res["w"].numpy(), np.asarray(jres["w"]))
        assert float((dec["w"] - torch.from_numpy(x + r)).abs().max()) < 0.01

    def test_trainer_with_compression_trains(self):
        cfg = small_cfg()
        pipe = make_pipe(cfg)
        tr = Trainer(cfg, AdamWConfig(lr=1e-3),
                     TrainConfig(num_steps=3, log_every=0, grad_compression="int8"),
                     pipe, device="cpu")
        log = tr.run()
        assert all(np.isfinite(m["loss"]) for m in log)
        assert tr.state.residual is not None


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


class TestData:
    def test_deterministic_and_seekable(self):
        cfg = small_cfg()
        p1, p2 = make_pipe(cfg), make_pipe(cfg)
        b1 = p1.batch(17)
        for _ in p2.iterator(0):
            break
        np.testing.assert_array_equal(b1["tokens"], p2.batch(17)["tokens"])
        np.testing.assert_array_equal(next(p2.iterator(17))["labels"], b1["labels"])

    def test_host_slices_partition_batch(self):
        cfg = small_cfg()
        p = make_pipe(cfg, gb=8)
        full = p.batch(3)["tokens"]
        parts = [p.host_slice(3, h, 4)["tokens"] for h in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts), full)

    def test_labels_are_shifted_tokens(self):
        cfg = small_cfg()
        b = make_pipe(cfg).batch(0)
        # tokens[t+1] == labels[t] by construction
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    @pytest.mark.parametrize("corpus", [False, True])
    def test_batches_equal_reference(self, corpus, tmp_path):
        """Synthetic (seq 128: the induction motifs on) and file-backed."""
        path = None
        if corpus:
            path = str(tmp_path / "corpus.npy")
            np.save(path, np.random.default_rng(6).integers(0, 256, 5000).astype(np.int32))
        kw = dict(vocab=256, seq_len=128, global_batch=4, seed=9, corpus_path=path)
        mine, ref = TokenPipeline(DataConfig(**kw)), JPipeline(JDataConfig(**kw))
        for step in (0, 1, 17):
            a, b = mine.batch(step), ref.batch(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_cpu(capsys, tmp_path):
    assert launch_train.main(["--smoke", "--device", "cpu", "--steps", "3",
                              "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "[train] done" in out
    assert ckpt.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("arch", ["mamba2-780m", "deepseek-v2-236b"])
def test_launcher_trains_other_families_on_cpu(capsys, arch):
    assert launch_train.main(["--smoke", "--device", "cpu", "--arch", arch, "--steps", "3",
                              "--seq", "32", "--batch", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[train] {arch}:" in out
    assert "device=cpu" in out and "[train] done" in out


def test_launcher_and_trainer_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(small_cfg(), AdamWConfig(), TrainConfig(num_steps=1), make_pipe(small_cfg()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(small_cfg())
