"""repro_torch.analysis: per-rule positive/negative fixtures for both
engines, the planted regressions (each reverted), the baseline ratchet's
byte-reproducibility, and the port held against the JAX package's
``repro.analysis``: the same 13 contract names and axes, the same report
keys; plus the small surface ported with it (``kernels/ops.py``, the
ternary helpers, ``layers.set_native_accum``) against the reference
functions on the same numpy inputs.

The planted regressions are the teeth of the suite: each introduces one
regression class the auditor exists to catch (a host sync inside a
wrapped step, a per-call pad of the uint8 planes, a float accumulation
in a plain decode kernel, an op count that grows with ``n_slots``, a
``torch.tensor(...)`` inside the step), asserts the finding fires, then
reverts the injection and asserts the contract is green again.

The whole report runs once (``full_report``, ~20 s on the CPU: the TP
combinations of every contract share one spawned group per degree).
"""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import repro.analysis as JA
from repro.core import ternary as jtern
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.analysis import (
    Finding,
    OpRule,
    SkipTrace,
    TraceContract,
    audit,
    audit_invariance,
    forbid_convert,
    get_trace_contract,
    kernel_scope,
    lint_source,
    registered_trace_contracts,
    run_contract,
    total_ops,
    trace_ops,
)
from repro_torch.analysis import op_audit as O
from repro_torch.analysis.report import (
    BASELINE_NAME,
    baseline_payload,
    build_report,
    canonical_json,
    diff_against_baseline,
    main as report_main,
    repo_root,
)
from repro_torch.core import ternary as tern
from repro_torch.kernels import ops
from repro_torch.models import layers


def rules(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture(scope="module")
def full_report():
    return build_report(repo_root())


# ---------------------------------------------------------------------------
# Op engine: one positive + one negative per rule
# ---------------------------------------------------------------------------


class TestOpRules:
    def test_pad_on_dtype(self):
        contract = TraceContract(no_pad_on_dtypes=("uint8",))
        x = torch.zeros((4, 4), dtype=torch.uint8)

        bad = audit(lambda a: F.pad(a, (0, 0, 0, 4)), (x,), contract)
        assert rules(bad) == ["pad-on-dtype"]
        # a cat that grows a uint8 tensor is a pad too
        bad = audit(lambda a: torch.cat([a, a.new_zeros((4, 4))]), (x,), contract)
        assert rules(bad) == ["pad-on-dtype"]
        # padding a float is outside the forbidden dtype set
        assert not audit(lambda a: F.pad(a, (0, 0, 0, 4)), (x.float(),), contract)

    def test_max_host_syncs(self):
        x = torch.ones((3,), dtype=torch.float32)

        def two_fetches(a):
            return a.sum().item() + float(a.max())

        bad = audit(two_fetches, (x,), TraceContract(max_host_syncs=1))
        assert rules(bad) == ["max-host-syncs"]
        assert not audit(two_fetches, (x,), TraceContract(max_host_syncs=2))
        # data-dependent shapes wait for the device as well
        bad = audit(lambda a: a[a > 1], (x,), TraceContract(max_host_syncs=0))
        assert rules(bad) == ["max-host-syncs"]
        assert not audit(lambda a: a + 1, (x,), TraceContract(max_host_syncs=0))

    def test_max_host_to_device(self):
        x = torch.ones((3,), dtype=torch.float32)
        contract = TraceContract(max_host_to_device=0)
        bad = audit(lambda a: a + torch.tensor([1.0, 2.0, 3.0]), (x,), contract)
        assert rules(bad) == ["max-host-to-device"]
        # a factory on the operand's device copies nothing
        assert not audit(lambda a: a + torch.ones_like(a), (x,), contract)

    def test_forbid_convert_scoped_to_kernel(self):
        contract = TraceContract(forbid_ops=(forbid_convert(),))
        x = torch.ones((4,), dtype=torch.int32)

        # scope is "kernel": a top-level int->f32 convert is allowed
        assert not audit(lambda a: a.to(torch.float32), (x,), contract)

        def in_kernel(a):
            with kernel_scope("packed_decode_mac"):
                return a * 0.5  # an implicit promotion of the counts

        assert rules(audit(in_kernel, (x,), contract)) == ["no-f32-event-promotion"]
        # unscoped variant fires anywhere
        anywhere = TraceContract(forbid_ops=(forbid_convert(within=None),))
        bad = audit(lambda a: a.to(torch.float32), (x,), anywhere)
        assert rules(bad) == ["no-f32-event-promotion"]
        # f32 -> bf16 is not an integer promotion
        assert not audit(lambda a: a.to(torch.bfloat16), (x.float(),), anywhere)

    def test_op_rule_predicate_and_top_scope(self):
        x = torch.ones((4,), dtype=torch.float32)
        top_only = TraceContract(forbid_ops=(
            OpRule(rule="no-top-sin", op="sin", within="top"),))
        assert rules(audit(torch.sin, (x,), top_only)) == ["no-top-sin"]

        def inside(a):
            with kernel_scope("ternary_cim_mac"):
                return torch.sin(a)

        # the same sin inside a kernel's plain version is outside "top"
        assert not audit(inside, (x,), top_only)
        big = TraceContract(forbid_ops=(OpRule(
            rule="no-big-sin", op="aten.sin.default",
            when=lambda rec: rec.inputs[0].shape[0] > 4),))
        assert not audit(torch.sin, (x,), big)
        assert rules(audit(torch.sin, (torch.ones(8),), big)) == ["no-big-sin"]

    def test_forbid_dtype_shapes(self):
        contract = TraceContract(forbid_dtype_shapes=(("float32", (4, 32)),))
        x = torch.ones((4, 32), dtype=torch.bfloat16)

        bad = audit(lambda a: a.to(torch.float32), (x,), contract)
        assert rules(bad) == ["forbid-dtype-shape"]
        assert not audit(lambda a: a + 1, (x,), contract)

    def test_max_ops_and_accum_dtype(self):
        x = torch.ones((4,), dtype=torch.float32)
        bad = audit(lambda a: torch.sin(torch.cos(a)) + 1, (x,),
                    TraceContract(max_ops=1))
        assert rules(bad) == ["max-ops"]
        assert not audit(torch.sin, (x,), TraceContract(max_ops=1))

        def counts(a):
            with kernel_scope("packed_decode_mac"):
                return a.sum(dtype=torch.int32)

        xi = torch.ones((4, 4), dtype=torch.int32)
        assert not audit(counts, (xi,), TraceContract(accum_dtype="int32"))
        # a sum outside every kernel scope is not the kernel's accumulation
        assert not audit(lambda a: a.sum(), (xi,), TraceContract(accum_dtype="int32"))

        def widened(a):
            with kernel_scope("packed_decode_mac"):
                return a.sum()  # torch sums int32 into int64

        assert rules(audit(widened, (xi,), TraceContract(accum_dtype="int32"))) \
            == ["accum-dtype"]

    def test_kernel_launches_are_pseudo_ops(self):
        """A launch (read from the wrappers' counters) is one op named
        ``kernel:<C entry>``, inside the program size."""
        from repro_torch.kernels import ternary_mac as tm

        x = torch.ones((4,), dtype=torch.float32)

        def launches_twice(a):
            tm.ternary_cim_matmul.launches += 2   # what two launches do
            return a + 1

        before = tm.ternary_cim_matmul.launches
        try:
            trace = trace_ops(launches_twice, (x,))
        finally:
            tm.ternary_cim_matmul.launches = before
        assert [r.op for r in trace] == ["kernel:ternary_cim_mac"] * 2 + ["aten.add.Tensor"]
        assert total_ops(trace) == 3
        assert O.kernel_launches(trace) == {"ternary_cim_mac": 2}


class TestInvariance:
    def test_op_count_variant_detected(self):
        def build(n):
            x = torch.ones((n, 8))

            def per_row(a):  # per-slot python work leaks into the program
                return sum(torch.sin(a[i]).sum() for i in range(n))

            return per_row, (x,)

        findings, meta = audit_invariance(build, {"n": (2, 4)})
        assert rules(findings) == ["op-count-variant"]
        assert len(set(meta["op_counts"].values())) == 2

    def test_batched_program_is_invariant(self):
        def build(n):
            return (lambda a: torch.sin(a).sum()), (torch.ones((n, 8)),)

        findings, meta = audit_invariance(build, {"n": (2, 4)})
        assert not findings
        assert len(set(meta["op_counts"].values())) == 1

    def test_skip_trace_is_metadata_not_finding(self):
        def build(n):
            if n > 2:
                raise SkipTrace("needs the card")
            return torch.sin, (torch.ones((n,)),)

        findings, meta = audit_invariance(build, {"n": (2, 4)})
        assert not findings
        assert len(meta["skipped"]) == 1 and "card" in meta["skipped"][0]

    def test_tp_axis_partitions_the_count(self):
        """A TP degree adds its collectives, so the count may change from
        tp 1 to tp 2; it must be one within each degree and must not grow
        with the degree above 1."""
        def build(n, tp, grow):
            extra = (tp - 1 if grow else min(tp - 1, 1))

            def step(a):
                for _ in range(extra):   # a collective, or per-shard work
                    a = a + 1
                return torch.sin(a).sum()

            return step, (torch.ones((n, 4)),)

        axes = {"n": (2, 3), "tp": (1, 2, 4)}
        findings, meta = audit_invariance(lambda n, tp: build(n, tp, False), axes)
        assert not findings, findings
        assert len(set(meta["op_counts"].values())) == 2
        findings, _ = audit_invariance(lambda n, tp: build(n, tp, True), axes)
        assert rules(findings) == ["op-count-variant"]
        assert "grows with tp" in findings[0].message


# ---------------------------------------------------------------------------
# Lint engine: synthetic sources, one positive + one negative per rule
# ---------------------------------------------------------------------------

_PRELUDE = "import torch\nimport numpy as np\n"


def lint(body):
    return lint_source(_PRELUDE + body, "synthetic.py")


class TestLintHostSync:
    def test_np_asarray_flagged_torch_as_tensor_not(self):
        assert rules(lint("def f(x):\n    return np.asarray(x)\n")) == ["host-sync"]
        assert not lint("def f(x):\n    return torch.as_tensor(x)\n")

    @pytest.mark.parametrize("call", ["x.item()", "x.cpu()", "x.tolist()",
                                      "x.numpy()", "torch.cuda.synchronize()",
                                      "ev.synchronize()"])
    def test_fetch_methods(self, call):
        assert rules(lint(f"def f(x, ev):\n    return {call}\n")) == ["host-sync"]

    def test_int_of_torch_expression(self):
        assert rules(lint("def f(x):\n    return int(torch.argmax(x))\n")) \
            == ["host-sync"]
        assert rules(lint("def f(x):\n    return bool(torch.any(x))\n")) \
            == ["host-sync"]
        # int() of host-side python stays host-side
        assert not lint("def f(n):\n    return int(n) + 1\n")
        # device_count is a host query, not a device value
        assert not lint("def f():\n    return int(torch.cuda.device_count())\n")

    def test_suppression_same_line_and_line_above(self):
        assert not lint(
            "def f(x):\n"
            "    return x.cpu()  # analysis: host-sync ok -- documented\n")
        assert not lint(
            "def f(x):\n"
            "    # analysis: host-sync ok -- documented fetch\n"
            "    return x.cpu()\n")
        # a marker for a different rule does not suppress
        assert rules(lint(
            "def f(x):\n"
            "    return x.cpu()  # analysis: tensor-branch ok\n")) == ["host-sync"]


class TestLintTensorBranch:
    def test_branch_on_torch_flagged(self):
        assert rules(lint("def f(x):\n    if torch.any(x):\n        return x\n"
                          "    return -x\n")) == ["tensor-branch"]
        assert rules(lint("def f(x):\n    while (x > 0).all():\n        x = x - 1\n"
                          "    return x\n")) == ["tensor-branch"]

    def test_static_metadata_and_host_queries_exempt(self):
        assert not lint("def f(x):\n    if x.ndim == 2 and x.is_cuda:\n"
                        "        return x\n    return x[None]\n")
        assert not lint("def f(x):\n    if torch.cuda.is_available() and "
                        "torch.is_tensor(x):\n        return x\n    return None\n")
        assert not lint("def f(x):\n    if x.shape[0] > 1 and x.dtype == torch.int8:\n"
                        "        return x\n    return None\n")


def _tree(tmp_path, files):
    for rel, text in files.items():
        path = tmp_path / "src" / "repro_torch" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return tmp_path


class TestLintTree:
    def test_only_traced_packages_are_scanned(self, tmp_path):
        from repro_torch.analysis.lint import lint_paths

        root = _tree(tmp_path, {"serve/a.py": "def f(x):\n    return x.item()\n",
                                "launch/b.py": "def f(x):\n    return x.item()\n"})
        found = lint_paths(root)
        assert [f.where for f in found] == ["src/repro_torch/serve/a.py:2"]

    def test_docstring_on_export_surface(self, tmp_path):
        from repro_torch.analysis.lint import docstring_findings

        root = _tree(tmp_path, {
            "api.py": "from repro_torch.serve.x import bare, told, marked\n",
            "serve/x.py": ("def bare():\n    pass\n\n\n"
                           "def told():\n    \"\"\"Documented.\"\"\"\n\n\n"
                           "# analysis: docstring-missing ok -- internal alias\n"
                           "def marked():\n    pass\n")})
        found = docstring_findings(root)
        assert [(f.rule, f.where) for f in found] == [
            ("docstring-missing", "src/repro_torch/serve/x.py:1")]

    def test_port_markers_carry_reasons(self):
        """Every host-fetch marker in the port's sources says why."""
        from repro_torch.analysis.lint import TRACED_PACKAGES

        base = repo_root() / "src" / "repro_torch"
        marked = [line for pkg in TRACED_PACKAGES
                  for path in sorted((base / pkg).rglob("*.py"))
                  for line in path.read_text().splitlines()
                  if "# analysis: host-sync ok" in line]
        assert len(marked) >= 11
        assert all(line.split("# analysis: host-sync ok", 1)[1].strip(" -")
                   for line in marked), marked


# ---------------------------------------------------------------------------
# Planted regressions: each introduces one forbidden regression, asserts
# the auditor catches it, reverts, and asserts green again.
# ---------------------------------------------------------------------------


class TestInjections:
    def _leaky_decode(self, monkeypatch, leak):
        import repro_torch.models.transformer as T

        orig = T.decode_step

        def leaky_decode_step(params, tokens, caches, index, cfg, **kw):
            tokens = leak(tokens)
            return orig(params, tokens, caches, index, cfg, **kw)

        monkeypatch.setattr(T, "decode_step", leaky_decode_step)

    def test_item_in_wrapped_step_caught(self, monkeypatch):
        """A ``.item()`` smuggled into the step behind the front door's
        seam trips max-host-syncs=0; reverted, the contract is green."""
        point = get_trace_contract("serve.frontdoor.step_passthrough")
        self._leaky_decode(monkeypatch, lambda t: t + 0 * int(t.sum().item()))
        fn, args = point.build(wrapped=1)
        bad = audit(fn, args, point.contract, name=point.name)
        assert "max-host-syncs" in rules(bad), bad

        monkeypatch.undo()
        fn, args = point.build(wrapped=1)
        assert not audit(fn, args, point.contract, name=point.name)

    def test_torch_tensor_in_step_caught(self, monkeypatch):
        """A ``torch.tensor(...)`` of host data inside the step is a
        host->device copy a captured graph cannot hold."""
        point = get_trace_contract("serve.fused_decode_step")
        self._leaky_decode(monkeypatch, lambda t: t + torch.tensor(0, device=t.device))
        fn, args = point.build(n_slots=2, tp=1)
        assert "max-host-to-device" in rules(audit(fn, args, point.contract))

        monkeypatch.undo()
        fn, args = point.build(n_slots=2, tp=1)
        assert not audit(fn, args, point.contract)

    def test_pad_on_uint8_plane_caught(self):
        """De-canonicalized stored planes (pack only, no prepare-time pad
        to the canonical layout) force a per-call pad of the uint8 planes;
        canonical planes (the registered point) stay green."""
        from repro_torch.core.execution import CiMExecSpec, execute_packed

        spec = CiMExecSpec(formulation="blocked", backend="torch",
                           packing="bitplane_u8")
        k, n = 504, 250  # packable (8 | k) but not canonical multiples
        g = torch.Generator().manual_seed(7)
        w = torch.randint(-1, 2, (k, n), generator=g, dtype=torch.int8)
        pos, neg = tern.pack_ternary(w, axis=0)
        x = torch.ones((3, k))

        def f(xv, p, q):
            lay = tern.PackedPlanes(pos=p, neg=q, scale=torch.ones(n), k=k, n=n)
            return execute_packed(spec, xv, lay)

        bad = audit(f, (x, pos, neg), TraceContract(no_pad_on_dtypes=("uint8",)))
        assert "pad-on-dtype" in rules(bad), bad

        findings, _ = run_contract("execution.execute_packed.decode.jnp")
        assert not findings, findings

    def test_float_accumulation_in_plain_decode_kernel_caught(self, monkeypatch):
        """The decode kernel's plain version counting in f32 breaks its
        int32 contract twice (accumulation and promotion); the prefill
        plain version (f32 by design) under the decode rules is the
        reference's minimal reproduction."""
        from repro_torch.kernels import packed_mac as pm

        decode_rules = TraceContract(accum_dtype="int32")
        fn, args = get_trace_contract("kernels.packed_prefill_kernel").build()
        assert "accum-dtype" in rules(audit(fn, args, decode_rules))

        monkeypatch.setattr(pm, "packed_decode_plain", lambda *a, **kw: (
            pm.packed_matmul_plain(*a, **kw).to(torch.int32)))
        bad, _ = run_contract("kernels.packed_decode_kernel")
        assert {"accum-dtype", "no-f32-event-promotion"} <= set(rules(bad)), bad

        monkeypatch.undo()
        findings, meta = run_contract("kernels.packed_decode_kernel")
        assert not findings, findings
        assert any(s.startswith("sass accum-dtype") for s in meta["skipped"])

    def test_op_growth_with_n_slots_caught(self):
        """Per-slot python work wrapped around the real fused step makes
        the op count grow with n_slots; the unwrapped step is invariant."""
        point = get_trace_contract("serve.fused_decode_step")

        def leaky_build(n_slots):
            fn, args = point.build(n_slots=n_slots, tp=1)

            def per_slot(*a):
                toks, caches = fn(*a)
                acc = torch.zeros(())
                for s in range(n_slots):  # python loop over slots
                    acc = acc + torch.sin(toks[s].to(torch.float32))
                return toks, caches, acc

            return per_slot, args

        findings, _ = audit_invariance(leaky_build, {"n_slots": (2, 4)})
        assert rules(findings) == ["op-count-variant"], findings

        findings, meta = audit_invariance(
            lambda n_slots: point.build(n_slots=n_slots, tp=1), {"n_slots": (2, 4)},
            contract=point.contract)
        assert not findings, findings
        assert len(set(meta["op_counts"].values())) == 1

    def test_card_contracts_hold_on_the_plain_versions(self, monkeypatch):
        """The pallas and stream points skip without a card; built on the
        CPU instead (the wrappers run their plain versions in their
        kernel scopes) they pass the same rules, and an M padded to 128
        on a decode call is caught."""
        from repro_torch.core import execution as X

        monkeypatch.setattr(X, "_audit_device", lambda backend: torch.device("cpu"))
        for name in ("execution.execute_packed.decode.pallas",
                     "execution.execute_packed.decode.stream"):
            point = get_trace_contract(name)
            fn, args = point.build()
            trace = trace_ops(fn, args)
            assert any(r.scope for r in trace), name
            assert not O.check_trace(trace, point.contract, name)
            padded = (lambda f: lambda x, *p: f(F.pad(x, (0, 0, 0, 125)), *p))(fn)
            assert "decode-m-pad-128" in rules(audit(padded, args, point.contract))


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------


class TestAgainstReference:
    def test_contract_names_and_axes(self):
        ref = {p.name: dict(p.axes) for p in JA.registered_trace_contracts()}
        mine = {p.name: dict(p.axes) for p in registered_trace_contracts()}
        assert mine == ref
        assert len(mine) == 13

    def test_every_contract_passes_or_skips(self, full_report):
        assert not full_report["findings"], full_report["findings"]
        assert sorted(full_report["contracts"]) == sorted(
            p.name for p in JA.registered_trace_contracts())
        for name, meta in full_report["contracts"].items():
            combos = [s for s in meta["skipped"] if not s.startswith("sass ")]
            assert meta["op_counts"] or combos, name
        # without a card exactly the cuda backends' points skip
        skipped = {n for n, m in full_report["contracts"].items()
                   if any(not s.startswith("sass ") for s in m["skipped"])}
        if not torch.cuda.is_available():
            assert skipped == {"execution.execute_packed.decode.pallas",
                               "execution.execute_packed.decode.stream"}

    def test_report_and_baseline_keys(self, full_report):
        ref_report = JA.build_report(repo_root(), lint=False, audit=False)
        assert set(full_report) == set(ref_report)
        assert set(full_report["summary"]) == set(ref_report["summary"])
        from repro.analysis.report import baseline_payload as ref_payload

        assert set(baseline_payload(full_report)) == set(ref_payload(ref_report))
        ref_finding = JA.Finding("P1", "lint", "host-sync", "a.py:1", "m").to_dict()
        assert set(Finding("P1", "lint", "host-sync", "a.py:1", "m").to_dict()) \
            == set(ref_finding)

    def test_ops_forward_like_the_reference(self):
        rng = np.random.default_rng(0)
        x = rng.integers(-1, 2, (3, 5, 40)).astype(np.float32)
        w = rng.integers(-1, 2, (40, 24)).astype(np.float32)
        got = ops.cim_matmul(torch.from_numpy(x), torch.from_numpy(w), backend="torch")
        want = jops.cim_matmul(jnp.asarray(x), jnp.asarray(w), backend="jnp")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = ops.cim_matmul(torch.from_numpy(x), torch.from_numpy(w), adc_max=3)
        want = jops.cim_matmul(jnp.asarray(x), jnp.asarray(w), adc_max=3, backend="jnp")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = ops.exact_ternary_matmul(torch.from_numpy(x), torch.from_numpy(w))
        want = jops.exact_ternary_matmul(jnp.asarray(x), jnp.asarray(w), backend="jnp")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_ternary_helpers_match_the_reference(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(6, 48)).astype(np.float32)
        np.testing.assert_array_equal(
            tern.ternarize_fixed(torch.from_numpy(x), 0.4).numpy(),
            np.asarray(jtern.ternarize_fixed(jnp.asarray(x), 0.4)))
        t = rng.integers(-1, 2, (48, 16)).astype(np.int8)
        m1, m2 = (t > 0).astype(np.uint8), (t < 0).astype(np.uint8)
        bad = m2.copy()
        bad[3, 4] = m1[3, 4] = 1
        for a, b in ((m1, m2), (m1, bad)):
            assert bool(tern.validate_bitplanes(torch.from_numpy(a), torch.from_numpy(b))) \
                == bool(jtern.validate_bitplanes(jnp.asarray(a), jnp.asarray(b)))
        assert float(tern.ternary_sparsity(torch.from_numpy(t))) \
            == float(jtern.ternary_sparsity(jnp.asarray(t)))
        xs = rng.choice([-1.0, 0.0, 1.0], size=(5, 64), p=[0.45, 0.1, 0.45]).astype(np.float32)
        ws = rng.choice([-1.0, 0.0, 1.0], size=(64, 12), p=[0.45, 0.1, 0.45]).astype(np.float32)
        got = float(tern.block_overflow_rate(torch.from_numpy(xs), torch.from_numpy(ws)))
        want = float(jtern.block_overflow_rate(jnp.asarray(xs), jnp.asarray(ws)))
        assert got == want and 0.0 < got < 1.0

    def test_set_native_accum_matches_the_reference(self):
        rng = np.random.default_rng(2)
        a = rng.normal(size=(2, 3, 8)).astype(np.float32)
        b = rng.normal(size=(8, 5)).astype(np.float32)
        ta = torch.from_numpy(a).to(torch.bfloat16)
        ja = jnp.asarray(a).astype(jnp.bfloat16)
        tb = torch.from_numpy(b).to(torch.bfloat16)
        jb = jnp.asarray(b).astype(jnp.bfloat16)
        try:
            layers.set_native_accum(False)
            jlayers.set_native_accum(False)
            got = layers.accum_einsum("bsk,kn->bsn", ta, tb)
            want = jlayers.accum_einsum("bsk,kn->bsn", ja, jb)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
            layers.set_native_accum(True)
            assert layers.accum_einsum("bsk,kn->bsn", ta, tb).dtype == torch.float32
        finally:
            layers.set_native_accum(None)
            jlayers.set_native_accum(None)
        got = layers.accum_einsum("bsk,kn->bsn", ta, tb)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Baseline ratchet
# ---------------------------------------------------------------------------


class TestBaselineRatchet:
    def test_lint_report_is_byte_reproducible(self, tmp_path):
        """Two lint-only reports of a tree with findings in several files
        serialize to the same bytes (sorted, stable messages)."""
        root = _tree(tmp_path, {
            "serve/b.py": "import torch\ndef f(x):\n    if torch.any(x):\n"
                          "        return x.cpu()\n    return x.item()\n",
            "models/a.py": "import numpy as np\ndef g(x):\n    return np.asarray(x)\n",
            "api.py": "from repro_torch.models.a import g\n"})
        a = build_report(root, audit=False)
        b = build_report(root, audit=False)
        assert a["summary"]["total"] == 5
        assert canonical_json(a) == canonical_json(b)

    def test_committed_baseline_matches_tree(self, full_report):
        """The full report (both engines, all contracts) serializes to
        exactly the committed ANALYSIS_torch_baseline.json; a contract
        run again gives the report's op counts."""
        root = repo_root()
        committed = (root / BASELINE_NAME).read_text()
        assert canonical_json(baseline_payload(full_report)) == committed
        _, meta = run_contract("serve.fused_decode_step.cim")
        assert meta == full_report["contracts"]["serve.fused_decode_step.cim"]

    def test_diff_directions(self):
        f1 = Finding("P1", "lint", "host-sync", "a.py:1", "m1").to_dict()
        f2 = Finding("P1", "lint", "host-sync", "b.py:2", "m2").to_dict()
        report = {"version": 1, "findings": [f1, f2]}
        new, fixed = diff_against_baseline(report, {"version": 1, "findings": [f1]})
        assert new == [f2] and fixed == []
        new, fixed = diff_against_baseline({"version": 1, "findings": [f1]}, report)
        assert new == [] and fixed == [f2]

    def test_cli_check_ratchets_both_ways(self, tmp_path):
        """--check fails on a new finding (regression) AND on a stale
        baseline entry (must ratchet down); lint-only over a small tree
        with one planted host fetch keeps the test fast."""
        root = _tree(tmp_path / "tree", {"serve/a.py": "def f(x):\n    return x.item()\n"})
        base = tmp_path / "base.json"
        common = ["--no-audit", "--root", str(root), "--baseline", str(base)]
        assert report_main(common + ["--write-baseline"]) == 0
        assert report_main(common + ["--check"]) == 0

        payload = json.loads(base.read_text())
        assert len(payload["findings"]) == 1
        stale = {**payload["findings"][0], "where": "no/longer/there.py:1"}
        base.write_text(json.dumps(
            {"version": 1, "findings": payload["findings"] + [stale]}))
        assert report_main(common + ["--check"]) == 1  # stale entry

        base.write_text(json.dumps({"version": 1, "findings": []}))
        assert report_main(common + ["--check"]) == 1  # a new finding

    def test_cli_json_artifact(self, tmp_path):
        out = tmp_path / "report.json"
        assert report_main(["--no-audit", "--json", str(out)]) == 0
        payload = json.loads(out.read_text())
        assert payload["version"] == 1
        assert set(payload) == {"version", "findings", "summary", "contracts"}
