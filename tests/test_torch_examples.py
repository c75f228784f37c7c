"""The examples/torch twins of examples/*.py, each run with ``--device
cpu``, against the JAX package's examples and the port's own entry
points:

  * quickstart: kernel #1's wrapper (its plain version here) equals the
    functional model, and the hardware lines (the paper's Fig 9 table,
    the MAC pass, the iso-capacity speedup, the yi-34b projection) carry
    the reference example's values, computed by the reference's calls
    the example makes;
  * cim_array_demo: the encoding, truth table and multi-row MAC sections
    print the reference example's lines;
  * serve_ternary: every request's tokens equal the port's generate()
    (the example serves under per-row activation scales);
  * train_ternary_lm: the smoke config trains for --steps and --seq.
"""
import contextlib
import dataclasses
import importlib.util
import io
import pathlib

import pytest
import torch

from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(path):
    spec = importlib.util.spec_from_file_location(f"example_{path.stem}_{path.parent.name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(path, argv=None):
    """(main's result, its stdout) of an example script."""
    mod = _load(path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main() if argv is None else mod.main(argv)
    return out, buf.getvalue()


def _port(name):
    return ROOT / "examples" / "torch" / f"{name}.py"


def test_quickstart_hardware_lines_are_the_reference_example_values():
    from repro import api as japi
    from repro import hw as jhw

    agree, text = _run(_port("quickstart"), ["--device", "cpu"])
    assert agree is True
    assert "kernel == functional model: True" in text
    assert "kernel == plain version: True" in text
    # the reference example's hardware section, by the calls it makes
    spec = japi.CiMExecSpec(formulation="blocked", backend="jnp")
    design = japi.spec_design(spec)
    array = jhw.ArraySpec(technology="8T-SRAM", design=design)
    cost = japi.spec_cost_summary(spec, array=array)
    t = jhw.paper_validation_table()["8T-SRAM"][design]
    s = jhw.average_speedup("8T-SRAM", design, "iso-capacity")
    p = jhw.project("yi-34b", "decode_32k", array)
    want = [
        f"  CiM latency reduction : {t['cim_latency_reduction_pct']:.0f}%  (paper: 88%)",
        f"  CiM energy reduction  : {t['cim_energy_reduction_pct']:.0f}%  (paper: 74%)",
        f"  MAC pass              : {cost['mac_pass_ns']:.0f} ns",
        f"  system speedup (5 DNNs, iso-capacity): {s:.2f}x (paper: 6.74x)",
        f"  projected yi-34b decode on that array: {p['tok_s']:.0f} tok/s, "
        f"{p['iso_capacity']['speedup']:.1f}x vs iso-capacity NM",
    ]
    lines = text.splitlines()
    for line in want:
        assert line in lines, (line, text)
    assert f"-> array {array.name}" in text


def test_cim_array_demo_prints_the_reference_mechanics():
    _, got = _run(_port("cim_array_demo"), ["--device", "cpu"])
    _, want = _run(ROOT / "examples" / "cim_array_demo.py")
    head = lambda text: text.split("=== sparsity")[0]
    assert head(got) == head(want)
    assert "CiM output = min(a,8)-min(b,8) = 7" in got
    assert "outputs perturbed:" in got


def test_serve_ternary_tokens_equal_generate():
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import generate

    reqs, text = _run(_port("serve_ternary"), ["--device", "cpu"])
    assert "served 10 requests" in text
    cfg = get_config("smollm-135m", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    params = T.init_params(cfg, seed=0, device="cpu")
    for r in reqs:
        assert r.done and len(r.generated) == r.max_new
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=64, device="cpu")
        assert r.generated == want[0].tolist(), r.rid


def test_train_ternary_lm_trains_the_smoke_config(tmp_path):
    log, text = _run(_port("train_ternary_lm"),
                     ["--smoke", "--steps", "3", "--seq", "32", "--batch", "4",
                      "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(torch.isfinite(torch.tensor(m["loss"])) for m in log)
    assert "final loss" in text and "restarts: 0" in text


@pytest.mark.parametrize("name", ["quickstart", "cim_array_demo", "serve_ternary",
                                  "train_ternary_lm"])
def test_examples_import_no_jax(name):
    text = _port(name).read_text()
    assert "import jax" not in text and "from repro " not in text
    assert '"--device", default="cuda"' in text
