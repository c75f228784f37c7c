"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points never fall back to the CPU silently."""
import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the card-only tests run where JAX is not installed, so they are held to
# the same rule
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples" / "torch").glob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "torch_tp_ranks.py", ROOT / "tests" / "torch_threads.py",
    ROOT / "tests" / "torch_dp_ranks.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"execution.py", "engine.py", "chip_smoke.py", "_build.py",
            "starcoder2_7b.py", "starcoder2_15b.py", "yi_34b.py", "ssm.py",
            "mamba2_780m.py", "zamba2_2_7b.py", "moe.py", "deepseek_v2_236b.py",
            "grok_1_314b.py", "whisper_large_v3.py", "llava_next_34b.py",
            "adamw.py", "trainer.py", "checkpoint.py", "pipeline.py",
            "trace.py", "protocol.py", "slo.py", "client.py", "worker.py",
            "router.py", "server.py", "registry.py", "array.py", "macro.py",
            "dnn_suite.py", "workload.py", "cost_model.py", "accelerator.py",
            "site_cim.py", "calibrate.py", "replay.py", "sharding.py",
            "collectives.py", "mesh.py", "torch_tp_ranks.py", "contracts.py",
            "op_audit.py", "lint.py", "report.py", "ops.py", "tp_replica.py",
            "op_analysis.py", "roofline.py", "dryrun.py", "hillclimb.py",
            "quickstart.py", "cim_array_demo.py", "serve_ternary.py",
            "train_ternary_lm.py"} <= names
    assert ROOT / "src" / "repro_torch" / "hw" / "registry.py" in PORT_FILES
    dirs = {p.parent.name for p in PORT_FILES}
    assert {"profile", "frontdoor", "hw", "dist", "analysis", "launch", "torch"} <= dirs


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import ContinuousBatcher, generate

    cfg = get_config("smollm-135m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"embed": np.zeros((2, 2), np.float32)}, cfg)
    for arch in ("mamba2-780m", "deepseek-v2-236b", "grok-1-314b"):
        other = get_config(arch, smoke=True)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.init_params(other)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.init_caches(other, 1, 8)
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatcher(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(params, [[1, 2]], cfg, max_new=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--requests", "1"])
    # the front door's TP route raises before any rank process starts
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--serve-http", "--tp", "2", "--selftest"])


@pytest.mark.parametrize("script,argv", [
    ("quickstart", []), ("cim_array_demo", []), ("serve_ternary", []),
    ("train_ternary_lm", ["--smoke", "--steps", "1"])])
def test_examples_default_to_the_card(no_cuda, script, argv):
    """The examples/torch twins run on cuda unless asked for the CPU."""
    import importlib.util

    path = ROOT / "examples" / "torch" / f"{script}.py"
    spec = importlib.util.spec_from_file_location(f"example_{script}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_serve_cli_runs_on_cpu_when_asked(no_cuda, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--s-max", "16", "--max-new", "3"]) == 0
    assert "tok/s on cpu" in capsys.readouterr().out


def test_kernel_wrappers_take_cpu_tensors_to_their_plain_version():
    from repro_torch.kernels import ternary_mac as tm

    x = torch.ones((2, 16), dtype=torch.int8)
    before = tm.ternary_cim_matmul.launches
    out = tm.ternary_cim_matmul(x, torch.ones((16, 3), dtype=torch.int8))
    assert torch.equal(out, torch.full((2, 3), 8.0))  # 16 events clamp to 8
    assert tm.ternary_cim_matmul.launches == before
