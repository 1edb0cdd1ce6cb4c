"""The PyTorch port stands alone: no module of picotron_tpu_torch/ and not
chip_smoke.py imports jax or the JAX package, importing the port leaves jax
unloaded, and entry points without a CPU request refuse to run when CUDA
is absent instead of falling back."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "picotron_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "picotron_tpu" or name.startswith("picotron_tpu."))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("chip_smoke.py", "picotron_tpu_torch/ops/flash_attention.py",
                 "picotron_tpu_torch/kernels/build.py",
                 "picotron_tpu_torch/train.py",
                 "picotron_tpu_torch/generate.py",
                 "picotron_tpu_torch/serve/engine.py",
                 "picotron_tpu_torch/serve/disagg.py",
                 "picotron_tpu_torch/serve/fleet.py",
                 "picotron_tpu_torch/tools/serve_bench.py",
                 "picotron_tpu_torch/ops/moe.py",
                 "picotron_tpu_torch/parallel/ep.py",
                 "picotron_tpu_torch/telemetry/__init__.py",
                 "picotron_tpu_torch/resilience/chaos.py",
                 "picotron_tpu_torch/telemetry/flightdeck/__init__.py",
                 "picotron_tpu_torch/native.py",
                 "picotron_tpu_torch/tools/telemetry_report.py",
                 "picotron_tpu_torch/tools/trace_export.py",
                 "picotron_tpu_torch/parallel/tp_strategies.py",
                 "picotron_tpu_torch/parallel/hier_reduce.py",
                 "picotron_tpu_torch/models/act_offload.py",
                 "picotron_tpu_torch/analysis/cost_model.py",
                 "picotron_tpu_torch/analysis/calibration.py",
                 "picotron_tpu_torch/analysis/planner.py",
                 "picotron_tpu_torch/tools/layout_planner.py",
                 "picotron_tpu_torch/tools/submit_jobs.py",
                 "picotron_tpu_torch/tools/data_bench.py"):
        assert want in names
    assert (ROOT / "picotron_tpu_torch/csrc/flash_attention.cu").exists()
    assert (ROOT / "picotron_tpu_torch/csrc/packer.cpp").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, picotron_tpu_torch, picotron_tpu_torch.train, "
            "picotron_tpu_torch.weights, picotron_tpu_torch.ops.flash_attention"
            ", picotron_tpu_torch.generate, picotron_tpu_torch.serve, "
            "picotron_tpu_torch.serve.spec_decode, picotron_tpu_torch.telemetry"
            ", picotron_tpu_torch.native, picotron_tpu_torch.data, "
            "picotron_tpu_torch.resilience.chaos, "
            "picotron_tpu_torch.telemetry.flightdeck, "
            "picotron_tpu_torch.tools.telemetry_report, "
            "picotron_tpu_torch.tools.trace_export, "
            "picotron_tpu_torch.serve.disagg, picotron_tpu_torch.serve.fleet"
            ", picotron_tpu_torch.tools.serve_bench, "
            "picotron_tpu_torch.tools.chaos, "
            "picotron_tpu_torch.parallel.tp_strategies, "
            "picotron_tpu_torch.parallel.hier_reduce, "
            "picotron_tpu_torch.models.act_offload, "
            "picotron_tpu_torch.analysis, "
            "picotron_tpu_torch.tools.layout_planner, "
            "picotron_tpu_torch.tools.submit_jobs, "
            "picotron_tpu_torch.tools.data_bench"
            "\nbad = [m for m in sys.modules if m == 'jax' or m.startswith"
            "('jax.') or m == 'picotron_tpu' or m.startswith('picotron_tpu.')"
            " or m in ('datasets', 'transformers')]"
            "\nassert not bad, bad\nimport torch"
            "\nassert not torch.backends.cuda.matmul.allow_tf32"
            "\nassert not torch.backends.cudnn.allow_tf32\nprint('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_builds_nothing():
    from picotron_tpu_torch.kernels import build

    assert build.BUILD_LOGS == {}


def test_entry_point_without_cpu_request_raises_when_cuda_absent(monkeypatch):
    from picotron_tpu_torch import config, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.config_from_dict({"model": {"name": "debug-tiny"},
                                   "training": {"remat": False}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.resolve_device(cfg, "cuda")
    assert train.resolve_device(cfg, "cpu").type == "cpu"
    cpu_cfg = config.config_from_dict({"distributed": {"use_cpu": True}})
    assert train.resolve_device(cpu_cfg).type == "cpu"


def test_generation_and_serving_refuse_without_cuda(monkeypatch):
    """`python -m picotron_tpu_torch.generate` and `.tools.serve_bench`
    without --device cpu, and a ServeEngine, DisaggServeEngine or
    FleetSupervisor without device="cpu", refuse when CUDA is absent;
    none falls back to the CPU."""
    from picotron_tpu_torch import config, generate
    from picotron_tpu_torch.models.llama import LlamaModel
    from picotron_tpu_torch.serve import (
        DisaggServeEngine, FleetSupervisor, ServeEngine,
    )
    from picotron_tpu_torch.tools import serve_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--hf-dir", "unused", "--model", "debug-tiny",
                       "--prompt-ids", "1,2"])
    cfg = config.config_from_dict({"model": {"name": "debug-tiny"}}).model
    model = LlamaModel(cfg, device="cpu")
    for cls in (ServeEngine, DisaggServeEngine, FleetSupervisor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_bench.main(["--fleet", "1", "--model", "debug-tiny"])
    assert ServeEngine(model, device="cpu").device.type == "cpu"
    assert DisaggServeEngine(model, device="cpu").device_p.type == "cpu"


def test_peak_flops_refuses_to_guess(monkeypatch):
    from picotron_tpu_torch import utils

    with pytest.raises(ValueError):
        utils.device_peak_flops("cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "A100")
    with pytest.raises(ValueError, match="unknown card"):
        utils.device_peak_flops("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert utils.device_peak_flops("cuda") == 989.5e12
