"""metrics_tpu_torch stands alone: no JAX, nothing of metrics_tpu, CUDA by default.

- importing the package (and every module of it) in a fresh interpreter loads
  neither ``jax`` nor any ``metrics_tpu`` module;
- no file of the package, nor ``chip_smoke.py`` and the ``scripts/torch_*.py``
  profilers, imports them (AST scan);
- a ``Metric`` built without ``device=`` raises where CUDA is absent, and so does a
  functional entry point given a numpy input;
- the kernel modules import, and a CPU run goes by the plain versions, without
  ``nvcc``: the launch counts stay 0.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "metrics_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted((REPO / "scripts").glob("torch_*.py"))


def _module_names():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_loads_no_jax_and_no_metrics_tpu():
    code = (
        "import importlib, sys\n"
        f"for name in {list(_module_names())!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'metrics_tpu' or m.startswith('metrics_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_metrics_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "metrics_tpu"), f"{path.name}:{node.lineno} imports {name}"


def test_metric_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch.classification import MulticlassAccuracy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MulticlassAccuracy(num_classes=3)


def test_functional_numpy_input_goes_to_cuda_by_default(monkeypatch):
    from metrics_tpu_torch.functional.classification import binary_auroc, multiclass_accuracy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multiclass_accuracy(np.array([0, 1]), np.array([0, 1]), num_classes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        binary_auroc(np.array([0.2, 0.7], np.float32), np.array([0, 1]))


def test_curve_metric_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAveragePrecision

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (BinaryAUROC, lambda: MulticlassAveragePrecision(num_classes=3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_cpu_run_imports_the_kernel_module_without_nvcc():
    code = (
        "import numpy as np\n"
        "from metrics_tpu_torch.ops import histogram, segment\n"
        "from metrics_tpu_torch.classification import BinaryAUROC, MulticlassJaccardIndex\n"
        "m = MulticlassJaccardIndex(num_classes=19, ignore_index=255, device='cpu')\n"
        "rng = np.random.RandomState(0)\n"
        "t = rng.randint(0, 19, (2, 8, 8)); t[0, 0] = 255\n"
        "m.update(rng.randn(2, 19, 8, 8).astype(np.float32), t)\n"
        "m.compute()\n"
        "a = BinaryAUROC(device='cpu')\n"
        "a.update(rng.rand(64).astype(np.float32), rng.randint(0, 2, 64))\n"
        "assert 0.0 <= float(a.compute()) <= 1.0\n"
        "assert histogram.histogram_cuda.launches == 0 and segment.segment_scan_cuda.launches == 0\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": os.environ.get("HOME", "/tmp")}
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"
