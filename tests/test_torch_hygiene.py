"""The port stands alone and runs on CUDA unless asked for the CPU.

* importing ``knpemi_tpu_torch`` (every module of it) loads neither JAX
  nor the JAX package;
* no file of the port, and not ``chip_smoke.py``, names ``knpemi_tpu``
  other than as ``knpemi_tpu_torch`` except in prose about what a
  kernel replaces (``knpemi_tpu/...`` paths in comments and docstrings);
* ``Simulation`` with no device raises when CUDA is absent;
* ``chip_smoke.py`` exits non-zero, printing no result, without CUDA.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "knpemi_tpu_torch"


def test_import_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, knpemi_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'knpemi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'knpemi_tpu' or m.startswith('knpemi_tpu.')]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == ""


def _py_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_package(path):
    """No import statement of the port names jax or knpemi_tpu."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "knpemi_tpu"), f"{path}: imports {n}"


def test_code_names_knpemi_tpu_only_as_the_port():
    """Outside comments and docstrings, 'knpemi_tpu' appears only as
    'knpemi_tpu_torch'."""
    pat = re.compile(r"knpemi_tpu(?!_torch)")
    for path in _py_files():
        src = path.read_text()
        doc_lines = set()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                doc_lines.update(range(node.lineno, node.end_lineno + 1))
        for i, line in enumerate(src.splitlines(), 1):
            code = line.split("#", 1)[0]
            if i not in doc_lines and pat.search(code):
                raise AssertionError(f"{path}:{i}: {line.strip()}")


def test_simulation_without_device_needs_cuda(monkeypatch):
    from knpemi_tpu_torch.mesh import idealized_2d_mesh
    from knpemi_tpu_torch.ops.geometry import build_geometry
    from knpemi_tpu_torch.sim import build_idealized
    from knpemi_tpu_torch.systems.coupling import set_initial_conditions
    from knpemi_tpu_torch.systems.emi import EMISystem
    from knpemi_tpu_torch.systems.knp import KNPSystem
    from knpemi_tpu_torch.systems.types import Ion, PhysicalParams, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_idealized(dim=2, resolution=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    # the public constructors below Simulation follow the same rule
    geom = build_geometry(idealized_2d_mesh(1))
    ions = [Ion("K", 1.0, {0: 1e-9, 1: 1e-9}, {0: 3.0, 1: 120.0}),
            Ion("Na", 1.0, {0: 1e-9, 1: 1e-9}, {0: 100.0, 1: 12.0})]
    params = PhysicalParams(dt=1e-4, rho={0: 0.0, 1: 0.0})
    with pytest.raises(RuntimeError, match="CUDA"):
        set_initial_conditions(geom, ions)
    for cls in (EMISystem, KNPSystem):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(geom, ions, params)
    c = set_initial_conditions(geom, ions, device="cpu")
    assert all(v.device.type == "cpu" for v in c.values())
    assert EMISystem(geom, ions, params, device="cpu").device == torch.device("cpu")


def test_kernel_sources_present():
    from knpemi_tpu_torch.ops import _build

    for name in _build.SOURCES:
        assert (PORT / "ops" / "csrc" / f"{name}.cu").is_file()


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Run where this process has no CUDA (skipped on a machine with it)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the script would run for real")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package beside it
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
