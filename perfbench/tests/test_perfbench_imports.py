"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

from perfbench import bench, spec

PB = spec.ROOT / "perfbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_in_sources():
    for path in PB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        bad = set(_imports(path)) & set(bench.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        assert "knpemi_tpu_torch" not in set(_imports(path)), path
        assert not set(_imports(path)) & set(bench.FORBIDDEN), path


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from perfbench.tests import tiny\n"
            "r = tiny.run('box3d_l4.stim', seconds=0.5)\n"
            "from perfbench import bench\n"
            "print(bench.forbidden_modules(), sorted(m for m in sys.modules if m.split('.')[0] == 'knpemi_tpu'))\n"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_the_prefix_is_not_the_package():
    """knpemi_tpu_torch begins with knpemi_tpu: only whole names count."""
    sys.modules.setdefault("knpemi_tpu_torch_probe", sys)
    try:
        assert "knpemi_tpu" not in bench.forbidden_modules()
    finally:
        del sys.modules["knpemi_tpu_torch_probe"]
