"""The port stands alone and runs on CUDA unless asked for the CPU.

* importing ``knpemi_tpu_torch`` (every module of it) loads neither JAX
  nor the JAX package;
* no file of the port, and not ``chip_smoke.py``, names ``knpemi_tpu``
  other than as ``knpemi_tpu_torch`` except in prose about what a
  kernel replaces (``knpemi_tpu/...`` paths in comments and docstrings);
* ``Simulation``, ``build_idealized`` and ``build_astrocyte`` with no
  device raise when CUDA is absent, as do the MMS systems
  (``systems/mms.py``, ``emi_system`` / ``knp_system`` with ``mms``) and
  simulations built with the direct, deflated-Jacobi or multigrid
  options, the MMS ladder tool (``tools/run_mms_ladder.py``) and the
  verification tools (``tools/compare_solver_opts.py``,
  ``tools/stress_mg_refresh.py``);
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
    from knpemi_tpu_torch.ops.p1op import membrane_operators, p1_operators
    from knpemi_tpu_torch.sim import build_idealized
    from knpemi_tpu_torch.systems.coupling import set_initial_conditions
    from knpemi_tpu_torch.systems.emi import EMISystem
    from knpemi_tpu_torch.systems.knp import KNPSystem
    from knpemi_tpu_torch.systems.types import Ion, PhysicalParams, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_idealized(dim=2, resolution=1)
    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, build_astrocyte

    small = {**ASTROCYTE_BASELINE, "mesh_n": 10}
    with pytest.raises(RuntimeError, match="CUDA"):
        build_astrocyte(small)
    assert build_astrocyte(small, device="cpu").device == torch.device("cpu")
    # a mesh file is read (io.read_mesh), not ignored: a missing one raises
    with pytest.raises(OSError):
        build_astrocyte({**small, "mesh_file": "no-such-tissue.xdmf"}, device="cpu")
    from knpemi_tpu_torch.drivers.run_stim_duration import build_simulation

    with pytest.raises(RuntimeError, match="CUDA"):
        build_simulation(small)
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
    p1ops, memops = p1_operators(geom, "cpu"), membrane_operators(geom, "cpu")
    # (KNPSystem also takes the EMI system's unit stiffness values)
    for cls, kw in ((EMISystem, {}), (KNPSystem, {"kst": {}})):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(geom, ions, params, p1ops=p1ops, memops=memops, **kw)
    c = set_initial_conditions(geom, ions, device="cpu")
    assert all(v.device.type == "cpu" for v in c.values())
    assert EMISystem(geom, ions, params, device="cpu", p1ops=p1ops,
                     memops=memops).device == torch.device("cpu")


def test_mms_and_solver_entry_points_need_cuda(monkeypatch):
    """The MMS systems, the solver front-ends' direct and deflated-Jacobi
    paths and the option-built simulations follow the device rule: no
    device means CUDA, which raises without it."""
    from knpemi_tpu_torch.mesh import unit_square_mms_mesh
    from knpemi_tpu_torch.ops.geometry import build_geometry
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized
    from knpemi_tpu_torch.systems import mms
    from knpemi_tpu_torch.systems.emi import emi_system
    from knpemi_tpu_torch.systems.knp import knp_system

    geom = build_geometry(unit_square_mms_mesh(4))
    case = mms.reference_mms_case(geom)
    ions, ed, kd = mms.build_mms_data(geom, case)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make, data in ((emi_system, ed), (knp_system, kd)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(geom, ions, case.params, mms=data)
        assert make(geom, ions, case.params, mms=data, device="cpu").device.type == "cpu"
    for opts in (dict(direct=True), dict(emi_precond="jacobi"),
                 dict(mg_smoother="cheby", mg_nu=2, knp_post_smooth=False)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_idealized(dim=2, resolution=1, solver_options=SolverOptions(**opts))
    # the MMS ladder tool runs on the card unless asked for the CPU
    from knpemi_tpu_torch.tools import run_mms_ladder

    for iterative in (True, False):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_mms_ladder.ladder_rung(4, iterative)


def test_verification_tools_need_cuda(monkeypatch):
    """``compare_solver_opts`` and ``stress_mg_refresh`` build on the card
    unless asked for the CPU: their builds and their ``main`` without
    ``--device`` raise where CUDA is absent."""
    from knpemi_tpu_torch.drivers.run_stim_duration import CONFIG_DIR
    from knpemi_tpu_torch.sim.config import load_config
    from knpemi_tpu_torch.tools import compare_solver_opts, stress_mg_refresh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {**load_config(CONFIG_DIR / "baseline.yml"), "mesh_n": 8}
    with pytest.raises(RuntimeError, match="CUDA"):
        compare_solver_opts.build(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        stress_mg_refresh.stress(cfg, 2, 1, 1)
    for tool in (compare_solver_opts, stress_mg_refresh):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(["--mesh-n", "8", "--steps", "2", "--chunk", "1"])
    assert compare_solver_opts.build(8, device="cpu").device == torch.device("cpu")


def test_kernel_sources_present():
    from knpemi_tpu_torch.ops import _build, assembly

    assert set(_build.SOURCES) == {"cells", "facets", "mg"}
    for name in _build.SOURCES:
        assert (PORT / "ops" / "csrc" / f"{name}.cu").is_file()
    # every C entry point a wrapper names is defined in its source
    for kernel, (lib, symbol, _) in assembly._SIGS.items():
        assert lib in _build.SOURCES, kernel
        src = (PORT / "ops" / "csrc" / f"{lib}.cu").read_text()
        assert re.search(rf"\bint {symbol}\(", src), f"{symbol} not in {lib}.cu"


# the twelve TPU kernels' counterparts, and the fills of K1 and K11
KERNELS = ["K1", "K1f", "K2", "K3", "K4", "K5", "K6a", "K6b", "K7", "K8", "K9", "K10",
           "K11", "K11f"]


def test_every_wrapper_has_a_plain_twin_and_a_launch_counter():
    import knpemi_tpu_torch.ops as ops

    table = ops.kernel_table()
    assert sorted(n.split()[0] for n in table) == sorted(KERNELS)
    for name, (wrapper, plain) in table.items():
        assert plain.__name__ == wrapper.__name__ + "_plain", name
        assert sys.modules[plain.__module__] is sys.modules[wrapper.__module__]
        assert isinstance(wrapper.launches, int), name
        assert "Replaces ``knpemi_tpu/ops/pallas_" in wrapper.__doc__, name
        assert "Bound on the H100" in wrapper.__doc__, name


def test_k11_is_its_own_kernel_with_its_own_launch():
    """K11's wrapper launches the P1 operator's apply with two value
    streams, its scalar by value; the apply's source has its own
    __global__ function, and K3's kernel is not on its way; on a CUDA
    tensor it reaches neither K3 nor the plain version."""
    from knpemi_tpu_torch.ops import assembly

    lib, symbol, argtypes = assembly._SIGS["p1_apply"]
    assert (lib, symbol) == ("cells", "knp_p1_apply")
    assert sum(a is assembly.ctypes.c_double for a in argtypes) == 2
    src = (PORT / "ops" / "csrc" / "cells.cu").read_text()
    assert re.search(r"__global__ void p1_apply_kernel\(", src)
    body = src[src.index("int p1_apply_t("):src.index("}  // namespace")]
    body = body[:body.index("template <typename T>")]
    assert "p1_apply_kernel<T, true><<<" in body and "p1_apply_kernel<T, false><<<" in body
    assert "knp_apply_batch_kernel" not in body
    tree = ast.parse((PORT / "ops" / "p1op.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "knp_apply")
    called = [c.func.id for c in ast.walk(fn)
              if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)]
    assert "knp_apply_batch" not in called and called.count("knp_apply_plain") == 1
    assert called.count("_launch_apply") == 1
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    # the one call of the plain version sits under `if not x.is_cuda:`
    guard = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                 and any(isinstance(c, ast.Call) and getattr(c.func, "id", "") ==
                         "knp_apply_plain" for c in ast.walk(n)))
    assert ast.unparse(guard.test) == "not x.is_cuda"
    # the matrix-free cell kernels of K1 and K11 are gone
    assert "emi_stiffness_kernel" not in src and "knp_apply_kernel" not in src


def test_k3_and_k6a_are_the_sliced_applies():
    """K3 is the P1 operator's batched apply (its own entry point and
    __global__ function in cells.cu; the one-thread-per-cell kernel with
    atomics is gone), K6a the sliced-ELL gather (the row-major batched
    gather is gone from mg.cu); each wrapper reaches its plain version
    only under ``if not X.is_cuda:``."""
    from knpemi_tpu_torch.ops import assembly, ell, p1op

    cells = (PORT / "ops" / "csrc" / "cells.cu").read_text()
    mg = (PORT / "ops" / "csrc" / "mg.cu").read_text()
    assert assembly._SIGS["p1_apply_batch"][:2] == ("cells", "knp_p1_apply_batch")
    assert assembly._SIGS["sliced_matvec_batch"][:2] == ("mg", "knp_sliced_matvec_batch")
    assert "knp_apply_batch" not in assembly._SIGS and "ell_matvec_batch" not in assembly._SIGS
    assert re.search(r"__global__ void __launch_bounds__\(kThreads\)\s+p1_apply_batch_kernel\(",
                     cells)
    assert re.search(r"sliced_matvec_batch_kernel\(", mg)
    assert "knp_apply_batch_kernel" not in cells and "atomicAdd(&y[v[i]]" not in cells
    assert "ell_matvec_batch_kernel" not in mg
    for mod, name in ((p1op, "knp_apply_batch"), (ell, "ellw_matvec_batch")):
        tree = ast.parse(Path(mod.__file__).read_text())
        fn = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == name)
        guard = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                     and any(isinstance(c, ast.Call) and getattr(c.func, "id", "") ==
                             name + "_plain" for c in ast.walk(n)))
        assert ast.unparse(guard.test) == "not X.is_cuda"


def test_k4_is_the_sliced_gather_and_k9_the_vectorised_copy():
    """K4 has one kernel, on the sliced form (mg.cu), and one wrapper; the
    row-major ELL kernel and form are gone from the port, and
    ``DeviceELLW`` holds no row-major form.  K9 reads its index map with
    16-byte loads, stores 16 bytes a channel and divides nothing; each
    wrapper reaches its plain version only under ``if not x.is_cuda:``
    (``X`` for K9)."""
    import dataclasses

    from knpemi_tpu_torch.ops import assembly, ell

    srcs = {p.name: p.read_text() for p in (PORT / "ops" / "csrc").glob("*.cu")}
    py = "".join(p.read_text() for p in PORT.rglob("*.py"))
    for text in (*srcs.values(), py):
        assert "ell_matvec_kernel" not in text and "row_major" not in text
    assert assembly._SIGS["sliced_matvec"][:2] == ("mg", "knp_sliced_matvec")
    assert "ell_matvec" not in assembly._SIGS
    assert {f.name for f in dataclasses.fields(ell.DeviceELLW)}.isdisjoint({"cols", "vals"})
    assert re.search(r"__global__ void __launch_bounds__\(kThreads\)\s+sliced_matvec_kernel\(",
                     srcs["mg.cu"])
    fac = srcs["facets.cu"]
    body = fac[fac.index("facet_gather_kernel("):fac.index("int facet_gather_t(")]
    assert "int4" in body and "float4" in fac and "double2" in fac
    assert "/" not in body.replace("//", "") and "%" not in body
    for mod, name, arg in ((ell, "ellw_matvec", "x"), (assembly, "facet_gather", "X")):
        tree = ast.parse(Path(mod.__file__).read_text())
        fn = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == name)
        guard = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                     and any(isinstance(c, ast.Call) and getattr(c.func, "id", "") ==
                             name + "_plain" for c in ast.walk(n)))
        assert ast.unparse(guard.test) == f"not {arg}.is_cuda"


@pytest.mark.parametrize("module", ["ell", "banded", "assembly", "p1op"])
def test_kernel_wrappers_call_no_library_product_and_never_fall_back(module):
    """On CUDA a wrapper launches or raises: outside its ``_plain`` twins a
    module of wrappers calls no PyTorch product or scatter, is not
    compiled by torch.compile and has no try around a launch."""
    tree = ast.parse((PORT / "ops" / f"{module}.py").read_text())
    banned = {"matmul", "bmm", "mm", "mv", "einsum", "index_add_", "index_add",
              "scatter_add_", "scatter_add", "compile"}
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name.endswith("_plain") \
                or fn.name in ("_windows", "_ell_from_cells"):
            continue
        for node in ast.walk(fn):
            assert not isinstance(node, ast.Try), f"{module}.{fn.name}: try"
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                assert node.func.attr not in banned, f"{module}.{fn.name}: {node.func.attr}"


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


def test_drivers_and_the_two_cell_scenario_need_cuda(monkeypatch):
    """``build_two_cell`` and every driver's build (``run_benchmark``,
    ``run_2d``, ``run_3d``; ``run_calibration.run``) with no device mean
    CUDA, which raises without it; with ``device="cpu"`` they build there,
    in float64; the drivers' modules import neither JAX nor the JAX
    package (``test_no_import_of_jax_package`` reads them too)."""
    from knpemi_tpu_torch.drivers import run_2d, run_3d, run_benchmark, run_calibration
    from knpemi_tpu_torch.sim import build_two_cell

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builds = (build_two_cell, run_benchmark.build_simulation, run_2d.build_simulation,
              run_3d.build_simulation)
    for build in builds:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_calibration.run(n_steps=1, verbose=False)
    for build in builds[1:]:
        sim = build(device="cpu")
        assert sim.device == torch.device("cpu") and sim.dtype == torch.float64
    assert build_two_cell(device="cpu").device == torch.device("cpu")
    for mod in (run_2d, run_3d, run_benchmark, run_calibration):
        assert Path(mod.__file__).parent == PORT / "drivers"


def test_new_host_modules_are_in_the_port():
    """The native toolkit's source and the utilities ship in the package;
    the toolkit is built at first use, not at import."""
    from knpemi_tpu_torch.utils import critical, logging, native

    assert (PORT / "utils" / "csrc" / "host_toolkit.cpp").is_file()
    assert native.BUILD_DIR == PORT / "build"
    out = subprocess.run(
        [sys.executable, "-c", "import knpemi_tpu_torch.sim, knpemi_tpu_torch.utils.native "
         "as n; print(n._LIB is None)"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout.strip()
    assert out == "True"
    assert callable(critical.critical_section) and callable(logging.Timer)
    src = (PORT / "utils" / "native.py").read_text()
    assert "except" not in src.split("def vanek_aggregate", 1)[1]  # no fallback


@pytest.mark.parametrize("module", ["comm", "spmd", "sharded", "sharded_mg", "programs"])
def test_parallel_modules_never_fall_back(module):
    """The multi-device modes raise where they cannot run (a hierarchy
    level without a banded layout, an option not ported to them, NCCL
    with fewer cards than ranks): no module of ``parallel/`` has a try
    around a launch or a build.  ``comm.py``'s only try blocks supervise
    the rank processes: a rank reports any exception to ``launch``, which
    raises it; ``launch`` polls its queue."""
    tree = ast.parse((PORT / "parallel" / f"{module}.py").read_text())
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try) or not node.handlers:
                continue
            assert module == "comm", f"{module}.{fn.name}: try"
            caught = {ast.unparse(h.type) for h in node.handlers}
            assert (fn.name, caught) in (("_rank_main", {"BaseException"}),
                                         ("launch", {"queue.Empty"})), (fn.name, caught)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and ast.unparse(node.func).endswith("warn"):
                raise AssertionError(f"{module}.{fn.name}: warns")


def test_parallel_launch_and_comm_need_cuda_without_device(monkeypatch):
    """The multi-device modes follow the device rule: ``launch`` and
    ``Comm`` with no device mean CUDA, which raises without it."""
    from knpemi_tpu_torch.parallel import Comm, launch, programs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(programs.wait, 2, "gloo", None, args=(0,))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(programs.wait, 2, "gloo", "cuda", args=(0,))
    with pytest.raises(RuntimeError, match="CUDA"):
        Comm(0, 1, "gloo", None)
    # a Comm belongs to a rank of a process group, even one rank alone
    for world in (1, 2):
        with pytest.raises(ValueError, match="process group"):
            Comm(0, world, "gloo", "cpu")
    assert launch(_rank_device, 1, "gloo", "cpu", threads=1, deadline=120) == ["cpu"]


def _rank_device(comm):
    return str(comm.device)


def test_parallel_simulations_take_the_rank_device():
    """``SpmdSimulation`` and ``ShardedSimulation`` run on the rank's device
    (``comm.device``): a simulation built elsewhere, or none on rank 0,
    raises.  Checked on one gloo rank on the CPU."""
    from knpemi_tpu_torch.parallel import launch

    assert launch(_simulations_on_the_rank_device, 1, "gloo", "cpu", threads=1,
                  deadline=300) == [True]


def _simulations_on_the_rank_device(comm):
    """The checks of ``test_parallel_simulations_take_the_rank_device``, on
    a launched rank (a failed check fails the launch, naming the rank)."""
    from knpemi_tpu_torch.parallel import ShardedSimulation, SpmdSimulation
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    with pytest.raises(ValueError, match="rank 0 must pass"):
        ShardedSimulation(comm, None)
    with pytest.raises(ValueError, match="multigrid"):
        SpmdSimulation(comm, build_idealized(dim=2, resolution=1, device="cpu",
                                             solver_options=SolverOptions(direct=True)))
    sim = build_idealized(dim=2, resolution=1, device="cpu")
    assert SpmdSimulation(comm, sim).sim.device == comm.device
    other = build_idealized(dim=2, resolution=1, device="cpu")
    other.device = torch.device("meta")  # stands for a simulation on another device
    with pytest.raises(ValueError, match="the simulation is on meta"):
        SpmdSimulation(comm, other)
    ssim = ShardedSimulation(comm, sim, distributed_mg=False)
    s = ssim.step(ssim.init_state())
    assert all(v.device == comm.device for v in s.c.values())
    return True