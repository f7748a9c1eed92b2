"""ctypes bindings of the port's native host toolkit (``csrc/host_toolkit.cpp``).

Counterpart of ``knpemi_tpu/utils/native.py``: host graph work that a
Python loop makes slow at scale, here the Vanek aggregation sweep of the
multigrid set-up (``solvers/mg.py``), an O(n) interpreted loop in
Python.  The source is compiled by ``g++`` at first use into
``knpemi_tpu_torch/build/`` (git-ignored), under a file name that
carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one loaded as it is.

Unlike the JAX package, which falls back to its Python sweep when the
library cannot be built, the port raises, with the compiler's output:
the sweep a build runs is always this one.  Its Python twin,
``solvers/mg.py::vanek_aggregate_plain``, is for tests only.

Not ported: ``facet_cells_fill`` of the JAX package's toolkit, which no
code of either package calls (the mesh's facet table is a numpy sort,
``mesh/core.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_SRC = Path(__file__).resolve().parent / "csrc" / "host_toolkit.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

_LIB: Optional[ctypes.CDLL] = None
# seconds spent in the native sweep since the process started
sweep_seconds = 0.0


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libhost_toolkit-{h}.so"


def build() -> Path:
    """Compile the toolkit unless its library is there; raises with the
    compiler's output if the compiler is missing or the build fails."""
    out = _target()
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"the C++ compiler {CXX!r} was not found: the native host "
                           "toolkit (utils/csrc/host_toolkit.cpp) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build {_SRC.name}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded toolkit, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.vanek_aggregate.restype = ctypes.c_int64
        lib.vanek_aggregate.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
        ]
        _LIB = lib
    return _LIB


def vanek_aggregate(indptr: np.ndarray, indices: np.ndarray, n: int):
    """Vanek root-node aggregation (phases 1-3) of the CSR graph
    (``indptr``, ``indices``) of ``n`` rows: (agg int64 (n,), count)."""
    global sweep_seconds
    lib = load()
    t0 = time.perf_counter()
    agg = np.empty(n, dtype=np.int64)
    nc = lib.vanek_aggregate(
        n,
        np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int32),
        agg,
    )
    sweep_seconds += time.perf_counter() - t0
    return agg, int(nc)
