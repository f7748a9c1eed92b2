"""The port's astrocyte driver with checkpoints and ``--resume``, on the CPU.

``knpemi_tpu_torch.drivers.run_stim_duration.solve_system`` at
``mesh_n`` 8, 1.0 ms (10 steps), traces every 2 steps, an XDMF frame
every 2 observer calls, a checkpoint every 4 steps and the EMI hierarchy
refresh off: the configuration of ``tests/test_resume_driver.py``.
Float64, as the driver runs on the CPU.  Asserted:

* a run stopped cleanly at 0.4 ms and resumed, and one resumed from the
  checkpoint before last (``ckpt_prev.npz``, with XDMF frames in the h5
  that postdate it), reproduce the uninterrupted run bit for bit: state,
  traces and every dataset of every series;
* resuming a finished run does nothing;
* the port driver's traces and final fields agree with one run of the
  JAX driver to 1e-9 relative, the tolerance ``tests/test_torch_tissue.py``
  holds the port's per-ion step to against that driver's simulation (the
  port on its per-ion KNP branch, the one the JAX driver takes on the CPU),
  and its XDMF series read back in the JAX package's reader;
* the main-path layout (ion-batched KNP, ``mg_banded=True``) resumes bit
  for bit too; without h5py the driver writes no series, says so, and
  still resumes bit for bit;
* ``python -m knpemi_tpu_torch.drivers.run_stim_duration`` refuses to run
  without CUDA unless asked for the CPU.
"""

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from knpemi_tpu_torch.drivers import run_stim_duration as drv
from knpemi_tpu_torch.sim.config import load_config

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
BASELINE_YML = EX / "astrocyte" / "config_files" / "baseline.yml"


def _config(fname, per_ion=True):
    cfg = load_config(BASELINE_YML)
    cfg.update(mesh_n=8, Tstop=1.0, save_frequency=2, save_frequency_fields=2,
               checkpoint_every=4, fname=fname,
               solver={"mg_refresh_every": 0, "mg_refresh_async": False,
                       "knp_batched": not per_ion})
    return cfg


def _read_series(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as h5:
        for name in h5["Function"]:
            for i in h5[f"Function/{name}"]:
                out[f"{name}/{i}"] = np.asarray(h5[f"Function/{name}/{i}"])
        for i in h5.get("Time", {}):
            out[f"t/{i}"] = float(h5[f"Time/{i}"][()])
    return out


def _assert_same_run(dir_a, dir_b, tr_a, tr_b, st_a, st_b):
    for k in tr_a:
        np.testing.assert_array_equal(np.asarray(tr_a[k]), np.asarray(tr_b[k]), err_msg=k)
    for f in ("c", "phi", "phi_M", "ode_states", "ode_params"):
        for k, v in getattr(st_a, f).items():
            assert torch.equal(v, getattr(st_b, f)[k]), (f, k)
    assert float(st_a.t) == float(st_b.t) and int(st_a.step) == int(st_b.step)
    files = sorted(dir_a.glob("results_sub_*.h5"))
    assert len(files) == 3
    for f in files:
        a, b = _read_series(f), _read_series(dir_b / f.name)
        assert a.keys() == b.keys(), f.name
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name}:{k}")


@pytest.fixture(scope="module")
def gold(tmp_path_factory):
    out = tmp_path_factory.mktemp("driver")
    st, tr, it_e, it_k = drv.solve_system(_config("gold"), verbose=False, outdir=str(out),
                                          device="cpu")
    return out, st, tr, it_e, it_k


def test_uninterrupted_run_writes_its_outputs(gold):
    out, st, tr, it_e, _ = gold
    d = out / "gold"
    assert int(st.step) == 10 and len(it_e) == 10 and st.c[0].dtype == torch.float64
    assert len(tr["t"]) == 5
    for name in ("ckpt.npz", "ckpt_prev.npz", "final_state.npz", "traces.npz",
                 "results_sub_0.xdmf", "results_sub_2.h5"):
        assert (d / name).exists(), name
    # three frames (observer calls 0, 2, 4) per subdomain series
    assert len([k for k in _read_series(d / "results_sub_0.h5") if k.startswith("t/")]) == 3


def test_clean_stop_and_resume_is_bitwise(gold):
    out, st_gold, tr_gold, _, _ = gold
    cfg = _config("split")
    cfg["Tstop"] = 0.4
    drv.solve_system(cfg, verbose=False, outdir=str(out), device="cpu")
    cfg["Tstop"] = 1.0
    st, tr, it_e, _ = drv.solve_system(cfg, verbose=False, outdir=str(out), resume=True,
                                       device="cpu")
    assert len(it_e) == 6
    _assert_same_run(out / "gold", out / "split", tr_gold, tr, st_gold, st)
    # resuming a finished run is a no-op
    st_c, _, it_c, _ = drv.solve_system(cfg, verbose=False, outdir=str(out), resume=True,
                                        device="cpu")
    assert len(it_c) == 0 and int(st_c.step) == 10


def test_crash_resume_from_the_checkpoint_before_last_is_bitwise(gold):
    """Run to 0.8 ms (checkpoints at steps 4 and 8), lose what came after
    step 4 by restoring ckpt_prev: the h5 holds frames past it, which the
    resume cuts."""
    out, st_gold, tr_gold, _, _ = gold
    cfg = _config("crash")
    cfg["Tstop"] = 0.8
    drv.solve_system(cfg, verbose=False, outdir=str(out), device="cpu")
    d = out / "crash"
    shutil.copy(d / "ckpt_prev.npz", d / "ckpt.npz")
    assert len([k for k in _read_series(d / "results_sub_1.h5") if k.startswith("t/")]) == 2
    cfg["Tstop"] = 1.0
    st, tr, it_e, _ = drv.solve_system(cfg, verbose=False, outdir=str(out), resume=True,
                                       device="cpu")
    assert int(st.step) == 10 and len(it_e) == 6
    _assert_same_run(out / "gold", d, tr_gold, tr, st_gold, st)


def test_main_path_layout_resumes_bitwise(tmp_path):
    """The ion-batched KNP branch with mg_banded=True: stopped at 0.4 ms
    and resumed, the same bits as the run that did not stop."""
    def cfg(fname, tstop):
        c = _config(fname, per_ion=False)
        c["solver"]["mg_banded"] = True
        c["Tstop"] = tstop
        return c

    st_a, tr_a, _, _ = drv.solve_system(cfg("gold", 1.0), verbose=False,
                                        outdir=str(tmp_path), device="cpu")
    drv.solve_system(cfg("split", 0.4), verbose=False, outdir=str(tmp_path), device="cpu")
    st_b, tr_b, _, _ = drv.solve_system(cfg("split", 1.0), verbose=False,
                                        outdir=str(tmp_path), resume=True, device="cpu")
    _assert_same_run(tmp_path / "gold", tmp_path / "split", tr_a, tr_b, st_a, st_b)


def test_without_h5py_the_driver_writes_traces_and_checkpoints(monkeypatch, tmp_path, gold):
    """Where h5py is not installed (the GPU machine has none), the driver
    says so, writes no XDMF series, and still resumes bit for bit."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    _, st_gold, tr_gold, _, _ = gold
    cfg = _config("noh5")
    cfg["Tstop"] = 0.4
    with pytest.warns(RuntimeWarning, match="h5py is not installed"):
        drv.solve_system(cfg, verbose=False, outdir=str(tmp_path), device="cpu")
    cfg["Tstop"] = 1.0
    with pytest.warns(RuntimeWarning, match="h5py is not installed"):
        st, tr, _, _ = drv.solve_system(cfg, verbose=False, outdir=str(tmp_path),
                                        resume=True, device="cpu")
    d = tmp_path / "noh5"
    assert not list(d.glob("*.h5")) and (d / "ckpt.npz").exists()
    for k in tr_gold:
        np.testing.assert_array_equal(tr[k], tr_gold[k], err_msg=k)
    for f in ("c", "phi", "phi_M", "ode_states"):
        for k, v in getattr(st_gold, f).items():
            assert torch.equal(v, getattr(st, f)[k]), (f, k)


def _jax_driver():
    name = "astro_driver_for_port"
    spec = importlib.util.spec_from_file_location(
        name, EX / "astrocyte" / "run_stim_duration.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_traces_match_the_jax_driver(gold, tmp_path):
    import jax

    from knpemi_tpu.io import TimeSeriesReader

    out, st, tr, it_e, it_k = gold
    cfg = _config("jax")
    cfg["solver"] = {"mg_refresh_every": 0, "mg_refresh_async": False}
    stJ, trJ, it_eJ, it_kJ = _jax_driver().solve_system(cfg, verbose=False,
                                                        outdir=str(tmp_path))
    sJ = jax.device_get(stJ)
    np.testing.assert_array_equal(it_e, np.asarray(it_eJ))
    np.testing.assert_array_equal(it_k, np.asarray(it_kJ))
    np.testing.assert_array_equal(tr["t"], trJ["t"])
    for k in drv.TRACE_KEYS[1:]:
        np.testing.assert_allclose(tr[k], trJ[k], rtol=1e-9, atol=0, err_msg=k)
    for m in sJ.phi_M:
        np.testing.assert_allclose(st.phi_M[m].numpy(), np.asarray(sJ.phi_M[m]),
                                   rtol=1e-9, atol=0)
    for t in sJ.c:
        np.testing.assert_allclose(st.c[t].numpy(), np.asarray(sJ.c[t]), rtol=1e-9, atol=0)
    # the port's series in the JAX package's reader, frame for frame
    for tag in (0, 1, 2):
        with TimeSeriesReader(out / "gold" / f"results_sub_{tag}.xdmf") as rp, \
                TimeSeriesReader(tmp_path / "jax" / f"results_sub_{tag}.xdmf") as rj:
            assert rp.times == rj.times and rp.fields == rj.fields
            for name in rp.fields:
                np.testing.assert_allclose(rp.series(name), rj.series(name), rtol=1e-9,
                                           atol=1e-9 * np.abs(rj.series(name)).max())


def test_module_entry_point_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cmd = [sys.executable, "-m", "knpemi_tpu_torch.drivers.run_stim_duration",
           "-c", "baseline", "--outdir", str(tmp_path), "--Tstop", "0.1"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "CUDA is not available" in res.stderr
    assert not (tmp_path / "baseline").exists()
