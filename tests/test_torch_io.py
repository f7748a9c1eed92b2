"""The port's I/O against the JAX package's, and ``Simulation.run``'s hooks.

Float64 (the JAX side as ``tests/test_io.py`` runs it, x64 on through
``tests/conftest.py``).  Held here:

* XDMF meshes (the 2-D MMS and 3-D idealized meshes of ``test_io.py``)
  written by either package read back equal in both; a hexahedral file
  (``tests/test_hex_ingestion.py``'s layout) and a synthetic emimesh
  (``tests/test_emimesh_ingestion.py``'s), read and remarked by both:
  ``Mesh`` and ``build_geometry`` arrays equal;
* time series written by either package, cut by a resume
  (``resume_at``), hold the same datasets and read in the other's
  reader; ``locate_points`` / ``evaluate_p1`` equal to the JAX package's;
* npz checkpoints: either package loads the other's, field for field
  bitwise; a port run resumed from its checkpoint equals the
  uninterrupted one bit for bit, for both multigrid layouts; a JAX
  checkpoint after 5 steps of its XLA path, resumed in the port for 5
  steps, agrees with JAX's own 5 to the tolerances of
  ``tests/test_torch_slice_xla.py`` (iterations equal, phi_M 1e-12
  absolute, c 1e-12 relative);
* ``run``: ``checkpoint_cb`` called after the same steps as the JAX
  package's for a ``save_every`` that does not divide
  ``checkpoint_every``, with the observer's host copy; ``on_divergence``
  'raise', 'warn' and 'ignore' with ``maxiter`` too small to converge.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knpemi_tpu.io as jio
import knpemi_tpu.mesh as jmesh
from knpemi_tpu.ops.geometry import build_geometry as jbuild

import knpemi_tpu_torch.io as tio
import knpemi_tpu_torch.mesh as tmesh
from knpemi_tpu_torch.ops.geometry import build_geometry as tbuild
from knpemi_tpu_torch.sim import SolverOptions, build_idealized

from test_emimesh_ingestion import _synthetic_emimesh
from test_hex_ingestion import _hex_box, _write_hex_xdmf
from test_torch_slice import jax_simulation

MESH_FIELDS = ("points", "cells", "cell_tags", "facet_tags")
STATE_DICTS = ("c", "phi", "phi_M", "ode_states", "ode_params")
STATE_SCALARS = ("t", "step", "emi_iters", "knp_iters", "emi_ok", "knp_ok", "emi_res",
                 "knp_res")


def assert_mesh_equal(a, b):
    for f in MESH_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def assert_geometry_equal(ga, gb):
    assert ga.sub_tags == gb.sub_tags and ga.emi_offsets() == gb.emi_offsets()
    assert sorted(ga.membranes) == sorted(gb.membranes)
    for t in ga.subdomains:
        a, b = ga.subdomains[t], gb.subdomains[t]
        for f in ("vertices", "parent_cells", "cells", "coords", "grads", "vols"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for m in ga.membranes:
        a, b = ga.membranes[m], gb.membranes[m]
        for f in ("facet_dofs", "facet_edofs", "facet_idofs", "areas", "mem_to_ecs",
                  "mem_to_ics", "vertices", "coords"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
MAKERS = {
    "mms 2-D": lambda pkg: pkg.unit_square_mms_mesh(6),
    "idealized 3-D": lambda pkg: pkg.idealized_3d_mesh(0, l=1),
}
WAYS = {"port to port": (tio, tio), "port to jax": (tio, jio), "jax to port": (jio, tio)}


@pytest.mark.parametrize("way", list(WAYS))
@pytest.mark.parametrize("make", list(MAKERS))
def test_xdmf_mesh_roundtrip_across_packages(tmp_path, make, way):
    writer, reader = WAYS[way]
    src = MAKERS[make](tmesh if writer is tio else jmesh)
    writer.write_mesh(tmp_path / "mesh.xdmf", src)
    back = reader.read_mesh(tmp_path / "mesh.xdmf")
    assert_mesh_equal(back, src)
    # the other package's mesh from its own generator is the same mesh
    assert_mesh_equal(back, MAKERS[make](jmesh if writer is tio else tmesh))


def _hex_file(path):
    """The tagged hex box of tests/test_hex_ingestion.py: an inner cell box
    tagged 1, membrane quads 1, exterior quads 5."""
    pts, hexes = _hex_box(4, 4, 4)
    mids = pts[hexes].mean(axis=1)
    cell_tags = (np.abs(mids - 0.5) < 0.25).all(axis=1).astype(np.int32)
    faces = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 5, 4], [2, 3, 7, 6],
                      [0, 3, 7, 4], [1, 2, 6, 5]])
    quads = np.sort(hexes[:, faces].reshape(-1, 4), axis=1)
    uq, inv, counts = np.unique(quads, axis=0, return_inverse=True, return_counts=True)
    owner = np.bincount(inv.ravel(), weights=np.repeat(cell_tags, 6), minlength=len(uq))
    ftags = np.zeros(len(uq), np.int32)
    ftags[counts == 1] = 5
    ftags[(counts == 2) & (owner == 1)] = 1
    keep = ftags > 0
    _write_hex_xdmf(path, pts, hexes, cell_tags, uq[keep], ftags[keep])


def test_hex_file_reads_alike_in_both_packages(tmp_path):
    _hex_file(tmp_path / "hex.xdmf")
    mj, mt = jio.read_mesh(tmp_path / "hex.xdmf"), tio.read_mesh(tmp_path / "hex.xdmf")
    assert mt.cells.shape == (6 * 64, 4)
    assert (mt.facet_tags == 1).sum() > 0 and (mt.facet_tags == 5).sum() > 0
    assert_mesh_equal(mj, mt)
    assert_geometry_equal(jbuild(mj), tbuild(mt))
    hexes = _hex_box(2, 1, 1)[1]
    for a, b in zip(jmesh.core.split_hex_cells(hexes), tmesh.split_hex_cells(hexes)):
        np.testing.assert_array_equal(a, b)


def test_emimesh_reads_and_remarks_alike_in_both_packages(tmp_path):
    from knpemi_tpu.mesh.tissue import remark_emimesh as jremark

    path = tmp_path / "emimesh" / "mesh.xdmf"
    jio.write_mesh(path, _synthetic_emimesh(), cell_tag_name="mesh",
                   facet_tag_name="mesh_facets")
    kw = dict(cell_tag_name="mesh", facet_tag_name="mesh_facets")
    mj, mt = jio.read_mesh(path, **kw), tio.read_mesh(path, **kw)
    assert_mesh_equal(mj, mt)
    opts = dict(ecs_tag_in=1, scale=1e-7, tag_map={7: 1, 100: 2})
    rj, rt = jremark(mj, **opts), tmesh.remark_emimesh(mt, **opts)
    assert set(np.unique(rt.cell_tags)) == {0, 1, 2}
    assert_mesh_equal(rj, rt)
    assert_geometry_equal(jbuild(rj), tbuild(rt))


def test_build_astrocyte_reads_a_mesh_file(tmp_path):
    """``build_astrocyte`` with ``mesh_file`` (and ``remark``, its tag
    map's keys as YAML strings) builds on the file's mesh: the same
    geometry as the synthetic build it was written from."""
    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, build_astrocyte

    cfg = {**ASTROCYTE_BASELINE, "mesh_n": 8}
    ref = build_astrocyte(cfg, device="cpu")
    tio.write_mesh(tmp_path / "tissue.xdmf", tmesh.astrocyte_tissue_mesh(n=8))
    sim = build_astrocyte({**cfg, "mesh_file": str(tmp_path / "tissue.xdmf")}, device="cpu")
    assert_geometry_equal(ref.geom, sim.geom)
    # the same file in emimesh conventions, remarked on the way in
    mesh = tmesh.astrocyte_tissue_mesh(n=8)
    raw = tmesh.Mesh(points=mesh.points * 1e7, cells=mesh.cells,
                     cell_tags=np.where(mesh.cell_tags == 0, 1,
                                        np.where(mesh.cell_tags == 2, 100, 7)))
    tio.write_mesh(tmp_path / "raw.xdmf", raw)
    rem = build_astrocyte({**cfg, "mesh_file": str(tmp_path / "raw.xdmf"),
                           "remark": {"ecs_tag_in": 1, "scale": 1e-7,
                                      "tag_map": {"100": 2, "7": 1}}}, device="cpu")
    np.testing.assert_array_equal(rem.geom.subdomains[2].cells, ref.geom.subdomains[2].cells)
    np.testing.assert_allclose(rem.geom.subdomains[0].vols, ref.geom.subdomains[0].vols,
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# time series and probes
# ---------------------------------------------------------------------------
def _h5_datasets(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as h5:
        h5.visititems(lambda k, v: out.__setitem__(k, np.asarray(v[()]))
                      if isinstance(v, h5py.Dataset) else None)
    return out


def _write_series(io_mod, path, mesh):
    """Five frames, flushed every two; reopened at three (a crash after
    the fourth flushed one); two frames more."""
    f = lambda i: {"phi": mesh.points[:, 0] * (1.0 + i), "c_K": mesh.points[:, 1] + i}
    w = io_mod.TimeSeriesWriter(path, mesh.points, mesh.cells, flush_every=2)
    for i in range(5):
        w.write(0.1 * i, f(i))
    w._flush()
    w.h5.close()  # no close(): the crashed run wrote no XML index
    w = io_mod.TimeSeriesWriter(path, mesh.points, mesh.cells, flush_every=2, resume_at=3)
    assert len(w.steps) == 3
    for i in range(3, 5):
        w.write(0.1 * i + 1.0, f(i + 10))
    w.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_time_series_across_packages_with_a_resume(tmp_path, writer):
    mesh = tmesh.unit_square_mms_mesh(4)
    _write_series(tio, tmp_path / "port" / "out.xdmf", mesh)
    _write_series(jio, tmp_path / "jax" / "out.xdmf", mesh)
    a = _h5_datasets(tmp_path / "port" / "out.h5")
    b = _h5_datasets(tmp_path / "jax" / "out.h5")
    assert a.keys() == b.keys() and "Function/phi/4" in a and "Function/phi/5" not in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (tmp_path / "port" / "out.xdmf").read_text() == \
        (tmp_path / "jax" / "out.xdmf").read_text()
    # read in the other package's reader
    src = tmp_path / writer / "out.xdmf"
    reader = jio.TimeSeriesReader if writer == "port" else tio.TimeSeriesReader
    with reader(src) as r:
        np.testing.assert_allclose(r.times, [0.0, 0.1, 0.2, 1.3, 1.4])
        assert r.fields == ["c_K", "phi"]
        np.testing.assert_array_equal(r.read("phi", step=4), mesh.points[:, 0] * 15.0)
        np.testing.assert_array_equal(r.series("c_K")[1], mesh.points[:, 1] + 1)


def test_locate_points_and_evaluate_p1_equal_jax():
    import knpemi_tpu.io.probe as jprobe
    import knpemi_tpu_torch.io.probe as tprobe

    mesh = tmesh.idealized_3d_mesh(0, l=1)
    rng = np.random.default_rng(5)
    lo, hi = mesh.points.min(axis=0), mesh.points.max(axis=0)
    q = lo + (hi - lo) * rng.uniform(-0.05, 1.05, (200, 3))  # some outside
    cj, bj = jprobe.locate_points(mesh.points, mesh.cells, q)
    ct, bt = tprobe.locate_points(mesh.points, mesh.cells, q)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(bt, bj)
    vals = rng.standard_normal((3, mesh.n_points))
    np.testing.assert_array_equal(tprobe.evaluate_p1(mesh.points, mesh.cells, vals, q),
                                  jprobe.evaluate_p1(mesh.points, mesh.cells, vals, q))
    # a linear field is interpolated exactly inside a mesh (test_io.py's)
    sq = tmesh.unit_square_mms_mesh(8)
    pts = rng.uniform(0.0, 1.0, (50, 2))
    lin = sq.points @ np.array([1.0, -2.0]) + 3.0
    np.testing.assert_allclose(tio.evaluate_p1(sq.points, sq.cells, lin, pts),
                               pts @ np.array([1.0, -2.0]) + 3.0, rtol=1e-12)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sims():
    """The 2-D res-1 scenario in both packages, float64, with real
    multigrid levels; JAX on its XLA path (exact gathers, as the port)."""
    simJ = jax_simulation(jnp.float64, use_pallas=False, mg_coarse_max=100)
    simT = build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                           device="cpu", solver_options=SolverOptions(mg_coarse_max=100))
    return simJ, simT


def _assert_state_bitwise(a, b):
    """Two states (either package's, on the host) field for field."""
    for f in STATE_DICTS:
        da, db = getattr(a, f), getattr(b, f)
        assert sorted(da) == sorted(db), f
        for k in da:
            x, y = np.asarray(da[k]), np.asarray(db[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), (f, k)
    for f in STATE_SCALARS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _np_state(state):
    from types import SimpleNamespace

    from knpemi_tpu_torch.interop import state_to_numpy

    return SimpleNamespace(**state_to_numpy(state))


def test_checkpoints_load_across_packages(tmp_path, sims):
    simJ, simT = sims
    sT, *_ = simT.run(simT.init_state(), 2)
    tio.save_checkpoint(tmp_path / "port.npz", sT, note=42)
    loadedJ, metaJ = jio.load_checkpoint(tmp_path / "port.npz")
    assert int(metaJ["note"]) == 42
    _assert_state_bitwise(jax.device_get(loadedJ), _np_state(sT))

    sJ, _, _ = simJ.run(simJ.init_state(), 2)
    sJ = jax.device_get(sJ)
    jio.save_checkpoint(tmp_path / "jax.npz", sJ, note=7)
    loadedT, metaT = tio.load_checkpoint(tmp_path / "jax.npz", device="cpu")
    assert int(metaT["note"]) == 7 and loadedT.c[0].dtype == torch.float64
    _assert_state_bitwise(_np_state(loadedT), sJ)
    # a float32 load casts the floating fields and keeps the others
    s32, _ = tio.load_checkpoint(tmp_path / "jax.npz", device="cpu", dtype=torch.float32)
    assert s32.c[0].dtype == torch.float32 and s32.t.dtype == torch.float64
    assert s32.step.dtype == torch.int32
    if not torch.cuda.is_available():  # device=None means CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            tio.load_checkpoint(tmp_path / "jax.npz")


@pytest.mark.parametrize("banded", [False, True], ids=["ell", "banded"])
def test_checkpoint_resume_bitexact(tmp_path, banded):
    sim = build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                          device="cpu",
                          solver_options=SolverOptions(mg_banded=banded, mg_coarse_max=100))
    s, *_ = sim.run(sim.init_state(), 5)
    tio.save_checkpoint(tmp_path / "ck.npz", s, note=42)
    loaded, meta = tio.load_checkpoint(tmp_path / "ck.npz", device="cpu")
    assert int(meta["note"]) == 42 and int(loaded.step) == 5
    a, *_ = sim.run(s, 5)
    b, *_ = sim.run(loaded, 5)
    _assert_state_bitwise(_np_state(a), _np_state(b))


def test_jax_checkpoint_resumes_in_the_port(tmp_path, sims):
    simJ, simT = sims
    s5, _, _ = simJ.run(simJ.init_state(), 5)
    jio.save_checkpoint(tmp_path / "ck.npz", jax.device_get(s5))
    sJ, eJ, kJ = simJ.run(s5, 5)
    sJ = jax.device_get(sJ)
    loaded, _ = tio.load_checkpoint(tmp_path / "ck.npz", device="cpu")
    sT, eT, kT, ok = simT.run(loaded, 5)
    assert ok.all() and int(sT.step) == 10
    np.testing.assert_array_equal(eT, np.asarray(eJ))
    np.testing.assert_array_equal(kT, np.asarray(kJ))
    for m in sJ.phi_M:
        np.testing.assert_allclose(sT.phi_M[m].numpy(), np.asarray(sJ.phi_M[m]),
                                   rtol=0, atol=1e-12)
    for t in sJ.c:
        np.testing.assert_allclose(sT.c[t].numpy(), np.asarray(sJ.c[t]), rtol=1e-12, atol=0)
    for m in sJ.ode_states:
        np.testing.assert_allclose(sT.ode_states[m].numpy(), np.asarray(sJ.ode_states[m]),
                                   rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# run's hooks
# ---------------------------------------------------------------------------
def test_checkpoint_cadence_matches_jax(sims):
    """save_every 3, checkpoint_every 4, 8 steps: chunks end at 3, 6, 8;
    a checkpoint after step 6 only (none after the last chunk)."""
    simJ, simT = sims
    seenJ, seenT, obsT = [], [], []
    simJ.run(simJ.init_state(), 8, save_every=3, checkpoint_every=4,
             checkpoint_cb=lambda s: seenJ.append(int(s.step)))
    host = []
    simT.run(simT.init_state(), 8, save_every=3, observer=obsT.append, checkpoint_every=4,
             checkpoint_cb=lambda s: (seenT.append(int(s.step)), host.append(s)))
    assert seenT == seenJ == [6]
    assert [int(s.step) for s in obsT] == [3, 6, 8]
    assert host[0] is obsT[1] and host[0].c[0].device.type == "cpu"


def _stalled(mode):
    """Tolerances of 1e-14 that 1000 iterations reach (EMI 2-3 a step, KNP
    4) and 2 do not: GMRES restarted every 2 iterations, no minimum."""
    return build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                           device="cpu", solver_options=SolverOptions(
                               maxiter=2, rtol_emi=1e-14, rtol_knp=1e-14, restart=2,
                               min_iter_knp=0, on_divergence=mode))


def test_divergence_raises():
    sim = _stalled("raise")
    assert sim.emi_solver.maxiter == sim.knp_solver.maxiter == 2
    with pytest.raises(RuntimeError, match="did NOT converge at step 1"):
        sim.run(sim.init_state(), 2)


def test_divergence_warn_mode_continues():
    sim = _stalled("warn")
    with pytest.warns(RuntimeWarning, match="did NOT converge"):
        state, it_e, it_k, ok = sim.run(sim.init_state(), 2, save_every=1)
    assert int(state.step) == 2 and not ok.any()
    assert it_e.max() <= 2 and it_k.max() <= 2
    # the same tolerances within 1000 iterations converge
    sim.opts.maxiter = sim.emi_solver.maxiter = sim.knp_solver.maxiter = 1000
    _, _, _, ok = sim.run(sim.init_state(), 2)
    assert ok.all()


def test_divergence_ignore_mode_is_silent():
    sim = _stalled("ignore")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state, _, _, ok = sim.run(sim.init_state(), 2)
    assert int(state.step) == 2 and not ok.any()
    with pytest.raises(ValueError):
        SolverOptions(on_divergence="abort")
