"""The port's manufactured-solution (MMS) path against the JAX package's,
and its own convergence rates.

Against the JAX package, on the same meshes in float64 (2-D M = 8 and
3-D M = 4; the JAX side only at these sizes):

* ``build_mms_data``: every array of the EMI and KNP data and the exact
  initial conditions within 1e-12 relative;
* the MMS EMI operator (the Dirichlet elimination around the unmasked
  apply), its Jacobi diagonal and right-hand side (sources, Robin and
  current-jump data, Neumann flux, Dirichlet lift), and the MMS KNP
  operators (K3's and K11's plain twins on the host-assembled exact
  drift), diagonal and right-hand side, on seeded inputs, within 1e-12
  of max|y|;
* the direct solves within 1e-10;
* the iterative solves at 2-D M = 8 (deflated-Jacobi CG, Jacobi GMRES
  per ion and ion-batched, rtol 1e-10): equal iteration counts, fields
  within 1e-8 of max|u|.

The port alone (no JAX): the O(h^2) rates of the reference's study, the
last rate > 1.8 in 2-D (M = 8, 16, 32) and > 1.6 in 3-D (M = 4, 8, 16)
for every field, by the direct path; and the iterative path against the
direct one at M = 16: |e_it - e_dir| < 1e-6 + 1e-3 e_dir.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu_torch.mesh import unit_cube_mms_mesh, unit_square_mms_mesh
from knpemi_tpu_torch.ops.geometry import build_geometry
from knpemi_tpu_torch.ops.p1op import membrane_operators, p1_operators
from knpemi_tpu_torch.solvers import direct as TD
from knpemi_tpu_torch.solvers.api import create_solver_emi, create_solver_knp
from knpemi_tpu_torch.systems import mms
from knpemi_tpu_torch.systems.coupling import set_initial_conditions
from knpemi_tpu_torch.systems.emi import emi_system
from knpemi_tpu_torch.systems.knp import knp_system


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the Krylov solves are thousands of small ops,
    which threads of several test processes on one host slow down ~30x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZES = [(2, 8), (3, 4)]
IDS = ["2d_M8", "3d_M4"]
FIELDS = ["phi_e", "phi_i", "a_e", "b_e", "a_i", "b_i"]
KRYLOV = dict(rtol=1e-10, maxiter=4000)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def port_problem(dim, M, per_ion=False):
    """(geom, case, EMI system, KNP system, c0, phi_M0) of the port, CPU float64."""
    geom = build_geometry((unit_square_mms_mesh if dim == 2 else unit_cube_mms_mesh)(M))
    case = (mms.reference_mms_case if dim == 2 else mms.reference_mms_case_3d)(geom)
    ions, emi_data, knp_data = mms.build_mms_data(geom, case)
    ops, mops = p1_operators(geom, "cpu"), membrane_operators(geom, "cpu")
    esys = emi_system(geom, ions, case.params, mms=emi_data, device="cpu",
                      p1ops=ops, memops=mops)
    ksys = knp_system(geom, ions, case.params, mms=knp_data, device="cpu",
                      p1ops=ops, memops=mops, per_ion=per_ion)
    c0 = set_initial_conditions(geom, ions, device="cpu")
    phiM0 = {m: torch.zeros(sp.n_dofs, dtype=torch.float64)
             for m, sp in geom.membranes.items()}
    return geom, case, esys, ksys, c0, phiM0


@lru_cache(maxsize=None)
def jax_problem(dim, M):
    from knpemi_tpu.mesh import unit_cube_mms_mesh as jcube
    from knpemi_tpu.mesh import unit_square_mms_mesh as jsquare
    from knpemi_tpu.ops.geometry import build_geometry as jgeom
    from knpemi_tpu.systems import mms as jmms
    from knpemi_tpu.systems.coupling import set_initial_conditions as jsic
    from knpemi_tpu.systems.emi import emi_system as jemi
    from knpemi_tpu.systems.knp import knp_system as jknp

    geom = jgeom((jsquare if dim == 2 else jcube)(M))
    case = (jmms.reference_mms_case if dim == 2 else jmms.reference_mms_case_3d)(geom)
    ions, emi_data, knp_data = jmms.build_mms_data(geom, case)
    esys = jemi(geom, ions, case.params, mms=emi_data)
    ksys = jknp(geom, ions, case.params, mms=knp_data)
    c0 = jsic(geom, ions)
    phiM0 = {m: jnp.zeros(sp.n_dofs) for m, sp in geom.membranes.items()}
    return geom, case, ions, emi_data, knp_data, esys, ksys, c0, phiM0


@lru_cache(maxsize=None)
def pair(dim, M):
    return jax_problem(dim, M), port_problem(dim, M, per_ion=True)


def _leaves(a, b, name, out):
    if isinstance(a, dict):
        assert set(a) == set(b), name
        for k in a:
            _leaves(a[k], b[k], f"{name}[{k}]", out)
    elif a is None:
        assert b is None, name
    elif isinstance(a, float):
        assert a == b, name
    else:
        out.append((name, np.asarray(a), np.asarray(b)))


@pytest.mark.parametrize("dim,M", SIZES, ids=IDS)
def test_mms_data_matches_jax(dim, M):
    """Every array of build_mms_data within 1e-12 relative."""
    J, T = pair(dim, M)
    _, _, ionsJ, eJ, kJ = J[:5]
    esT, ksT = T[2], T[3]
    leaves = []
    for dj, dt in ((eJ, esT.mms), (kJ, ksT.mms)):
        for f in dataclasses.fields(dj):
            _leaves(getattr(dj, f.name), getattr(dt, f.name), f.name, leaves)
    for ij, it in zip(ionsJ, esT.ions):
        _leaves(ij.c_init, it.c_init, f"c_init {ij.name}", leaves)
    assert len(leaves) > 20
    for name, a, b in leaves:
        assert a.shape == b.shape, name
        assert rel(b, a) <= 1e-12, (name, rel(b, a))


OPERATORS = ["emi_matvec", "emi_diag", "emi_rhs", "knp_matvec_batch", "knp_matvec_one",
             "knp_diag", "knp_rhs"]


def _operator_pairs(name, J, T):
    """[(port result, JAX result)] of one operator on seeded inputs."""
    _, _, _, _, _, esJ, ksJ, cJ, pmJ = J
    _, _, esT, ksT, cT, pmT = T
    rng = np.random.default_rng(7)
    kapJ = esJ.kappa(cJ)
    ctxT = esT.prepare(esT.kappa(cT))
    if name == "emi_matvec":
        x = rng.standard_normal(esT.n)
        assert esT.has_bc and esT.nullvec is None
        return [(esT.matvec(torch.tensor(x), ctxT), esJ.matvec(jnp.asarray(x), kapJ))]
    if name == "emi_diag":
        return [(esT.diag(ctxT["kappa"]), esJ.diag(kapJ))]
    if name == "emi_rhs":
        return [(esT.rhs(cT, pmT), esJ.rhs(cJ, pmJ))]
    phiJ = {t: jnp.asarray(rng.standard_normal(s.n_dofs))
            for t, s in esT.geom.subdomains.items()}
    phiT = {t: torch.tensor(np.asarray(v)) for t, v in phiJ.items()}
    gJ, gT = ksJ.gradphi_cells(phiJ), ksT.gradphi_cells(phiT)
    out = []
    for t in ksT.tags:
        X = rng.standard_normal((ksT.n_solved, ksT.sub[t]["n_dofs"]))
        Dr = ksT.drift_values(t, gT[t])
        yJ = ksJ.matvec(t, jnp.asarray(X), gJ[t])
        if name == "knp_matvec_batch":
            out.append((ksT.matvec_batch(t, torch.tensor(X), Dr), yJ))
        elif name == "knp_matvec_one":
            out += [(ksT.matvec_one(t, k, torch.tensor(X[k]), Dr), yJ[k])
                    for k in range(ksT.n_solved)]
        elif name == "knp_diag":
            out.append((ksT.diag(t, gT[t]), ksJ.diag(t, gJ[t])))
    if name == "knp_rhs":
        rT, rJ = ksT.rhs(cT, phiT, pmT), ksJ.rhs(cJ, phiJ, pmJ)
        out = [(rT[t], rJ[t]) for t in ksT.tags]
    return out


@pytest.mark.parametrize("op", OPERATORS)
@pytest.mark.parametrize("dim,M", SIZES, ids=IDS)
def test_mms_operators_match_jax(dim, M, op):
    """The MMS operators, diagonals and right-hand sides within 1e-12 of
    max|y| (the KNP operators: the plain twins of K3 and K11 on the
    host-assembled exact drift against the JAX quadrature drift)."""
    pairs = _operator_pairs(op, *pair(dim, M))
    assert pairs
    for yT, yJ in pairs:
        assert yT.shape == tuple(np.shape(yJ))
        assert rel(yT, yJ) <= 1e-12, (op, rel(yT, yJ))


def test_mms_drift_stream_matches_drift_quad_coo():
    """The exact drift's values on the P1 operator are the matrix of
    ``_drift_quad_coo``, through scipy."""
    _, _, esT, ksT, _, _ = pair(3, 4)[1]
    mm = ksT.mms
    for t, s in ksT.geom.subdomains.items():
        r, c, v = TD._drift_quad_coo(s.cells, s.grads, s.vols, mm.gradphi_q[t],
                                     mm.cell_bary, mm.cell_qw)
        ref = TD._coo_accumulate([r], [c], [v], s.n_dofs).toarray()
        got = ksT.sub[t]["op"].scipy_csr(ksT.mms_drift[t]).toarray()
        assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("system", ["emi", "knp"])
@pytest.mark.parametrize("dim,M", SIZES, ids=IDS)
def test_direct_solve_matches_jax(dim, M, system):
    from knpemi_tpu.solvers import direct as JD

    J, T = pair(dim, M)
    _, _, _, _, _, esJ, ksJ, cJ, pmJ = J
    _, _, esT, ksT, cT, pmT = T
    xT, xJ = TD.solve_emi_direct(esT, cT, pmT), JD.solve_emi_direct(esJ, cJ, pmJ)
    if system == "emi":
        assert rel(xT, xJ) <= 1e-10
        return
    phiT = esT.split(torch.tensor(xT))
    phiJ = esJ.split(jnp.asarray(xJ))
    kT, kJ = TD.solve_knp_direct(ksT, cT, phiT, pmT), JD.solve_knp_direct(ksJ, cJ, phiJ, pmJ)
    for t in kJ:
        assert rel(kT[t], kJ[t]) <= 1e-10


@lru_cache(maxsize=None)
def jax_iterative():
    from knpemi_tpu.solvers.api import create_solver_emi as jce
    from knpemi_tpu.solvers.api import create_solver_knp as jck

    _, _, _, _, _, esJ, ksJ, cJ, pmJ = pair(2, 8)[0]
    phi, ie = jce(esJ, **KRYLOV).solve(cJ, pmJ)
    c, ik = jck(ksJ, **KRYLOV).solve(cJ, phi, pmJ)
    return phi, c, int(ie.iters), int(ik.iters)


@pytest.mark.parametrize("branch", ["per_ion", "batched"])
def test_iterative_solve_matches_jax(branch):
    """Deflated-Jacobi CG and Jacobi GMRES (no hierarchy) at 2-D M = 8:
    the JAX package's iterative MMS leg (per ion, vmapped) against the
    port's per-ion and ion-batched branches."""
    phiJ, cJ, itJ_e, itJ_k = jax_iterative()
    _, _, esT, ksT, cT, pmT = pair(2, 8)[1]
    phi, ie = create_solver_emi(esT, **KRYLOV).solve(cT, pmT)
    c, ik = create_solver_knp(ksT, batched=branch == "batched", **KRYLOV).solve(cT, phi, pmT)
    assert ie.converged and ik.converged
    assert (ie.iters, ik.iters) == (itJ_e, itJ_k)
    for t in phiJ:
        assert rel(phi[t], phiJ[t]) <= 1e-8
        assert rel(c[t], cJ[t]) <= 1e-8


# ---------------------------------------------------------------------------
# the port's own rates (no JAX)
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def errors(dim, M, direct=True):
    geom, case, esys, ksys, c0, phiM0 = port_problem(dim, M)
    phi, ie = create_solver_emi(esys, direct=direct, **KRYLOV).solve(c0, phiM0)
    c, ik = create_solver_knp(ksys, direct=direct, **KRYLOV).solve(c0, phi, phiM0)
    assert ie.converged and ik.converged
    l2 = lambda tag, u, fn: mms.l2_error(geom, tag, u, fn)
    return dict(
        phi_e=l2(0, phi[0], case.phi[0]), phi_i=l2(1, phi[1], case.phi[1]),
        a_e=l2(0, c[0][0], case.conc[("a", 0)]), b_e=l2(0, c[0][1], case.conc[("b", 0)]),
        a_i=l2(1, c[1][0], case.conc[("a", 1)]), b_i=l2(1, c[1][1], case.conc[("b", 1)]),
    )


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("dim,Ms,gate", [(2, (8, 16, 32), 1.8), (3, (4, 8, 16), 1.6)],
                         ids=["2d", "3d"])
def test_direct_rate2(dim, Ms, gate, field):
    e = [errors(dim, M)[field] for M in Ms]
    rates = [np.log2(e[i - 1] / e[i]) for i in range(1, len(e))]
    assert rates[-1] > gate, (field, e, rates)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("dim", [2, 3])
def test_iterative_matches_direct(dim, field):
    """The Krylov path (deflated-Jacobi CG, Jacobi GMRES) reproduces the
    direct solve's error at M = 16."""
    e_dir, e_it = errors(dim, 16)[field], errors(dim, 16, direct=False)[field]
    assert abs(e_dir - e_it) < 1e-6 + 1e-3 * e_dir, (field, e_dir, e_it)
