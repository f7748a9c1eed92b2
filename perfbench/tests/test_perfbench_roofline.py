"""The roofline byte counts against a hand count on a tiny hierarchy and
a tiny mesh."""

import types

import numpy as np
import scipy.sparse as sp
import torch

from perfbench.roofline import common as C
from perfbench.roofline import emi, knp


def _tiny():
    # a 4-dof path graph, two aggregates of two: P is 4 x 2 with 4 nonzeros
    A0 = C.pattern(np.array([0, 0, 1, 1, 1, 2, 2, 2, 3, 3]),
                   np.array([0, 1, 0, 1, 2, 1, 2, 3, 2, 3]), 4)
    P = sp.csr_matrix(np.array([[1.0, 0], [1, 0], [0, 1], [0, 1]]))
    hier = types.SimpleNamespace(perm=None, levels=[types.SimpleNamespace(P_csr=P, steps=None)])
    return A0, hier


def test_levels_by_hand():
    A0, hier = _tiny()
    lv, nc = C.levels(A0, hier)
    # P^T A P of the path is the full 2 x 2 pattern
    assert lv == [(4, 10, 4, 2)] and nc == 2


def test_vcycle_by_hand():
    A0, hier = _tiny()
    lv, nc = C.levels(A0, hier)
    vb, B = 4, 1
    A = 10 * (4 + vb) + 2 * 4 * vb                 # 144
    smooth = A + (4 + 4 * 4) * vb                  # 224
    pre = (4 + 2 * 4) * vb                         # from zero: 48
    res = A + 3 * 4 * vb                           # 192
    restrict = 4 * (4 + vb) + (4 + 2) * vb         # 56
    coarse = 2 * 2 * 2 * vb + 2 * 2 * vb           # 48
    prolong = 4 * (4 + vb) + (2 + 4) * vb + 3 * 4 * vb   # 104
    post = smooth
    assert C.vcycle(lv, nc, vb, B, 1, 1, True) == pre + res + restrict + coarse + prolong + post
    assert C.vcycle(lv, nc, vb, B, 1, 1, False) == pre + res + restrict + coarse + prolong


def test_counts_on_a_tiny_mesh():
    from knpemi_tpu_torch.sim.scenarios import build_idealized
    from knpemi_tpu_torch.sim.stepper import SolverOptions

    sim = build_idealized(3, 0, l=1, dtype=torch.float32, device="cpu",
                          solver_options=SolverOptions(rtol_emi=1e-5, rtol_knp=1e-7))
    e = emi.Count(sim)
    # the EMI pattern: every subdomain's P1 graph and the membrane's
    # cross blocks (the facets' ICS x ECS pairs, both ways)
    g = sim.geom
    sub = sum(C.pattern(*C.cell_pairs(s.cells), s.n_dofs).nnz for s in g.subdomains.values())
    cross = 0
    for mem in g.membranes.values():
        k = mem.facet_idofs.shape[1]
        pairs = {(a, b) for f_i, f_e in zip(mem.facet_idofs, mem.facet_edofs)
                 for a in f_i for b in f_e}
        cross += 2 * len(pairs)
    assert e.nnz == sub + cross
    assert e.n == g.emi_size
    per_it = C.op(e.nnz, e.n, e.n, 4) + e.cycle + 13 * e.n * 4
    assert e(3) - e(0) == 3 * per_it
    k = knp.Count(sim)
    n0 = g.subdomains[0].n_dofs
    Bn = 2 * n0 * 4
    s0 = k.sub[0]
    one = k({0: 1}) - k.robin - s0["setup"]
    assert one == s0["cycle"] + s0["A"] + 5 * Bn + 3 * Bn + 3 * Bn
