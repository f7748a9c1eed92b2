"""The least bytes of the step's KNP solve: per subdomain, the cell
gradient of phi and the drift's fill, the right-hand side (mass apply,
source, the membrane Robin terms' gather and scatter), and restarted,
right-preconditioned GMRES over the solved ions as one batch: per
iteration one batched V-cycle, one apply of the ions' operators (one
index, a value per ion), modified Gram-Schmidt over the live basis and
the normalisation; per restart cycle the update x + Z y and the new
residual."""

from __future__ import annotations

import numpy as np

from perfbench.roofline import common as C


class Count:
    """The least bytes of one KNP solve on the simulation ``sim``; called
    with {subdomain tag: GMRES iterations}."""

    def __init__(self, sim):
        geom, self.vb = sim.geom, sim.dtype.itemsize
        self.B = sim.knp_sys.n_solved
        self.m = sim.opts.restart
        vb, B, N = self.vb, self.B, len(sim.ions)
        self.sub = {}
        for t, hier in sim._knp_hier.items():
            s = geom.subdomains[t]
            A0 = C.pattern(*C.cell_pairs(s.cells), s.n_dofs)
            lv, nc = C.levels(A0, hier)
            mg = sim.knp_solver.mg[t]
            cycle = C.vcycle(lv, nc, vb, B, sim.opts.mg_nu, C.smoother_steps(hier),
                             mg.post_smooth, mg.gamma)
            n, nnz = s.n_dofs, int(A0.nnz)
            A = nnz * C.INDEX_BYTES + B * nnz * vb + 2 * B * n * vb
            setup = n * vb + 3 * s.n_cells * vb                        # grad phi
            setup += s.n_cells * (3 + 12 + 1) * vb + nnz * vb           # drift fill
            setup += C.op(nnz, n, n, vb, B) + 2 * B * n * vb            # mass, source
            setup += A + 3 * B * n * vb + 3 * B * n * vb                # r0, |r0|, V0
            self.sub[t] = dict(n=n, A=A, cycle=cycle, setup=setup)
        self.robin = sum((3 * N + 2) * m.n_dofs * vb + 2 * B * m.n_dofs * vb
                         for m in geom.membranes.values())

    def per_iteration(self) -> str:
        """The operator and cycle of an iteration, by subdomain."""
        return ", ".join(f"subdomain {t} {s['cycle'] + s['A']:.0f}" for t, s in self.sub.items())

    def __call__(self, iters: dict) -> float:
        vb, B, m = self.vb, self.B, self.m
        total = self.robin
        for t, it in iters.items():
            s = self.sub[t]
            Bn = B * s["n"] * vb
            total += s["setup"]
            for i in range(it):
                j = i % m
                total += s["cycle"] + s["A"] + 5 * (j + 1) * Bn + 3 * Bn
                if j == m - 1 or i == it - 1:
                    total += (j + 3) * Bn                               # x + Z y
                    if i < it - 1:
                        total += s["A"] + 6 * Bn                        # restart residual
        return total
