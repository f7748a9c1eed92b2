"""The least bytes of the step's EMI solve: the conductivity and the
operator's fill, the right-hand side, and per CG iteration one apply of
the fine operator, one V-cycle of the configured shape and the CG's
vector updates (x, r, p: 3 reads 3 writes; two inner products and the
residual norm: 5 reads; the null-space projection: 5)."""

from __future__ import annotations

import numpy as np

from perfbench.roofline import common as C


def operator_pattern(geom):
    """The EMI operator's pattern on every subdomain's dofs in tag order:
    each subdomain's P1 graph and each membrane's facet pairs across."""
    off = geom.emi_offsets()
    rows, cols = [], []
    for t in geom.sub_tags:
        r, c = C.cell_pairs(geom.subdomains[t].cells, off[t])
        rows.append(r.ravel())
        cols.append(c.ravel())
    for mem in geom.membranes.values():
        i = np.asarray(mem.facet_idofs, np.int64) + off[mem.cell_tag]
        e = np.asarray(mem.facet_edofs, np.int64) + off[0]
        for a, b in ((i, i), (i, e), (e, i), (e, e)):
            k = a.shape[1]
            rows.append(np.repeat(a[:, :, None], k, axis=2).ravel())
            cols.append(np.repeat(b[:, None, :], k, axis=1).ravel())
    return C.pattern(np.concatenate(rows), np.concatenate(cols), geom.emi_size)


class Count:
    """The least bytes of one EMI solve of ``iters`` CG iterations on the
    simulation ``sim`` (read once: sizes, hierarchy, options)."""

    def __init__(self, sim):
        geom, self.vb = sim.geom, sim.dtype.itemsize
        A0 = operator_pattern(geom)
        self.n, self.nnz = geom.emi_size, int(A0.nnz)
        hier = sim._emi_hier
        self.lv, self.nc = C.levels(A0, hier)
        self.cycle = C.vcycle(self.lv, self.nc, self.vb, 1, sim.opts.mg_nu,
                              C.smoother_steps(hier), True, sim.emi_solver.mg.gamma)
        vb, N = self.vb, len(sim.ions)
        setup = 0.0
        for t, s in geom.subdomains.items():
            nnz_t = int(C.pattern(*C.cell_pairs(s.cells), s.n_dofs).nnz)
            # kappa from the ions, its cell mean, the values filled from
            # (grads, vols, mean), and the right-hand side's stiffness apply
            setup += (N + 1) * s.n_dofs * vb + s.n_cells * vb
            setup += s.n_cells * (12 + 2) * vb + nnz_t * vb
            setup += N * s.n_dofs * vb + C.op(nnz_t, s.n_dofs, s.n_dofs, vb)
        for mem in geom.membranes.values():
            setup += 3 * mem.n_dofs * vb   # phi_M read, two sides written
        self.setup = setup + C.op(self.nnz, self.n, self.n, vb) + 3 * self.n * vb + self.cycle

    def iteration(self) -> float:
        return C.op(self.nnz, self.n, self.n, self.vb) + self.cycle + 13 * self.n * self.vb

    def __call__(self, iters: int) -> float:
        return self.setup + iters * self.iteration()

    def per_iteration(self) -> str:
        return f"{self.iteration():.0f}"
