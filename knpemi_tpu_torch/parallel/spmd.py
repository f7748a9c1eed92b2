"""Replicate-dofs SPMD: every rank shards the O(cells) work of one step.

Counterpart of ``knpemi_tpu/parallel/spmd.py`` (``SpmdSimulation``
``:57``, with ``EMISystem.local_view`` and ``KNPSystem.local_view``), on
``torch.distributed`` ranks (``parallel/comm.py``).  Dof vectors and the
multigrid hierarchies stay replicated, as in the JAX package, and every
Krylov iteration runs on every rank.  The port's operators are row
applies of assembled P1 operators, not cell loops, so "shard the
O(cells) work" means: each rank fills (K1f, K11f) and applies (K1, K3,
K11, K2) a contiguous range of whole 32-row slices of each P1 operator
(``parallel/sharded.py::RowBlock``: its rows, every cell touching them,
the columns in a window of the replicated vector), runs the K10 scatter
of the KNP Robin terms and the RK4 substeps of the membrane ODEs on its
rows of each membrane, and ``all_gather``s the rows, one collective per
operator apply.  K4's cell maps and the fills' per-cell passes run on
the rank's cells only.

Each row is summed in the same order as on one device (its slots, its
incidence list's cells ascending), the rows are gathered exactly, and
everything else runs on replicated vectors as on one device: so **an
N-rank step is bitwise equal to the port's single-device step**, in
float32 and float64.  (The JAX package's SPMD test holds its mode to
1e-6 only: its ``psum`` of partial cell sums reorders every row.)

Every rank passes its own ``Simulation``, built on ``comm.device``; the
builds after rank 0's read the multigrid cache it wrote.  Built on the
hierarchies of the single-device simulation; the host LU path and the
deflated Jacobi preconditioner are not ported to this mode.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..models.engine import update_ode_variables
from ..ops import assembly as A
from ..ops import ell as E
from ..ops import p1op as P
from ..systems.coupling import update_pde_variables
from ..systems.types import SimState
from .sharded import (RowBlock, _run_chunks, cells_touching, csr_row_values, ode_rows,
                      place_row_values)


def slice_rows(n: int, n_dev: int, d: int):
    """Rank d's rows of an n-row operator: whole 32-row slices, as even as
    the slices allow."""
    ns = -(-n // P.SLICE)
    s0, s1 = d * ns // n_dev, (d + 1) * ns // n_dev
    return min(P.SLICE * s0, n), min(P.SLICE * s1, n)


def _sizes(rows, n: int, n_dev: int):
    """Every rank's row count under the split ``rows(n, n_dev, d)``."""
    return [b - a for a, b in (rows(n, n_dev, d) for d in range(n_dev))]


def _block(cells, n: int, n_dev: int, d: int, dtype, device, grads=None, vols=None,
           maps=True):
    """(RowBlock, local cell ids) of rank d's rows of the operator of
    ``cells`` on the window of its cells' vertices."""
    cells = np.asarray(cells)
    r0, r1 = slice_rows(n, n_dev, d)
    ids = cells_touching(cells, r0, r1)
    if not len(ids):
        return RowBlock(None, r0, r1, r0, 0, dtype, device), ids
    lc = cells[ids]
    base = int(lc.min())
    g = None if grads is None else np.asarray(grads)[ids]
    v = None if vols is None else np.asarray(vols)[ids]
    return RowBlock(lc - base, r0, r1, base, int(lc.max()) + 1 - base, dtype, device, g, v,
                    maps=maps), ids


class _Gather:
    """The ranks' rows of several operators in one ``all_gather``."""

    def __init__(self, comm):
        self.comm = comm

    def __call__(self, parts, sizes, site: str):
        """``parts``: the rank's rows, (..., own_i) each (one leading
        shape), ``sizes[i]`` every rank's own_i; returns the whole (...,
        n_i) of each."""
        comm = self.comm
        tot = [sum(s[r] for s in sizes) for r in range(comm.world)]
        full = comm.all_gather_v(torch.cat(parts, dim=-1), tot, site)
        out, at = [[] for _ in parts], 0
        for r in range(comm.world):
            for i, s in enumerate(sizes):
                out[i].append(full[..., at:at + s[r]])
                at += s[r]
        return [torch.cat(o, dim=-1) for o in out]


class _SpmdEMI:
    """``EMISystem`` with its operator applies on the rank's rows."""

    def __init__(self, base, spmd):
        self.base, self.s = base, spmd

    def __getattr__(self, name):
        return getattr(self.base, name)

    def prepare(self, kappa):
        vals = {}
        for t in self.base.tags:
            b = self.s.blocks[t]
            if b.op is None:
                vals[t] = None
                continue
            kbar = E.ellw_matvec(b.kbar, kappa[t][b.base:b.base + b.n_win].contiguous())
            vals[t] = P.emi_fill(b.op, b.grads, b.vols * kbar)
        return {"kappa": kappa, "vals": vals}

    def _rows(self, b, x, vals, scale=1.0):
        if b.op is None:
            return x.new_zeros(0)
        return P.emi_stiffness(x[b.base:b.base + b.n_win].contiguous(), b.op, vals,
                               scale)[b.lo:b.hi]

    def _assemble(self, bulk, mem_rows):
        """The bulk rows of every subdomain and K2's rows of every
        membrane, gathered in one collective; the coupling added as on
        one device."""
        s, sys_ = self.s, self.base
        tags, mems = sys_.tags, list(sys_.mem)
        got = s.gather(bulk + mem_rows, [s.sizes[t] for t in tags]
                       + [s.mem_sizes[m] for m in mems], "rows")
        y = sys_.flatten(dict(zip(tags, got[:len(tags)])))
        for m, w in zip(mems, got[len(tags):]):
            mb = sys_.mem[m]
            y = y.index_add(0, mb["flat_idx"], torch.cat([-w, w]))
        return y

    def _mem_rows(self, m, g):
        b, (M, _) = self.s.mem_blocks[m], self.s.mem_vals[m]
        if b.op is None:
            return g.new_zeros(0)
        return P.surface_mass(g[b.base:b.base + b.n_win].contiguous(), b.op, M,
                              self.base.params.C_phi)[b.lo:b.hi]

    def matvec(self, x, ctx):
        sys_ = self.base
        xs = sys_.split(x)
        bulk = [self._rows(self.s.blocks[t], xs[t], ctx["vals"][t]) for t in sys_.tags]
        mem_rows = []
        for m, mb in sys_.mem.items():
            n_m = mb["n_mem"]
            u2 = x[mb["flat_idx"]]
            mem_rows.append(self._mem_rows(m, u2[n_m:] - u2[:n_m]))
        return self._assemble(bulk, mem_rows)

    def rhs(self, c, phi_M, I_ch=None, ctx=None):
        sys_ = self.base
        F, C_phi = sys_.params.F, sys_.params.C_phi
        bulk = []
        for t in sys_.tags:
            s = sys_.sub[t]
            u_star = torch.zeros(s["n_dofs"], dtype=sys_.dtype, device=sys_.device)
            for k, ion in enumerate(sys_.ions):
                u_star = u_star + (F * ion.z * ion.D[t]) * c[t][k]
            u_star = u_star - u_star.mean()
            bulk.append(self._rows(self.s.blocks[t], u_star, self.s.kst.get(t), -1.0))
        mem_rows = []
        for m in sys_.mem:
            g = phi_M[m]
            if not sys_.splitting_scheme:
                g = g - (1.0 / C_phi) * I_ch[m].sum(dim=0)
            mem_rows.append(self._mem_rows(m, g.contiguous()))
        return self._assemble(bulk, mem_rows)


class _SpmdKNP:
    """``KNPSystem`` with its operator applies, fills and K4's gradient
    map on the rank's rows and cells."""

    def __init__(self, base, spmd):
        self.base, self.s = base, spmd

    def __getattr__(self, name):
        return getattr(self.base, name)

    def gradphi_cells(self, phi):
        """grad(phi) per cell of the rank's blocks (K4)."""
        out = {}
        for t in self.base.tags:
            b = self.s.blocks[t]
            out[t] = None if b.op is None else E.ellw_matvec(
                b.grad, phi[t][b.base:b.base + b.n_win].contiguous()).reshape(-1, self.base.dim)
        return out

    def drift_values(self, tag, gradphi):
        b = self.s.blocks[tag]
        return None if b.op is None else P.drift_fill(b.op, b.grads, b.vols, gradphi)

    def matvec_batch(self, tag, X, Dr):
        b, s = self.s.blocks[tag], self.base.sub[tag]
        rows = X.new_zeros(X.shape[0], 0) if b.op is None else P.knp_apply_batch(
            X[:, b.base:b.base + b.n_win].contiguous(), b.op, s["coef"], self.s.M[tag],
            self.s.kst[tag], Dr)[:, b.lo:b.hi]
        return self.s.gather([rows], [self.s.sizes[tag]], "rows")[0]

    def matvec_one(self, tag, k, x, Dr):
        b, ion = self.s.blocks[tag], self.base.ions[k]
        rows = x.new_zeros(0) if b.op is None else P.knp_apply(
            x[b.base:b.base + b.n_win].contiguous(), b.op, self.s.ion_vals[tag][k], Dr,
            ion.z * self.base.params.psi * ion.D[tag])[b.lo:b.hi]
        return self.s.gather([rows], [self.s.sizes[tag]], "rows")[0]

    def rhs(self, c, phi, phi_M, I_ch=None, source_gate=1.0):
        sys_, s = self.base, self.s
        Ns = sys_.n_solved
        if torch.is_tensor(source_gate):
            source_gate = source_gate.to(sys_.dtype)
        rows = []
        for t in sys_.tags:
            b = s.blocks[t]
            rows.append(c[t].new_zeros(Ns, 0) if b.op is None else P.knp_apply_batch(
                c[t][:Ns, b.base:b.base + b.n_win].contiguous(), b.op,
                sys_.sub[t]["coef_mass"], s.M[t])[:, b.lo:b.hi])
        got = s.gather(rows, [s.sizes[t] for t in sys_.tags], "rows")
        r = {}
        for t, rt in zip(sys_.tags, got):
            r[t] = rt
            if sys_._src_vec[t] is not None:
                r[t] = r[t] + source_gate * sys_._src_vec[t]
        for m, mb in sys_.mem.items():
            ct = mb["cell_tag"]
            m2e, m2i = mb["mem_to_ecs"], mb["mem_to_ics"]
            X = torch.cat([c[0][:, m2e], c[ct][:, m2i], (phi[ct][m2i] - phi[0][m2e])[None],
                           phi_M[m][None], I_ch[m]], dim=0)
            G = A.facet_gather(X, mb["op"].cells)
            vals = sys_._robin_facet_values(ct, G, mb["areas"])
            b, (_, fids) = s.mem_blocks[m], s.mem_vals[m]
            Yr = (vals.new_zeros(vals.shape[0], 0) if b.op is None else
                  A.facet_scatter(vals[:, fids].contiguous(), b.op)[:, b.lo:b.hi])
            Y = s.gather([Yr], [s.mem_sizes[m]], "rows")[0]
            r[0] = r[0].index_add(1, m2e, Y[:Ns])
            r[ct] = r[ct].index_add(1, m2i, Y[Ns:])
        return r


class SpmdSimulation:
    """``sim.step`` / ``sim.run`` with the O(cells) work shared by the ranks
    of ``comm`` (see the module docstring); ``sim`` is this rank's own
    ``Simulation`` on ``comm.device``."""

    def __init__(self, comm, sim):
        opts = sim.opts
        if opts.direct or opts.emi_precond != "mg":
            raise ValueError("the SPMD mode needs the multigrid preconditioner "
                             "(direct and emi_precond='jacobi' are not ported to it)")
        if sim.emi_sys.mms is not None:
            raise ValueError("the SPMD mode steps a simulation, not a manufactured solution")
        if sim.device != comm.device:
            raise ValueError(f"the simulation is on {sim.device}, the rank on {comm.device}")
        self.comm, self.sim, self.opts = comm, sim, opts
        N, d = comm.world, comm.rank
        dtype, dev = sim.dtype, sim.device
        self.gather = _Gather(comm)
        self.blocks, self.sizes, self.kst, self.M, self.ion_vals = {}, {}, {}, {}, {}
        for t, sub in sim.geom.subdomains.items():
            b, _ = _block(sub.cells, sub.n_dofs, N, d, dtype, dev, sub.grads, sub.vols)
            self.blocks[t] = b
            self.sizes[t] = _sizes(slice_rows, sub.n_dofs, N)
            if b.op is None:
                continue
            gop = sim.emi_sys.sub[t]["op"]
            place = lambda v: place_row_values(b.op, csr_row_values(gop, v, b.r0, b.r1),
                                               dtype, dev)
            self.kst[t] = place(sim.emi_sys.sub[t]["kst"])
            self.M[t] = place(sim.knp_sys.sub[t]["M"])
            self.ion_vals[t] = [place(v) for v in sim.knp_sys.ion_vals.get(t, [])]
        self.mem_blocks, self.mem_sizes, self.mem_vals = {}, {}, {}
        for m, sp_ in sim.geom.membranes.items():
            b, ids = _block(sp_.facet_dofs, sp_.n_dofs, N, d, dtype, dev, maps=False)
            self.mem_blocks[m] = b
            self.mem_sizes[m] = _sizes(slice_rows, sp_.n_dofs, N)
            M = None
            if b.op is not None:
                gop = sim.emi_sys.mem[m]["op"]
                M = place_row_values(b.op, csr_row_values(gop, sim.emi_sys.mem[m]["M"], b.r0,
                                                          b.r1), dtype, dev)
            self.mem_vals[m] = (M, torch.as_tensor(ids, device=dev))
        self.emi_solver = copy.copy(sim.emi_solver)
        self.emi_solver.system = _SpmdEMI(sim.emi_sys, self)
        self.knp_solver = copy.copy(sim.knp_solver)
        self.knp_solver.system = _SpmdKNP(sim.knp_sys, self)

    def init_state(self) -> SimState:
        return self.sim.init_state()

    def gather_state(self, state: SimState) -> SimState:
        """The state is replicated: as it is."""
        return state

    def _membrane_odes(self, state: SimState):
        sim, comm = self.sim, self.comm
        dt = sim.params.dt
        first = state.step == 0
        phi_M = dict(state.phi_M)
        ode_states, ode_params, I_ch = dict(state.ode_states), dict(state.ode_params), {}
        for m, mm in sim.mem_models.items():
            m2e, m2i = sim._maps[m]
            prms, sts = update_ode_variables(mm, state.ode_params[m], state.ode_states[m],
                                             state.c, state.phi_M[m], sim.ions, first, m2e, m2i)
            a, b = ode_rows(mm.n_dofs, comm.world, comm.rank)
            sizes = _sizes(ode_rows, mm.n_dofs, comm.world)
            loc = mm.step(sts[a:b], prms[a:b], state.t, dt)
            sts = self.gather([loc.T.contiguous()], [sizes], "ode")[0].T.contiguous()
            ode_states[m], ode_params[m] = sts, prms
            phi_M[m] = mm.get_membrane_potential(sts).contiguous()
            cur = mm.currents(sts, prms, state.t + dt)
            I_ch[m] = torch.stack([cur[ion.name] for ion in sim.ions])
        return ode_states, ode_params, phi_M, I_ch

    def step(self, state: SimState) -> SimState:
        """``Simulation.step`` with the rows shared (the same bits)."""
        sim = self.sim
        dt = sim.params.dt
        ode_states, ode_params, phi_M_new, I_ch = self._membrane_odes(state)
        phi, emi_info = self.emi_solver.solve(state.c, phi_M_new, I_ch, x0=state.phi)
        c_solved, knp_info = self.knp_solver.solve(
            state.c, phi, phi_M_new, I_ch, source_gate=sim.source_gate(state.t), x0=state.c)
        c_new, phi_M_pde = update_pde_variables(sim.geom, sim.ions, sim.params, c_solved, phi,
                                                sim._maps)
        dev = sim.device
        return SimState(
            c=c_new, phi=phi, phi_M=phi_M_pde, ode_states=ode_states, ode_params=ode_params,
            t=state.t + dt, step=state.step + 1,
            emi_iters=torch.tensor(emi_info.iters, dtype=torch.int32, device=dev),
            knp_iters=torch.tensor(knp_info.iters, dtype=torch.int32, device=dev),
            emi_ok=torch.tensor(emi_info.converged, device=dev),
            knp_ok=torch.tensor(knp_info.converged, device=dev),
            emi_res=emi_info.resnorm.to(sim.dtype), knp_res=knp_info.resnorm.to(sim.dtype))

    def run(self, state: SimState, n_steps: int, save_every: Optional[int] = None,
            observer=None, verbose: bool = False):
        """``Simulation.run``'s chunks, health check and observer (no
        refresh, no checkpoints).  Returns (state, emi_iters[],
        knp_iters[])."""
        return _run_chunks(self, state, n_steps, save_every, observer, verbose)
