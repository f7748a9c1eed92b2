"""One KNP-EMI splitting step, written plainly in PyTorch from the
configuration's own numbers.

The reference the benchmark holds the program to.  It imports nothing of
the program: the mesh and its P1 spaces come from :mod:`.mesh`, the
membrane models from :mod:`.membrane`, the physics from the
configuration file.  Every operator is assembled as a sparse matrix
from element matrices and solved to a relative residual of ``tol``
(float64 by default):

  [1] membrane ODEs: the traces of the concentrations into the models'
      parameters, V from phi_M (kept at the model's rest on step 0),
      ``n_steps_ODE`` RK4 substeps, the channel currents at t + dt;
  [2] EMI: sum_s int kappa_s grad phi_s . grad v_s + C_phi int_Gamma
      (phi_i - phi_e)(v_i - v_e) = -sum_k F z_k D_k int grad c_k . grad v
      + C_phi int_Gamma phi_M (v_i - v_e), kappa = F psi sum_k z_k^2 D_k c_k
      averaged over each cell's vertices; pure Neumann, solved by
      deflated Jacobi CG orthogonal to the constants;
  [3] KNP, per subdomain and solved ion: (1/dt) M + D K + z psi D Dr,
      Dr_ij = vol / 4 (grad phi . grad l_i), with the gated ECS source and
      the membrane Robin terms (midpoint rule on each facet) on the
      right, solved by Jacobi BiCGSTAB;
  [4] the eliminated ion from electroneutrality, phi_M from the traces
      of phi.

``store`` rounds each phase's output (the control: a storage precision
below the configuration's).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

from . import membrane as memb
from . import mesh as meshmod

# 11-point Keast rule on a tetrahedron (barycentric points, weights of a
# unit measure), exact for quartics: the source term's box indicator
_KA, _KB = 0.7857142857142857, 0.07142857142857142
_KC, _KD = 0.3994035761667992, 0.1005964238332008
KEAST_PTS = np.array(
    [[0.25] * 4]
    + [[_KA if i == j else _KB for i in range(4)] for j in range(4)]
    + [[_KC if i in pair else _KD for i in range(4)]
       for pair in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))])
KEAST_W = np.array([-0.013155555555555555] + [0.007622222222222222] * 4
                   + [0.024888888888888887] * 6)
KEAST_W = KEAST_W / KEAST_W.sum()
# the 3-point midpoint rule on a triangle: the membrane Robin terms
TRI_PTS = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
TRI_W = np.full(3, 1.0 / 3.0)


def pattern_graph(cells: np.ndarray, n: int) -> sp.csr_matrix:
    """The vertex graph of a cell list (host)."""
    k = cells.shape[1]
    r = np.repeat(cells, k, axis=1).ravel()
    c = np.tile(cells, (1, k)).ravel()
    return sp.csr_matrix((np.ones(r.size, np.int8), (r, c)), shape=(n, n))


def _pattern(rows, cols, n, device):
    """CSR (crow, col) of the pairs (rows, cols) and each pair's slot."""
    key = rows.reshape(-1) * n + cols.reshape(-1)
    uniq, slot = torch.unique(key, return_inverse=True)
    r, c = uniq // n, uniq % n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    return crow, c, slot.reshape(rows.shape)


class Operator:
    """A sparse square matrix of a fixed pattern whose values are summed
    from element contributions: ``fill([(slot, values), ...])``."""

    def __init__(self, crow, col, n, dtype):
        self.crow, self.col, self.n = crow, col, n
        self.row = torch.repeat_interleave(torch.arange(n, device=col.device),
                                           crow[1:] - crow[:-1])
        self.dtype = dtype
        self.val = None

    def fill(self, parts):
        v = torch.zeros(self.col.shape[0], dtype=self.dtype, device=self.col.device)
        for slot, vals in parts:
            v.index_add_(0, slot.reshape(-1), vals.reshape(-1))
        return self._set(v)

    def _set(self, v):
        self.val = v
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
            self.mat = torch.sparse_csr_tensor(self.crow, self.col, v, (self.n, self.n),
                                               check_invariants=False)
        return self

    def scaled(self, s):
        """S A S, S = diag(s), on the same pattern."""
        out = Operator.__new__(Operator)
        out.crow, out.col, out.n, out.row, out.dtype = self.crow, self.col, self.n, self.row, self.dtype
        return out._set(self.val * s[self.row] * s[self.col])

    def diag(self):
        d = torch.zeros(self.n, dtype=self.dtype, device=self.col.device)
        on = self.row == self.col
        return d.index_add_(0, self.row[on], self.val[on])

    def __matmul__(self, x):
        return self.mat @ x


def cg(A: Callable, b, x0, M: Callable, project: Callable, tol: float, maxiter: int,
       every: int = 50):
    """Preconditioned CG on the range of ``project``; stops at ||r|| <= tol
    ||b||, tested every ``every`` iterations."""
    b = project(b)
    x = project(x0)
    r = b - project(A(x))
    z = project(M(r))
    p = z
    rz = torch.dot(r, z)
    bn = float(torch.linalg.vector_norm(b))
    for k in range(maxiter):
        if k % every == 0 and float(torch.linalg.vector_norm(r)) <= tol * bn:
            return x, k
        Ap = project(A(p))
        alpha = rz / torch.dot(p, Ap)
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, Ap, value=-1.0)
        z = project(M(r))
        rz_new = torch.dot(r, z)
        p = torch.addcmul(z, rz_new / rz, p)
        rz = rz_new
    raise RuntimeError(f"reference CG did not reach {tol:g} in {maxiter} iterations")


def bicgstab(A: Callable, b, x0, dinv, tol: float, maxiter: int, every: int = 5):
    """Jacobi-preconditioned BiCGSTAB; stops at ||r|| <= tol ||b||, tested
    every ``every`` iterations."""
    x = x0.clone()
    r = b - A(x)
    rh = r.clone()
    bn = float(torch.linalg.vector_norm(b))
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    for k in range(maxiter):
        if k % every == 0 and float(torch.linalg.vector_norm(r)) <= tol * bn:
            return x, k
        rho_new = torch.dot(rh, r)
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
        ph = dinv * p
        v = A(ph)
        alpha = rho_new / torch.dot(rh, v)
        s = r - alpha * v
        sh = dinv * s
        t = A(sh)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
    raise RuntimeError(f"reference BiCGSTAB did not reach {tol:g} in {maxiter} iterations")


def pulsed_gate(gate: Optional[dict], t: float) -> float:
    """1 while a pulse of the source is on at time t (``delay`` <= t <=
    ``end_time`` and (t - delay) mod ``period`` < ``pulse_width``), else 0;
    no source: 0."""
    if gate is None:
        return 0.0
    t = torch.tensor(t, dtype=torch.float64)
    on = (t >= gate["delay"]) & (t <= gate["end_time"]) \
        & (torch.remainder(t - gate["delay"], gate["period"]) < gate["pulse_width"])
    return float(on)


class Reference:
    """The plain KNP-EMI step of a configuration (its ``mesh`` and
    ``physics`` entries) under a traffic mix's ``stimulus`` (a pulsed ECS
    ``source`` and / or the synaptic ``g_syn_bar``) on ``device``."""

    def __init__(self, config: dict, traffic: dict, device, dtype=torch.float64,
                 tol: float = 1e-11, geom: Optional[meshmod.Geometry] = None):
        dev = torch.device(device)
        self.device, self.dtype, self.tol = dev, dtype, tol
        self.geom = geom or meshmod.build(config["mesh"])
        ph = config["physics"]
        self.ph = ph
        self.dt = float(ph["dt"])
        self.F, self.C_M = float(ph["F"]), float(ph["C_M"])
        self.psi = self.F / (float(ph["R"]) * float(ph["temperature"]))
        self.C_phi = self.C_M / self.dt
        self.ions = ph["ions"]
        self.z = [float(i["z"]) for i in self.ions]
        self.Ns = len(self.ions) - 1
        g = self.geom
        self.tags = g.tags
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)
        self.D = {t: [float(ion["D"][str(t)]) for ion in self.ions] for t in self.tags}

        # per subdomain: the P1 pattern, unit stiffness and mass element matrices
        self.sub = {}
        for t in self.tags:
            s = g.subdomains[t]
            cells = i64(s.cells)
            crow, col, slot = _pattern(cells[:, :, None].expand(-1, -1, 4),
                                       cells[:, None, :].expand(-1, 4, -1), s.n, dev)
            grads, vols = f(s.grads), f(s.vols)
            Ke = torch.einsum("cid,cjd->cij", grads, grads) * vols[:, None, None]
            Me = (torch.ones(4, 4, dtype=dtype, device=dev)
                  + torch.eye(4, dtype=dtype, device=dev)) * (vols / 20.0)[:, None, None]
            K = Operator(crow, col, s.n, dtype).fill([(slot, Ke)])
            M = Operator(crow, col, s.n, dtype).fill([(slot, Me)])
            self.sub[t] = dict(n=s.n, cells=cells, grads=grads, vols=vols, slot=slot,
                               crow=crow, col=col, Ke=Ke, Me=Me, K=K, M=M)

        # the EMI operator's pattern: every subdomain block and the membranes'
        # cross blocks, on the dofs of all subdomains in tag order
        self.off, n = {}, 0
        for t in self.tags:
            self.off[t] = n
            n += g.subdomains[t].n
        self.n_emi = n
        rows, cols = [], []
        for t in self.tags:
            c = self.sub[t]["cells"] + self.off[t]
            rows.append(c[:, :, None].expand(-1, -1, 4))
            cols.append(c[:, None, :].expand(-1, 4, -1))
        self.mem = {}
        for m, mb in g.membranes.items():
            fac = i64(mb.facets)
            e = i64(mb.to_ecs)[fac] + self.off[0]
            i = i64(mb.to_ics)[fac] + self.off[mb.cell_tag]
            for a, b in ((i, i), (i, e), (e, i), (e, e)):
                rows.append(a[:, :, None].expand(-1, -1, 3))
                cols.append(b[:, None, :].expand(-1, 3, -1))
            areas = f(mb.areas)
            Mf = (torch.ones(3, 3, dtype=dtype, device=dev)
                  + torch.eye(3, dtype=dtype, device=dev)) * (areas / 12.0)[:, None, None]
            self.mem[m] = dict(ct=mb.cell_tag, fac=fac, areas=areas, Mf=Mf,
                               to_ecs=i64(mb.to_ecs), to_ics=i64(mb.to_ics), n=mb.n)
        sizes = [r.numel() for r in rows]
        crow, col, slot = _pattern(torch.cat([r.reshape(-1) for r in rows]),
                                   torch.cat([c.reshape(-1) for c in cols]), n, dev)
        parts = list(torch.split(slot, sizes))
        self.emi = Operator(crow, col, n, dtype)
        for t in self.tags:
            self.sub[t]["emi_slot"] = parts.pop(0)
        for m in self.mem:
            self.mem[m]["emi_slots"] = [parts.pop(0) for _ in range(4)]
        # the deflation space of the EMI CG: the indicator of each connected
        # piece of every ICS subdomain (each is a near-null mode, coupled to
        # the ECS through the membrane alone)
        cols = []
        for t in self.tags:
            if t == 0:
                continue
            s = g.subdomains[t]
            k, label = connected_components(pattern_graph(s.cells, s.n), directed=False)
            for j in range(k):
                w = torch.zeros(n, dtype=dtype, device=dev)
                w[self.off[t]: self.off[t] + s.n] = torch.as_tensor(label == j, dtype=dtype)
                cols.append(w)
        self.W = torch.stack(cols, dim=1)

        # the ECS source: each ion's load vector of value * box indicator
        self.src = {}
        stimulus = traffic.get("stimulus", {})
        src = stimulus.get("source")
        self.gate = None if src is None else src
        if src is not None:
            s = g.subdomains[0]
            xq = np.einsum("qk,ckd->cqd", KEAST_PTS, g.subdomains[0].coords[s.cells])
            lo, hi = (np.asarray(b) for b in ph["source_box"])
            box = ((xq > lo) & (xq < hi)).all(axis=-1).astype(np.float64)
            load = f(np.einsum("cq,q,qk->ck", box, KEAST_W, KEAST_PTS) * s.vols[:, None])
            for k, ion in enumerate(self.ions[: self.Ns]):
                v = float(src["f_value"]) * float(ph["source_signs"].get(ion["name"], 0.0))
                self.src[k] = torch.zeros(s.n, dtype=dtype, device=dev).index_add_(
                    0, self.sub[0]["cells"].reshape(-1), (v * load).reshape(-1))

        # the membrane models and their constant parameters
        self.models = {}
        for mkey, spec in ph["membranes"].items():
            m = int(mkey)
            model = memb.MODELS[spec["model"]]
            mb = g.membranes[m]
            p = np.tile(np.asarray(model["defaults"], np.float64), (mb.n, 1))
            consts = dict(Cm=self.C_M, psi=self.psi, **{f"z_{i['name']}": i["z"] for i in self.ions})
            consts.update(spec.get("set", {}))
            for name, v in consts.items():
                if name in model["params"]:
                    p[:, model["params"].index(name)] = v
            # the synaptic stimulus on the dofs left of x = stim_x_below
            mask = mb.coords[:, 0] < spec["stim_x_below"]
            p[mask, model["params"].index("stim_amplitude")] = float(
                stimulus.get("g_syn_bar", 0.0))
            self.models[m] = dict(model=model, params=f(p))

    # -- state ------------------------------------------------------------
    def initial_state(self) -> dict:
        """The configuration's state at t = 0: initial concentrations, zero
        potentials, the models at rest."""
        g, dev, dt = self.geom, self.device, self.dtype
        c = {t: torch.tensor([[float(ion["c_init"][str(t)])] * g.subdomains[t].n
                              for ion in self.ions], dtype=dt, device=dev) for t in self.tags}
        ode = {m: torch.tensor(self.ph["membranes"][str(m)]["rest"], dtype=dt, device=dev)
               .repeat(g.membranes[m].n, 1) for m in self.models}
        V = {m: ode[m][:, self.models[m]["model"]["states"].index("V")].clone() for m in ode}
        return dict(c=c, phi={t: torch.zeros(g.subdomains[t].n, dtype=dt, device=dev)
                              for t in self.tags}, phi_M=V, ode=ode, t=0.0, step=0)

    # -- the phases -------------------------------------------------------
    def odes(self, st):
        phi_M, ode, I = {}, {}, {}
        names = [ion["name"] for ion in self.ions]
        for m, mm in self.models.items():
            model, me = mm["model"], self.mem[m]
            p = mm["params"].clone()
            for k, nm in enumerate(names):
                if f"{nm}_e" in model["params"]:
                    p[:, model["params"].index(f"{nm}_e")] = st["c"][0][k][me["to_ecs"]]
                    p[:, model["params"].index(f"{nm}_i")] = st["c"][me["ct"]][k][me["to_ics"]]
            y = st["ode"][m].clone()
            iv = model["states"].index("V")
            if st["step"] != 0:
                y[:, iv] = st["phi_M"][m]
            y = memb.advance(model, y, p, st["t"], self.dt, int(self.ph["n_steps_ODE"]))
            ode[m] = y
            phi_M[m] = y[:, iv]
            t1 = torch.tensor(st["t"] + self.dt, dtype=self.dtype, device=self.device)
            cur = dict(zip(("Na", "K", "Cl"), model["currents"](t1, y, p)))
            I[m] = torch.stack([cur[nm] for nm in names])
        return ode, phi_M, I

    def emi_solve(self, c, phi_M, phi0):
        F, psi = self.F, self.psi
        parts, b = [], []
        for t in self.tags:
            s = self.sub[t]
            kappa = F * psi * sum(z * z * D * c[t][k]
                                  for k, (z, D) in enumerate(zip(self.z, self.D[t])))
            kbar = kappa[s["cells"]].mean(dim=1)
            parts.append((s["emi_slot"], s["Ke"] * kbar[:, None, None]))
            u = sum(F * z * D * c[t][k] for k, (z, D) in enumerate(zip(self.z, self.D[t])))
            b.append(-(s["K"] @ u))
        b = torch.cat(b)
        for m, me in self.mem.items():
            for slot, sgn in zip(me["emi_slots"], (1.0, -1.0, -1.0, 1.0)):
                parts.append((slot, sgn * self.C_phi * me["Mf"]))
            w = self.C_phi * self._facet_mass(me, phi_M[m])
            b.index_add_(0, me["to_ics"] + self.off[me["ct"]], w)
            b.index_add_(0, me["to_ecs"] + self.off[0], -w)
        A = self.emi.fill(parts)
        s = 1.0 / torch.sqrt(torch.abs(A.diag()))
        Ahat = A.scaled(s)
        Ah = lambda v: Ahat @ v
        nv = 1.0 / s
        nv = nv / torch.linalg.vector_norm(nv)
        project = lambda v: torch.addcmul(v, torch.dot(nv, v), nv, value=-1.0)
        W = self.W / s[:, None]
        G = W.T @ torch.stack([Ah(W[:, j]) for j in range(W.shape[1])], dim=1)
        Ginv = torch.linalg.inv(G)
        M = lambda v: v + W @ (Ginv @ (W.T @ v))
        x0 = torch.cat([phi0[t] for t in self.tags]) / s
        x, _ = cg(Ah, s * b, x0, M, project, self.tol, 40000)
        x = s * x
        return {t: x[self.off[t]: self.off[t] + self.sub[t]["n"]] for t in self.tags}

    def _facet_mass(self, me, u):
        """int_Gamma u v on the membrane dofs, u a P1 field on them."""
        vals = torch.einsum("fij,fj->fi", me["Mf"], u[me["fac"]])
        return torch.zeros(me["n"], dtype=self.dtype, device=self.device).index_add_(
            0, me["fac"].reshape(-1), vals.reshape(-1))

    def _robin(self, me, c, phi, phi_M, I):
        """The membrane Robin terms of every solved ion: (y_e, y_i), (Ns, n_m)."""
        ct, N, Ns, dt, C_M = me["ct"], len(self.ions), self.Ns, self.dt, self.C_M
        X = torch.cat([c[0][:, me["to_ecs"]], c[ct][:, me["to_ics"]],
                       (phi[ct][me["to_ics"]] - phi[0][me["to_ecs"]])[None],
                       phi_M[None], I], dim=0)
        fb = torch.as_tensor(TRI_PTS, dtype=self.dtype, device=self.device)
        fw = torch.as_tensor(TRI_W, dtype=self.dtype, device=self.device)
        Tq = torch.einsum("fmk,qk->fmq", X[:, me["fac"]], fb)
        ce, ci, dphi, pm, Iq = Tq[:N], Tq[N:2 * N], Tq[2 * N], Tq[2 * N + 1], Tq[2 * N + 2:]
        z = torch.tensor(self.z, dtype=self.dtype, device=self.device)

        def alpha(tag, cq):
            w = (torch.tensor(self.D[tag], dtype=self.dtype, device=self.device) * z * z)[:, None, None] * cq
            den = w.sum(dim=0)
            return w[:Ns] / torch.where(den == 0, torch.ones_like(den), den)[None]

        ae, ai = alpha(0, ce), alpha(ct, ci)
        zs = z[:Ns, None, None]
        Ce, Ci = ae * C_M / (self.F * zs * dt), ai * C_M / (self.F * zs * dt)
        tot = (dt / C_M) * Iq.sum(dim=0)[None]
        ge = pm[None] - dt / (C_M * ae) * Iq[:Ns] + tot
        gi = pm[None] - dt / (C_M * ai) * Iq[:Ns] + tot
        integ = torch.cat([Ce * (dphi[None] - ge), Ci * (gi - dphi[None])], dim=0)
        vals = torch.einsum("smq,q,qk->smk", integ, fw, fb) * me["areas"][None, :, None]
        Y = torch.zeros(2 * Ns, me["n"], dtype=self.dtype, device=self.device)
        Y.index_add_(1, me["fac"].reshape(-1), vals.reshape(2 * Ns, -1))
        return Y[:Ns], Y[Ns:]

    def knp_solve(self, c, phi, phi_M, I, t):
        Ns, dt, psi = self.Ns, self.dt, self.psi
        rhs = {tg: torch.stack([self.sub[tg]["M"] @ c[tg][k] / dt for k in range(Ns)])
               for tg in self.tags}
        gate = pulsed_gate(self.gate, t)
        for k, v in self.src.items():
            rhs[0][k] = rhs[0][k] + gate * v
        for m, me in self.mem.items():
            ye, yi = self._robin(me, c, phi, phi_M[m], I[m])
            rhs[0] = rhs[0].index_add(1, me["to_ecs"], ye)
            rhs[me["ct"]] = rhs[me["ct"]].index_add(1, me["to_ics"], yi)
        out = {}
        for tg in self.tags:
            s = self.sub[tg]
            gp = torch.einsum("ci,cid->cd", phi[tg][s["cells"]], s["grads"])
            De = (torch.einsum("cd,cid->ci", gp, s["grads"]) * (s["vols"] / 4.0)[:, None])[:, :, None] \
                .expand(-1, -1, 4)
            X = []
            for k in range(Ns):
                D = self.D[tg][k]
                A = Operator(s["crow"], s["col"], s["n"], self.dtype).fill(
                    [(s["slot"], s["Me"] / dt + D * s["Ke"] + self.z[k] * psi * D * De)])
                x, _ = bicgstab(lambda v: A @ v, rhs[tg][k], c[tg][k], 1.0 / A.diag(),
                                self.tol, 4000)
                X.append(x)
            out[tg] = torch.stack(X)
        return out

    def step(self, st: dict, store: Callable = lambda x: x) -> dict:
        ode, phi_M, I = self.odes(st)
        ode = {m: store(v) for m, v in ode.items()}
        phi_M = {m: store(v) for m, v in phi_M.items()}
        phi = self.emi_solve(st["c"], phi_M, st["phi"])
        phi = {t: store(v) for t, v in phi.items()}
        cs = self.knp_solve(st["c"], phi, phi_M, I, st["t"])
        zs = torch.tensor(self.z[: self.Ns], dtype=self.dtype, device=self.device)
        rho_z, z_el = float(self.ph["rho_z"]), self.z[-1]
        c = {}
        for t in self.tags:
            rho = float(self.ph["rho"].get(str(t), 0.0))
            el = -(torch.einsum("k,kn->n", zs, cs[t]) + rho_z * rho) / z_el
            c[t] = store(torch.cat([cs[t], el[None]]))
        pm = {m: phi[me["ct"]][me["to_ics"]] - phi[0][me["to_ecs"]] for m, me in self.mem.items()}
        return dict(c=c, phi=phi, phi_M=pm, ode=ode, t=st["t"] + self.dt, step=st["step"] + 1)

    def advance(self, st: dict, n: int, store: Callable = lambda x: x) -> dict:
        for _ in range(n):
            st = self.step(st, store)
        return st
