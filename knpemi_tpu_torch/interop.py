"""Carry a simulation state between the JAX package and this port.

``state_from_numpy`` takes a JAX ``SimState`` after ``jax.device_get``
(any object with the same fields holding numpy arrays or scalars) and
returns the port's :class:`~knpemi_tpu_torch.systems.types.SimState`;
``state_to_numpy`` goes back to plain numpy.  ``scatter_state`` cuts a
whole-domain state (the port's, or the JAX package's, whose sharded
mode pads every dof array to N B) into the blocks of the dof-sharded
mode's ranks (``parallel/sharded.py``), ``gather_state`` puts them back
together.  ``hierarchy_to_numpy``
lays a host multigrid hierarchy of either package out as plain numpy, so
the two builds can be compared field by field.  None imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .systems.types import SimState

_FIELD_DICTS = ("c", "phi", "phi_M", "ode_states", "ode_params")


def state_from_numpy(tree, device, dtype) -> SimState:
    conv = lambda a, d: torch.tensor(np.asarray(a), dtype=d, device=device)
    fields = {f: {k: conv(v, dtype) for k, v in getattr(tree, f).items()}
              for f in _FIELD_DICTS}
    return SimState(
        **fields,
        t=conv(tree.t, torch.float64),
        step=conv(tree.step, torch.int32),
        emi_iters=conv(tree.emi_iters, torch.int32),
        knp_iters=conv(tree.knp_iters, torch.int32),
        emi_ok=conv(tree.emi_ok, torch.bool),
        knp_ok=conv(tree.knp_ok, torch.bool),
        emi_res=conv(tree.emi_res, dtype),
        knp_res=conv(tree.knp_res, dtype),
    )


def state_to_numpy(state: SimState) -> dict:
    """{field: numpy array, or {tag: numpy array} for the per-tag fields}."""
    out = {}
    for f in SimState.__dataclass_fields__:
        v = getattr(state, f)
        if isinstance(v, dict):
            out[f] = {k: t.detach().cpu().numpy() for k, t in v.items()}
        else:
            out[f] = v.detach().cpu().numpy()
    return out


_LEVEL_FIELDS = ("n", "omega", "steps", "diag", "a_cols", "a_vals", "p_cols", "p_vals",
                 "pt_cols", "pt_vals")
_ELLW_FIELDS = ("n_rows", "n_cols", "C", "K", "NCH", "Wr", "G", "far_cap",
                "q", "lidx", "vals", "far_rows", "far_cols", "far_vals")


def band_to_numpy(band):
    if band is None:
        return None
    windows, far_rows, far_cols, far_vals, n, m = band
    return dict(
        windows=[dict(slabT=np.asarray(sT), w0=np.asarray(w0), W=int(W))
                 for sT, w0, W in windows],
        far_rows=np.asarray(far_rows), far_cols=np.asarray(far_cols),
        far_vals=np.asarray(far_vals), n=int(n), m=int(m),
    )


def ellw_to_numpy(e):
    return None if e is None else {f: getattr(e, f) for f in _ELLW_FIELDS}


def hierarchy_to_numpy(hier) -> dict:
    """A host ``MGHierarchy`` — the JAX package's or the port's, built
    with or without ``banded`` — as nested dicts and lists of numpy arrays
    and numbers: per level the ELL operators, the diagonal and smoother
    weight, the prolongator's CSR arrays, every block-banded layout
    (windows with slab, starts and width; far lists) and every
    windowed-ELL layout (all ``ELLW`` fields), then the coarse factors
    and the permutation.  A layout a level does not have is None."""
    levels = []
    for lv in hier.levels:
        d = {f: getattr(lv, f) for f in _LEVEL_FIELDS}
        P = lv.P_csr.tocsr()
        d["P_csr"] = dict(shape=P.shape, indptr=P.indptr, indices=P.indices,
                          data=P.data)
        for w in ("a", "p", "pt", "ap"):
            d[w + "_band"] = band_to_numpy(getattr(lv, w + "_band", None))
            d[w + "_ellw"] = ellw_to_numpy(getattr(lv, w + "_ellw", None))
        levels.append(d)
    return dict(levels=levels, coarse_V=hier.coarse_V,
                coarse_ilam=hier.coarse_ilam, nu=hier.nu, perm=hier.perm)


_SCALARS = ("t", "step", "emi_iters", "knp_iters", "emi_ok", "knp_ok", "emi_res", "knp_res")


def owned_rows(n: int, n_ranks: int, rank: int):
    """The rows [r0, r1) of an n-dof subdomain that a rank of the sharded
    mode owns: contiguous blocks of B = ceil(n / N), the last ragged."""
    B = -(-n // n_ranks)
    r0 = min(rank * B, n)
    return r0, min(r0 + B, n)


def _host(v, dtype=None):
    t = v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def scatter_state(sim, state, n_ranks: int) -> list:
    """A whole-domain state -> one host ``SimState`` per rank of the sharded
    mode (``n_ranks`` of them), holding that rank's rows of ``c`` and
    ``phi`` and the whole membrane arrays, floats in ``sim.dtype``.
    ``state``: the port's ``SimState`` on any device, or any object with
    its fields holding numpy arrays (the JAX package's after
    ``jax.device_get``; its padded-global dof arrays, longer than n, are
    cut to n)."""
    dt = sim.dtype
    blocks = []
    for d in range(n_ranks):
        c, phi = {}, {}
        for t, sub in sim.geom.subdomains.items():
            r0, r1 = owned_rows(sub.n_dofs, n_ranks, d)
            c[t] = _host(state.c[t], dt)[:, r0:r1].contiguous()
            phi[t] = _host(state.phi[t], dt)[r0:r1].contiguous()
        rep = {f: {k: _host(v, dt) for k, v in getattr(state, f).items()}
               for f in ("phi_M", "ode_states", "ode_params")}
        sc = {f: _host(getattr(state, f)) for f in _SCALARS}
        sc["t"] = sc["t"].to(torch.float64)
        sc["emi_res"], sc["knp_res"] = sc["emi_res"].to(dt), sc["knp_res"].to(dt)
        blocks.append(SimState(c=c, phi=phi, **rep, **sc))
    return blocks


def gather_state(sim, blocks: list) -> SimState:
    """The ranks' blocks (``scatter_state``'s, on any device) -> the
    whole-domain host state."""
    c = {t: torch.cat([_host(b.c[t]) for b in blocks], dim=1) for t in blocks[0].c}
    phi = {t: torch.cat([_host(b.phi[t]) for b in blocks]) for t in blocks[0].phi}
    b0 = blocks[0]
    rep = {f: {k: _host(v) for k, v in getattr(b0, f).items()}
           for f in ("phi_M", "ode_states", "ode_params")}
    return SimState(c=c, phi=phi, **rep, **{f: _host(getattr(b0, f)) for f in _SCALARS})
