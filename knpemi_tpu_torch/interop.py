"""Carry a simulation state between the JAX package and this port.

``state_from_numpy`` takes a JAX ``SimState`` after ``jax.device_get``
(any object with the same fields holding numpy arrays or scalars) and
returns the port's :class:`~knpemi_tpu_torch.systems.types.SimState`;
``state_to_numpy`` goes back to plain numpy.  ``hierarchy_to_numpy``
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
