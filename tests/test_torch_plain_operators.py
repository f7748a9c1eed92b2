"""The port's plain P1 element operators (``knpemi_tpu_torch/ops/kernels.py``)
against the JAX package's (``knpemi_tpu/ops/kernels.py``), function for
function, on the same seeded inputs in float64: the cells of the 3-D
manufactured-solution mesh at M = 4 (tetrahedra, both subdomains) and its
membrane facets (triangles, on the ECS side), with a P1 coefficient and
quadrature data of four points, within 1e-13 of max|y|.
"""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu.ops import kernels as JK
from knpemi_tpu_torch.mesh import unit_cube_mms_mesh
from knpemi_tpu_torch.ops import kernels as TK
from knpemi_tpu_torch.ops.geometry import build_geometry

NQ = 4


@lru_cache(maxsize=None)
def inputs(tag: int):
    """numpy inputs on subdomain ``tag`` and the membrane's ECS-side facets."""
    geom = build_geometry(unit_cube_mms_mesh(4))
    s, sp = geom.subdomains[tag], geom.membranes[1]
    rng = np.random.default_rng(7 + tag)
    nc, k = s.cells.shape
    n0 = geom.subdomains[0].n_dofs
    bary = rng.random((NQ, k))
    fbary = rng.random((NQ, sp.facet_edofs.shape[1]))
    return dict(
        n=s.n_dofs, cells=s.cells.astype(np.int64), grads=s.grads, vols=s.vols,
        x=rng.standard_normal(s.n_dofs), kappa=1.0 + rng.random(s.n_dofs),
        w_cell=rng.standard_normal((nc, s.grads.shape[-1])),
        w_q=rng.standard_normal((nc, NQ, s.grads.shape[-1])),
        f_q=rng.standard_normal((nc, NQ)), bary=bary / bary.sum(1, keepdims=True),
        qw=rng.random(NQ),
        n0=n0, fdofs=sp.facet_edofs.astype(np.int64), areas=sp.areas,
        xe=rng.standard_normal(n0), coeff_fq=rng.standard_normal((len(sp.areas), NQ)),
        fbary=fbary / fbary.sum(1, keepdims=True))


# each case: the function's name and its arguments as names of `inputs`
# (a number stands for itself); the same call on both packages
CASES = {
    "scatter_add": ("n", "cells", "w_q4"),
    "cell_gradients": ("x", "cells", "grads"),
    "stiffness_cell_values": ("x", "cells", "grads", "vols", "kappa", 0.7),
    "stiffness_apply": ("n", "x", "cells", "grads", "vols", "kappa", 0.7),
    "mass_cell_values": ("x", "cells", "vols", 1.3),
    "mass_apply": ("n", "x", "cells", "vols", 1.3),
    "drift_cell_values": ("x", "cells", "grads", "vols", "w_cell", -0.4),
    "drift_apply": ("n", "x", "cells", "grads", "vols", "w_cell", -0.4),
    "drift_cell_values_quad": ("x", "cells", "grads", "vols", "w_q", "bary", "qw", 0.9),
    "drift_apply_quad": ("n", "x", "cells", "grads", "vols", "w_q", "bary", "qw", 0.9),
    "grad_inner_rhs": ("n", "x", "cells", "grads", "vols", 2.5),
    "mass_rhs": ("n", "x", "cells", "vols", 0.6),
    "source_rhs_quad": ("n", "f_q", "cells", "vols", "bary", "qw"),
    "facet_mass_values": ("xf", "areas", 1.7),
    "facet_mass_diag_values": ("areas", 3, 1.7),
    "facet_rhs_quad": ("n0", "coeff_fq", "fdofs", "areas", "fbary", "qw"),
    "trace_at_quad": ("xe", "fdofs", "fbary"),
}


def _args(tag: int, names, to):
    d = inputs(tag)
    # derived inputs: per-cell values to scatter, the facets' P1 values
    extra = dict(w_q4=d["w_q"][..., 0][:, : d["cells"].shape[1]],
                 xf=d["xe"][d["fdofs"]])
    out = []
    for a in names:
        if not isinstance(a, str):
            out.append(a)
        elif a in ("n", "n0"):
            out.append(int(d[a]))
        else:
            out.append(to(extra[a] if a in extra else d[a]))
    return out


@pytest.mark.parametrize("tag", [0, 1], ids=["ecs", "ics"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_operator_matches_jax(name, tag):
    names = CASES[name]
    y = getattr(TK, name)(*_args(tag, names, lambda a: torch.as_tensor(np.asarray(a))))
    ref = np.asarray(getattr(JK, name)(*_args(tag, names, lambda a: jnp.asarray(np.asarray(a)))))
    y = y.numpy()
    assert y.shape == ref.shape and y.dtype == np.float64
    assert np.abs(ref).max() > 0
    assert np.abs(y - ref).max() <= 1e-13 * np.abs(ref).max()
