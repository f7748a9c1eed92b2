"""Quadrature rules on simplices, in barycentric coordinates.

The framework's weak forms are fixed (SURVEY.md section 7, design delta 1), so
only a handful of rules are needed:

* exact closed-form element matrices handle every *bilinear* term
  (P1 mass / stiffness / drift / interface mass),
* facet rules integrate the nonlinear interface coefficients of the KNP
  Robin terms (ratios of P1 traces, knpWeakForm.py:178-214 in the
  reference are integrated by FFCx-estimated quadrature there),
* cell rules integrate analytic MMS source terms.

Points are returned as barycentric weights ``(n_q, n_vertices)`` so that a
P1/trace evaluation at a quadrature point is just ``points_bary @
vertex_values``; weights sum to 1 and must be scaled by the cell/facet
measure.
"""

from __future__ import annotations

import numpy as np


def edge_gauss2():
    """2-point Gauss on an edge, exact for cubics."""
    a = 0.5 - 0.5 / np.sqrt(3.0)
    b = 0.5 + 0.5 / np.sqrt(3.0)
    pts = np.array([[1 - a, a], [1 - b, b]])
    w = np.array([0.5, 0.5])
    return pts, w


def edge_gauss3():
    """3-point Gauss on an edge, exact for quintics."""
    g = np.sqrt(3.0 / 5.0)
    xs = np.array([0.5 * (1 - g), 0.5, 0.5 * (1 + g)])
    pts = np.stack([1 - xs, xs], axis=1)
    w = np.array([5.0, 8.0, 5.0]) / 18.0
    return pts, w


def tri_midpoint3():
    """3-point midpoint rule on a triangle, exact for quadratics."""
    pts = np.array(
        [
            [0.5, 0.5, 0.0],
            [0.0, 0.5, 0.5],
            [0.5, 0.0, 0.5],
        ]
    )
    w = np.full(3, 1.0 / 3.0)
    return pts, w


def tri_dunavant4():
    """6-point Dunavant rule on a triangle, exact for quartics."""
    a1 = 0.445948490915965
    a2 = 0.091576213509771
    w1 = 0.223381589678011
    w2 = 0.109951743655322

    def perms(a):
        b = 1.0 - 2.0 * a
        return [[b, a, a], [a, b, a], [a, a, b]]

    pts = np.array(perms(a1) + perms(a2))
    w = np.array([w1] * 3 + [w2] * 3)
    return pts, w


def tet_keast4():
    """11-point Keast rule on a tetrahedron, exact for quartics."""
    pts = []
    w = []
    # centroid
    pts.append([0.25, 0.25, 0.25, 0.25])
    w.append(-0.013155555555555555)
    # 4 points
    a = 0.7857142857142857
    b = 0.07142857142857142
    for i in range(4):
        p = [b] * 4
        p[i] = a
        pts.append(p)
        w.append(0.007622222222222222)
    # 6 points
    a = 0.3994035761667992
    b = 0.1005964238332008
    import itertools

    for pair in itertools.combinations(range(4), 2):
        p = [b] * 4
        p[pair[0]] = a
        p[pair[1]] = a
        pts.append(p)
        w.append(0.024888888888888887)
    pts = np.array(pts)
    w = np.array(w)
    w = w / w.sum()  # normalize to unit measure
    return pts, w


def facet_rule(dim: int):
    """Default facet rule: membrane/boundary coefficient integration."""
    return edge_gauss2() if dim == 2 else tri_midpoint3()


def facet_rule_high(dim: int):
    return edge_gauss3() if dim == 2 else tri_dunavant4()


def cell_rule(dim: int):
    """Default cell rule for analytic (MMS) source terms."""
    return tri_dunavant4() if dim == 2 else tet_keast4()


def vertex_rule(n_vertices: int):
    """Vertex (trapezoidal) rule — exact for P1, lumps products."""
    pts = np.eye(n_vertices)
    w = np.full(n_vertices, 1.0 / n_vertices)
    return pts, w
