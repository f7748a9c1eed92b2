"""Operators of the port: host geometry and quadrature, the plain element
kernels, and the hand-written CUDA kernels with their wrappers
(``assembly``, ``p1op``, ``ell``, ``banded``; sources in ``csrc/``)."""

from .geometry import (
    DiscreteGeometry,
    SubdomainSpace,
    MembraneSpace,
    BoundarySpace,
    build_geometry,
)
from . import quadrature
from . import kernels

__all__ = [
    "DiscreteGeometry",
    "SubdomainSpace",
    "MembraneSpace",
    "BoundarySpace",
    "build_geometry",
    "quadrature",
    "kernels",
    "kernel_table",
    "reset_launch_counts",
    "launch_counts",
]


def kernel_table():
    """{name: (wrapper, plain version)} of every hand-written kernel."""
    from . import assembly, banded, ell, p1op

    return {**assembly.KERNELS, **p1op.KERNELS, **ell.KERNELS, **banded.KERNELS}


def reset_launch_counts():
    """Every kernel's count to 0, and ``ell.csr_add.launches``, the far
    remainder's share of K5's and K6b's."""
    from . import ell

    for wrapper, _ in kernel_table().values():
        wrapper.launches = 0
    ell.csr_add.launches = 0


def launch_counts():
    return {name: wrapper.launches for name, (wrapper, _) in kernel_table().items()}
