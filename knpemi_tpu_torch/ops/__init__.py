"""Operators of the port: host geometry and quadrature, the plain element
kernels, and the hand-written CUDA kernels with their wrappers
(``assembly``, ``ell``, ``banded``; sources in ``csrc/``)."""


def kernel_table():
    """{name: (wrapper, plain version)} of every hand-written kernel."""
    from . import assembly, banded, ell

    return {**assembly.KERNELS, **ell.KERNELS, **banded.KERNELS}


def reset_launch_counts():
    for wrapper, _ in kernel_table().values():
        wrapper.launches = 0


def launch_counts():
    return {name: wrapper.launches for name, (wrapper, _) in kernel_table().items()}
