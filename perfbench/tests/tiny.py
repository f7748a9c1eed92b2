"""Tiny sizes of the benchmark's cells, for the CPU tests: the same
scenario, physics, traffic and solver, on a few hundred dofs."""

import time

import torch

from perfbench import bench


def shrink(c):
    """Cut a cell's configuration to a tiny mesh, in place."""
    cfg = c["config"]
    if cfg["scenario"] == "astrocyte":
        cfg["scenario_args"]["mesh_n"] = 8
        cfg["mesh"]["cells"] = [8, 8, 8]
    else:
        cfg["scenario_args"].update(resolution=0, l=1)
        L = 16e-6
        cfg["mesh"]["cells"] = [16, 9, 9]
        cfg["mesh"]["hi"][0] = L
        for b in cfg["mesh"]["boxes"]:
            b[1][0] = L - 5e-6


def run(workload, seed=2 ** 31 + 7, seconds=2.0, traced=False, break_step=None):
    """One benchmark run on the CPU at the tiny size."""
    torch.set_num_threads(2)
    return bench.run(workload, seed, seconds, traced, time.time(), device="cpu",
                     config_override=shrink, break_step=break_step,
                     log=lambda *a: None)
