"""Calibrate initial conditions: step the closed compartment ODE system to
its dynamic steady state.

    python -m knpemi_tpu_torch.drivers.run_calibration [--steps N] [--dt MS] \\
        [--plot FILE.png] [--device cpu]

The port's counterpart of ``examples/calibrate/run_calibration.py``:
integrates the 14-state ``calibration`` model (``models/calibration.py``)
for 10,000 steps of 0.1 ms, each of ``n_sub`` RK4 substeps
(``models.engine.rk4_step``), and prints the converged state as
``name_init = value`` lines to paste into a scenario.  It runs in
float64 on CUDA unless ``--device cpu`` asks for the CPU.  Each RK4
substep is a few hundred small launches on the card, so a run there is
bound by launches, not by arithmetic.  ``--plot`` draws the trajectory
with matplotlib, imported only then.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import get_model
from ..models.engine import rk4_step
from ..systems.types import resolve_device


def run(n_steps: int = 10_000, dt: float = 0.1, n_sub: int = 5,
        stim_amplitude: float = 0.0, plot=None, device=None, verbose: bool = True):
    """Step the model ``n_steps`` times by ``dt`` (ms) from its default
    state; returns the final state (numpy, 14).  ``plot``: a file the
    trajectory (every 50 steps) is drawn to."""
    if plot:
        try:
            import matplotlib
        except ImportError as e:
            raise RuntimeError("--plot needs matplotlib, which is not installed") from e
        matplotlib.use("Agg")
    device = resolve_device(device)
    model = get_model("calibration")
    as_t = lambda a: torch.as_tensor(np.asarray(a)[None, :], dtype=torch.float64,
                                     device=device)
    y = as_t(model.init_states())
    p = as_t(model.init_params(stim_amplitude=stim_amplitude))
    h = dt / n_sub
    traj = []
    t = 0.0
    for k in range(n_steps):
        for i in range(n_sub):
            ti = torch.tensor(t + i * h, dtype=torch.float64, device=device)
            y = rk4_step(model.rhs, ti, y, p, h)
        t += dt
        if plot and k % 50 == 0:
            traj.append(y[0].cpu().numpy())

    y = y[0].cpu().numpy()
    names = model.state_names
    if verbose:
        print("# converged state after", n_steps * dt, "ms")
        for n, v in zip(names, y):
            print(f"{n}_init = {float(v)!r}")

    if plot:
        import matplotlib.pyplot as plt

        traj = np.stack(traj)
        ts = np.arange(len(traj)) * 50 * dt
        fig, axes = plt.subplots(3, 1, figsize=(8, 10), sharex=True)
        axes[0].plot(ts, traj[:, 3], label="V_n")
        axes[0].plot(ts, traj[:, 4], label="V_g")
        axes[0].set_ylabel("mV")
        axes[0].legend()
        for i, n in enumerate(names[5:8]):
            axes[1].plot(ts, traj[:, 5 + i], label=n)
        axes[1].set_ylabel("K (mM)")
        axes[1].legend()
        for i, n in enumerate(names[8:14]):
            axes[2].plot(ts, traj[:, 8 + i], label=n)
        axes[2].set_ylabel("Na/Cl (mM)")
        axes[2].legend()
        axes[2].set_xlabel("t (ms)")
        fig.savefig(plot, dpi=120, bbox_inches="tight")
        plt.close(fig)
        if verbose:
            print("wrote", plot)
    return y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--dt", type=float, default=0.1, help="step (ms)")
    ap.add_argument("--n-sub", type=int, default=5, help="RK4 substeps a step")
    ap.add_argument("--plot", default=None, help="draw the trajectory to this file")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: CUDA); float64 on both")
    args = ap.parse_args(argv)
    run(n_steps=args.steps, dt=args.dt, n_sub=args.n_sub, plot=args.plot,
        device=args.device)


if __name__ == "__main__":
    main()
