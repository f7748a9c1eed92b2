"""Campaign tools of the port, run with ``python -m``:

* :mod:`.summarize_campaign` -- one JSON summary of a driver campaign
  directory (``traces.npz``) and its log: K_e excursion and recovery,
  membrane potentials, per-phase ms/step and Krylov iterations;
* :mod:`.accuracy_flagship` -- float32 against float64 on the flagship
  scenario: a resumable leg in either precision and the comparison of
  two legs (or of a leg and a driver campaign directory);
* :mod:`.run_mms_ladder` -- the manufactured-solution study at the
  reference's mesh sizes (2-D, M = 100 ... 1600), the host LU or the
  SA-AMG-preconditioned Krylov path, with its convergence rates;
* :mod:`.compare_solver_opts` -- the flagship run twice from one state,
  reference-parity solver options against tuned ones, failing unless
  every field agrees to a relative tolerance;
* :mod:`.stress_mg_refresh` -- the lagged EMI hierarchy under sustained
  stimulation: a stale run against one refreshed every E steps;
* :mod:`.compute_local_width`, :mod:`.make_synthetic_emimesh`,
  :mod:`.read_meshstats`, :mod:`.find_roi_points` -- the astrocyte
  example's host mesh helpers.

Counterparts of the JAX package's ``tools/summarize_campaign.py``,
``tools/accuracy_flagship.py``, ``tools/run_mms_ladder.py``,
``tools/compare_solver_opts.py`` and ``tools/stress_mg_refresh.py``, and
of ``examples/astrocyte/tools/``; the tools write the same keys as their
JAX twins, so either package's tool reads the other's files.
"""

import subprocess


def card_line(device) -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line), or None on the CPU."""
    if str(device).split(":")[0] != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]
