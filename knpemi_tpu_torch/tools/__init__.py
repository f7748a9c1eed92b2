"""Campaign tools of the port, run with ``python -m``:

* :mod:`.summarize_campaign` -- one JSON summary of a driver campaign
  directory (``traces.npz``) and its log: K_e excursion and recovery,
  membrane potentials, per-phase ms/step and Krylov iterations;
* :mod:`.accuracy_flagship` -- float32 against float64 on the flagship
  scenario: a resumable leg in either precision and the comparison of
  two legs (or of a leg and a driver campaign directory);
* :mod:`.run_mms_ladder` -- the manufactured-solution study at the
  reference's mesh sizes (2-D, M = 100 ... 1600), the host LU or the
  SA-AMG-preconditioned Krylov path, with its convergence rates.

Counterparts of the JAX package's ``tools/summarize_campaign.py``,
``tools/accuracy_flagship.py`` and ``tools/run_mms_ladder.py``; the
first two write the same keys as their JAX twins, so either package's
tool reads the other's files.
"""
