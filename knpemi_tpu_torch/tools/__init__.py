"""Campaign tools of the port, run with ``python -m``:

* :mod:`.summarize_campaign` -- one JSON summary of a driver campaign
  directory (``traces.npz``) and its log: K_e excursion and recovery,
  membrane potentials, per-phase ms/step and Krylov iterations;
* :mod:`.accuracy_flagship` -- float32 against float64 on the flagship
  scenario: a resumable leg in either precision and the comparison of
  two legs (or of a leg and a driver campaign directory).

Counterparts of the JAX package's ``tools/summarize_campaign.py`` and
``tools/accuracy_flagship.py``; their outputs have the same keys, so
either package's tool reads the other's files.
"""
