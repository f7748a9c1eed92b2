"""The multi-device modes on ``torch.distributed`` ranks.

Counterpart of ``knpemi_tpu/parallel/`` (its README section "Multi-chip"):

* :mod:`.comm` -- ``Comm`` (a rank's collectives, counted by site) and
  ``launch`` (spawned ranks, ``file://`` rendezvous, a deadline); NCCL
  with one card per rank, gloo on the CPU or, staged through the host,
  for several ranks on one card;
* :mod:`.spmd` -- ``SpmdSimulation``: replicated dofs and hierarchies,
  each rank's share of the rows of every operator, bitwise the
  single-device step;
* :mod:`.sharded` -- ``ShardedSimulation``: dof-sharded domain
  decomposition with halo exchanges, distributed Krylov dots and the
  distributed V-cycle of :mod:`.sharded_mg` (``distributed_mg=False``:
  the replicated hierarchy);
* :mod:`.programs` -- the rank programs the tests and ``chip_smoke.py``
  launch.

Importing this package starts no process and initialises no process
group.
"""

from .comm import Comm, launch
from .sharded import ShardedSimulation
from .spmd import SpmdSimulation

__all__ = ["Comm", "launch", "ShardedSimulation", "SpmdSimulation"]
