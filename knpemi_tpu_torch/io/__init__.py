"""Host-side I/O of the port: checkpoints (npz), XDMF meshes and time
series (h5py, imported inside the functions that need it) and post-hoc
probing of a saved series — the JAX package's ``io``, with
``torch.distributed.checkpoint`` directories in place of its orbax
checkpoints."""

from .checkpoint import (
    load_checkpoint, load_checkpoint_dcp, save_checkpoint, save_checkpoint_dcp,
)
from .probe import TimeSeriesReader, evaluate_p1, locate_points
from .xdmf import TimeSeriesWriter, read_mesh, write_mesh

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_dcp",
    "load_checkpoint_dcp",
    "read_mesh",
    "write_mesh",
    "TimeSeriesWriter",
    "TimeSeriesReader",
    "evaluate_p1",
    "locate_points",
]
