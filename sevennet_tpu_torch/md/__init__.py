"""Molecular dynamics on the card (PyTorch port of ``sevennet_tpu/md``):
:class:`MDEngine` runs NVE with on-device neighbour rebuilds through the
fused-conv model."""

from .engine import MDEngine
from .integrators import nve_step
from .neighbor import CellListSpec, build_cell_list_spec, rebuild_neighbors
from .state import ATOMIC_MASSES, MDState, init_md_state

__all__ = [
    "MDEngine",
    "MDState",
    "init_md_state",
    "nve_step",
    "CellListSpec",
    "build_cell_list_spec",
    "rebuild_neighbors",
    "ATOMIC_MASSES",
]
