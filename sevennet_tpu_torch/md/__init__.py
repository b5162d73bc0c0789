"""Molecular dynamics on the card (PyTorch port of ``sevennet_tpu/md``):
:class:`MDEngine` runs NVE, NVT (Langevin, Nose-Hoover chain) and NPT (MTK,
Berendsen) with on-device neighbour rebuilds through the fused-conv model,
with Grimme D3 dispersion on request."""

from .engine import INTEGRATORS, MDEngine
from .integrators import (berendsen_npt_step, langevin_step, mtk_npt_step, nose_hoover_step,
                          npt_conserved_quantity, nve_step)
from .neighbor import CellListSpec, build_cell_list_spec, rebuild_neighbors
from .state import ATOMIC_MASSES, MDState, init_md_state

__all__ = [
    "MDEngine",
    "INTEGRATORS",
    "MDState",
    "init_md_state",
    "nve_step",
    "langevin_step",
    "nose_hoover_step",
    "mtk_npt_step",
    "berendsen_npt_step",
    "npt_conserved_quantity",
    "CellListSpec",
    "build_cell_list_spec",
    "rebuild_neighbors",
    "ATOMIC_MASSES",
]
