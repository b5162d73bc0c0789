"""Integrators (PyTorch port of ``sevennet_tpu/md/integrators.py``):
velocity-Verlet NVE. A pure function of :class:`~.state.MDState`; the
force evaluation comes from the engine. The JAX package's other
integrators (Langevin, Nose-Hoover chain, Berendsen and MTK NPT) are not
ported yet (ROADMAP A.3): they raise.
"""

from __future__ import annotations

from .state import EV_A_AMU_TO_A_FS2, MDState

__all__ = ["nve_step", "langevin_step", "nose_hoover_step", "berendsen_npt_step",
           "mtk_npt_step"]


def _accel(state: MDState):
    return state.forces / state.masses[:, None] * EV_A_AMU_TO_A_FS2 * state.atom_mask[:, None]


def nve_step(state: MDState, forces_fn, dt: float) -> MDState:
    """One velocity-Verlet step. ``forces_fn(state) -> (forces, energy,
    stress)`` on the state's current neighbour list."""
    mask = state.atom_mask[:, None]
    v_half = state.velocities + 0.5 * dt * _accel(state)
    state = state.replace(positions=state.positions + dt * v_half * mask)
    forces, energy, stress = forces_fn(state)
    state = state.replace(forces=forces, potential_energy=energy, stress=stress)
    v_new = v_half + 0.5 * dt * _accel(state)
    return state.replace(velocities=v_new * mask, step=state.step + 1)


def _not_ported(name: str):
    def step(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP A.3); use nve_step")

    step.__name__ = name
    return step


langevin_step = _not_ported("langevin_step")
nose_hoover_step = _not_ported("nose_hoover_step")
berendsen_npt_step = _not_ported("berendsen_npt_step")
mtk_npt_step = _not_ported("mtk_npt_step")
