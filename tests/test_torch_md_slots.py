"""Every pair within the cutoff holds a slot of the port's serial MD engine
at every force evaluation.

The engine keeps each atom's K nearest neighbours of its list at cutoff +
skin (K from the counts within cutoff + 0.1 skin, ``SEVENNET_TPU_KMARGIN``,
default 1.05). A pair cut beyond the cutoff can close in before the next
rebuild, so the skin test's limit is half the smaller of the skin and
``d_drop - cutoff``, ``d_drop`` the nearest cut edge, and it is taken where
the step evaluates the forces. An engine that tests half the skin before
the step (the JAX package's) misses such pairs in these runs.

The narrow model of tests/test_torch_md.py (8 channels, lmax 1, 2 layers,
cutoff 3.5 A; random weights from a seed) on its 648-atom water box at the
default skin of 0.6 A, at 600 K, 30 NVE steps of 1 fs run one at a time:
after every step the masked slots hold every ``(dst, src, shift)`` pair that
a host list at the cutoff finds at the current positions, at the default
slot margin, at a tight one (1.0) and with the ring backward forced on (the
rows sorted at each rebuild; skin 0.1 A, which the ring's window needs on
this box). The engine at the default margin tracks an engine whose slots
are not cut, atom by atom: positions within 1e-4 A, PE and KE within 1e-4
eV (fp32, sums in another order). The limit after a build equals
``(min(skin, d_drop - cutoff) / 2)^2`` with ``d_drop`` from a host list
(1e-4 relative: fp32 against float64), and with D3 the rebuild test takes
the smaller of it and the D3 list's margin.

NPT scales the positions, the build's reference positions and the cell
together, so a pair also closes by (1 - s) of its distance, s the cell's
scale since the build: the limit narrows to ``(max(0, s (cutoff + m) -
cutoff) / 2)^2`` (``md/neighbor.py:shrink_limit``; held to a float64 host
formula at 1e-6 relative). The same box at 5 K under ``npt_berendsen`` at
0.01 eV/A^3 and tau_p 50 fs, one 1 fs step at a time, shrinks by 12 %
within 30 steps (an engine that tests the displacement alone leaves 1 and
4 pairs within the cutoff without a slot after steps 30 and 31), then
past its cell grid's slack, whose cells fall below cutoff + skin after
step 31: the engine re-derives the grid (4 to 3 cells a side) and runs
on; every pair holds a slot after every step, to 6 steps past the first
build on the new grid. A capacity overflow that persists still raises
after 3 growths.
"""

import functools

import numpy as np
import pytest
import torch

from bench import water_box
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
from sevennet_tpu_torch.md import MDEngine
from sevennet_tpu_torch.md.neighbor import shrink_limit, skin_limit
from sevennet_tpu_torch.model.build import build_model_spec

torch.set_num_threads(1)
CFG = {"cutoff": 3.5, "channel": 8, "lmax": 1, "is_parity": False,
       "num_convolution_layer": 2, "self_connection_type": "linear",
       "conv_denominator": 35.0, "chemical_species": ["H", "O"], "_remat": False}
T_HOT, DT, STEPS, SEED = 600.0, 1.0, 30, 3
X_TOL, E_TOL = 1e-4, 1e-4
# slot margins (SEVENNET_TPU_KMARGIN) of each case; None: the default
CASES = {"default": None, "tight": "1.0", "ring": None, "uncut": "3.0"}
# the compressing NPT case: run keywords, temperature and seed
NPT_KW = dict(integrator="npt_berendsen", temperature=5.0, pressure=0.01, tau_p=50.0)
NPT_T, NPT_SEED, NPT_AFTER = 5.0, 3, 6  # NPT_AFTER: steps past the first build on a new grid


@functools.lru_cache(maxsize=None)
def _system():
    pos, Z, cell = water_box(216)
    spec = build_model_spec(dict(CFG, _edge_chunk=0))
    params = params_from_numpy(spec, random_params(spec, 0))
    return pos, Z, cell, spec, params


def _engine(case, monkeypatch):
    """The case's engine (``ring``: the ring backward forced on as in
    tests/test_torch_md.py, at a skin of 0.1 A)."""
    pos, Z, cell, spec, params = _system()
    skin = 0.6
    if CASES[case] is not None:
        monkeypatch.setenv("SEVENNET_TPU_KMARGIN", CASES[case])
    if case == "ring":
        monkeypatch.setenv("SEVENNET_TPU_CHUNK_THRESHOLD", "100000")
        spec = build_model_spec(dict(CFG, _edge_chunk=512))
        skin = 0.1
    return MDEngine(spec, params, cell, skin=skin, device="cpu")


def _missing(eng, st) -> int:
    """The pairs within the cutoff at the state's positions (a host list)
    that hold no masked slot."""
    rows = np.flatnonzero(st.atom_mask.numpy())
    pos = st.positions.numpy()[rows].astype(np.float64)
    dst, src, sh = neighbor_list_numpy(pos, eng.spec.cutoff, st.cell.numpy(), (True,) * 3)
    want = set(zip(rows[dst].tolist(), rows[src].tolist(),
                   *np.rint(sh).astype(int).T.tolist()))
    slot_row = np.repeat(np.arange(st.n_atoms_cap), eng.k_model)
    m = st.edge_mask.numpy()
    have = set(zip(slot_row[m].tolist(), st.edge_src.numpy()[m].tolist(),
                   *np.rint(st.edge_shift.numpy()[m]).astype(int).T.tolist()))
    return len(want - have)


@functools.lru_cache(maxsize=None)
def _trajectory(case):
    """STEPS NVE steps of the case's engine, one at a time: the pairs
    missing after each step, PE, KE, the final positions in the input
    order, the engine's K, slot capacity, growths and rebuilds."""
    pos, Z, _, _, _ = _system()
    with pytest.MonkeyPatch.context() as mp:
        eng = _engine(case, mp)
        st = eng.make_state(pos, Z, temperature=T_HOT, seed=SEED)
        out = dict(ring_nb=eng._ring_nb, k0=eng.k_model, cap0=eng.cl_spec.neighbor_capacity,
                   missing=[(0, _missing(eng, st))], pe=[], ke=[])
        for step in range(1, STEPS + 1):
            st, (pe, ke) = eng.run(st, 1, dt=DT, chunk=1)
            out["missing"].append((step, _missing(eng, st)))
            out["pe"].append(float(pe[0]))
            out["ke"].append(float(ke[0]))
    n = len(pos)
    positions = np.zeros((n, 3), np.float32)
    idx = st.atom_index.numpy()
    real = idx < n
    positions[idx[real]] = st.positions.numpy()[real]
    out.update(positions=positions, k=eng.k_model, cap=eng.cl_spec.neighbor_capacity,
               growths=eng.n_growths, rebuilds=eng.n_rebuilds, cell=st.cell.numpy())
    return out


@pytest.mark.parametrize("case", ["default", "tight", "ring"])
def test_every_pair_within_cutoff_holds_a_slot(case):
    res = _trajectory(case)
    assert res["k0"] < res["cap0"], "the slots are not cut: the case tests nothing"
    if case == "ring":
        assert res["ring_nb"] >= 3
    bad = [(step, n) for step, n in res["missing"] if n]
    assert not bad, f"(step, pairs within the cutoff without a slot): {bad}"


def test_cut_engine_tracks_uncut_engine_atom_by_atom():
    """The engine at the default margin (its slots cut) against one whose
    K equals its list's capacity, from the same state."""
    got, want = _trajectory("default"), _trajectory("uncut")
    assert want["k0"] == want["cap0"] and want["k"] == want["cap"] and want["growths"] == 0
    assert got["k0"] < got["cap0"]
    cell = want["cell"]
    frac = (got["positions"] - want["positions"]) @ np.linalg.inv(cell)
    dx = float(np.abs((frac - np.round(frac)) @ cell).max())
    assert dx <= X_TOL, dx
    for key in ("pe", "ke"):
        d = float(np.abs(np.subtract(got[key], want[key])).max())
        assert d <= E_TOL, (key, d)


def _host_limit(eng, st) -> float:
    """``(min(skin, d_drop - cutoff) / 2)^2`` of the positions at the
    state's last build, ``d_drop`` the nearest distance past each row's K
    nearest in a host list at cutoff + skin (inf: nothing cut)."""
    rows = np.flatnonzero(st.atom_mask.numpy())
    pos = st.nl_positions.numpy()[rows].astype(np.float64)
    cell = st.cell.numpy().astype(np.float64)
    dst, src, sh = neighbor_list_numpy(pos, eng.spec.cutoff + eng.skin, cell, (True,) * 3)
    d = np.linalg.norm(pos[src] + sh @ cell - pos[dst], axis=1)
    order = np.lexsort((d, dst))
    dst, d = dst[order], d[order]
    starts = np.searchsorted(dst, dst, side="left")
    cut = np.arange(len(dst)) - starts >= eng.k_model
    d_drop = d[cut].min() if cut.any() else np.inf
    margin = min(max(d_drop - eng.spec.cutoff, 0.0), eng.skin)
    return margin * margin / 4.0


def test_limit_equals_nearest_cut_distance(monkeypatch):
    """After the host build of ``make_state`` and after a device rebuild at
    moved positions, at the default and the tight margin."""
    pos, Z, _, _, _ = _system()
    for margin in (None, "1.0"):
        if margin is not None:
            monkeypatch.setenv("SEVENNET_TPU_KMARGIN", margin)
        eng = _engine("default", monkeypatch)
        st = eng.make_state(pos, Z, compute_forces=False)
        want = _host_limit(eng, st)
        assert 0.0 < want < (eng.skin / 2) ** 2
        assert float(st.nl_limit) == pytest.approx(want, rel=1e-4)
        gen = torch.Generator().manual_seed(7)
        moved = st.positions + 0.05 * torch.randn(st.positions.shape, generator=gen)
        st = eng._rebuild(st.replace(positions=moved))
        assert not bool(st.nl_overflow)
        assert float(st.nl_limit) == pytest.approx(_host_limit(eng, st), rel=1e-4)
        assert float(eng._skin_half_sq(st)) == float(st.nl_limit)


def test_d3_limit_is_the_smaller_of_the_two():
    """With D3 the rebuild test takes the smaller of the state's limit and
    the square of half the D3 list's margin (the skin or the D3 grid's cover
    at the build, the smaller): the former in the box as built (the D3
    cutoff is the box height less the skin), the latter once the box
    shrinks, since each narrows by the shrink at its own cutoff and the D3
    cutoff is the longer. The 16-atom Hf/O box of tests/test_torch_md_d3.py
    cuts no edge within cutoff + skin, so its state is also given the limit
    of a cut 0.2 A past the cutoff, which the shrink below closes (0)."""
    from tests.test_torch_d3 import hfo_box

    cfg = {"cutoff": 4.0, "channel": 8, "lmax": 1, "is_parity": False,
           "num_convolution_layer": 2, "self_connection_type": "linear",
           "conv_denominator": 20.0, "chemical_species": ["Hf", "O"], "_remat": False}
    pos, Z, cell = hfo_box()
    spec = build_model_spec(cfg)
    eng = MDEngine(spec, params_from_numpy(spec, random_params(spec, 0)), cell,
                   d3={"functional": "pbe", "damping": "damp_bj"}, device="cpu", plain=True)
    st = eng.make_state(pos, Z, compute_forces=False)
    assert float(st.nl_limit) == pytest.approx((eng.skin / 2) ** 2, rel=1e-6)
    cut = st.replace(nl_limit=torch.tensor(0.1 ** 2))
    assert float(eng._skin_half_sq(cut)) == pytest.approx(0.1 ** 2, rel=1e-6)
    L = cell[0, 0]
    shrink = eng.skin - 0.1  # the D3 list's margin falls to 0.1 A
    scale = (L - shrink) / L
    for state, want_model in ((st, eng.skin), (cut, 0.2)):
        small = state.replace(cell=state.cell * scale, positions=state.positions * scale,
                              nl_positions=state.nl_positions * scale)
        model = max(0.0, scale * (eng.spec.cutoff + want_model) - eng.spec.cutoff) / 2
        want = ((L - shrink) - eng.d3_params.cutoff) / 2
        assert want < model or model == 0.0
        assert float(eng._skin_half_sq(small)) == pytest.approx(min(want, model) ** 2, rel=1e-3,
                                                                abs=1e-9)


def test_shrink_limit_equals_host_formula():
    """``shrink_limit`` against ``(max(0, s (cutoff + m) - cutoff) / 2)^2``
    in float64 (m from the limit) for s < 1, and the unchanged bits of
    ``skin_limit``'s limit at s = 1 and above."""
    cutoff, skin = 3.5, 0.6
    for d_drop in (np.inf, 3.9, 3.6, 3.5, 3.2):
        limit = skin_limit(torch.tensor(d_drop * d_drop, dtype=torch.float32), cutoff, skin)
        m = min(max(d_drop - cutoff, 0.0), skin)
        for s in (1.0, 1.01):
            got = shrink_limit(limit, torch.tensor(s, dtype=torch.float32), cutoff)
            assert torch.equal(got, limit)
        for s in (0.9999, 0.999, 0.99, 0.9):
            got = float(shrink_limit(limit, torch.tensor(s, dtype=torch.float32), cutoff))
            s32 = float(np.float32(s))
            want = (max(0.0, s32 * (cutoff + m) - cutoff) / 2.0) ** 2
            assert got == pytest.approx(want, rel=1e-4, abs=1e-12), (d_drop, s, got, want)
            assert got <= float(limit)


@functools.lru_cache(maxsize=None)
def _compressing_npt():
    """The compressing NPT run, one step at a time until NPT_AFTER steps
    past the first build on a re-derived grid (at most 60): per step the
    pairs within the cutoff without a slot, the box edge over its start and
    the grid; the engine's rebuilds, growths and re-derived grids."""
    pos, Z, cell, spec, params = _system()
    eng = MDEngine(spec, params, cell, skin=0.6, device="cpu")
    st = eng.make_state(pos, Z, temperature=NPT_T, seed=NPT_SEED)
    out = dict(grid0=eng.cl_spec.n_cells, missing=[(0, _missing(eng, st))], edge=[], grids=[])
    first = None
    for step in range(1, 61):
        st, _ = eng.run(st, 1, dt=DT, chunk=1, **NPT_KW)
        out["missing"].append((step, _missing(eng, st)))
        out["edge"].append(float(st.cell[0, 0]) / cell[0, 0])
        out["grids"].append(eng.cl_spec.n_cells)
        if first is None and eng.n_regrids:
            first = step
        if first is not None and step >= first + NPT_AFTER:
            break
    out.update(first_regrid=first, steps=step, rebuilds=eng.n_rebuilds, growths=eng.n_growths,
               regrids=eng.n_regrids)
    return out


def test_compressing_npt_keeps_every_pair_and_regrids():
    res = _compressing_npt()
    assert res["first_regrid"] is not None, "the grid was never re-derived"
    assert res["steps"] >= res["first_regrid"] + NPT_AFTER
    assert res["grids"][-1] != res["grid0"] and res["regrids"] >= 1
    assert min(res["edge"]) < 0.88  # the box shrank past the grid's slack
    bad = [(step, n) for step, n in res["missing"] if n]
    assert not bad, f"(step, pairs within the cutoff without a slot): {bad}"


def test_persistent_overflow_still_raises(monkeypatch):
    """A capacity overflow that every rebuild raises grows the capacities 3
    times and then raises the engine's error; the grid is not re-derived."""
    pos, Z, _, _, _ = _system()
    eng = _engine("default", monkeypatch)
    st = eng.make_state(pos, Z, temperature=T_HOT, seed=SEED)
    rebuild = eng._rebuild
    monkeypatch.setattr(eng, "_rebuild", lambda s, sort=True: rebuild(s, sort).replace(
        nl_overflow=torch.ones((), dtype=torch.bool)))
    with pytest.raises(RuntimeError, match="persisted after 3 automatic growth"):
        eng.run(st.replace(nl_limit=torch.zeros(())), 2, dt=DT, chunk=2)
    assert eng.n_growths == 3 and eng.n_regrids == 0
