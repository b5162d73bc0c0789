#!/usr/bin/env python3
"""Drives the PyTorch port (``sevennet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--threshold-probe | --fold-probe | --bd-probe]

1. Builds the CUDA kernels from ``sevennet_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and prints each kernel instance's registers, stack
   frame and spills from the ptxas report.
2. Holds each kernel against its plain PyTorch version on the card at the
   SevenNet-0 shapes of layer 0, layers 1-3 and layer 4, on a water box of
   ~3,000 atoms (K from its neighbour list); times both with CUDA events and
   prints two bounds beside each time: the design's, with the products that
   the kernels run as 3xTF32 on the tensor cores at a third of the TF32
   peak (``work``, ``bound_ms``; the ``kernels`` line's ``bound_ms``), and
   every operation at the fp32 rate.
   Kernels: B1 (forward), B2 (backward), B2' (backward with the radial-MLP
   weight and Bessel-coefficient gradients: records pass and reduction;
   the reduction alone also twice bitwise, its device kernels of one call
   from torch.profiler, at most 2, and beside one torch.mm per weight
   matrix, also at SevenNet-l3i5's widths and on a training batch; its
   SASS after the build: HGMMA, no FFMA),
   and in emb/sh mode, on the embedding and unnormalized spherical
   harmonics a legacy model feeds them: B4 (forward), B4 bwd, B4' (both
   passes) and B6 (``dense_conv_pallas`` on B4's kernel). Cross-check of
   the modes: B4 on the normalized emb/sh of the same edges matches B1, and
   B4 bwd's demb/dsh chained to the edge vectors by autograd match B2.
   Then B6's own path: ``dense_conv_pallas`` over the five layers. B3 (B2
   on one row chunk writing into a slot of the ring backward's buffer) is
   held against its plain twin in step 5, at the shape the ring runs it.
3. Serves single points through the calculator at full SevenNet-0 width
   (random weights from a seed) for water boxes of 192, 3,000 and 9,999
   atoms: 5 forward and 5 backward kernel launches per request; against the
   plain path (192 and 3,000 atoms) forces within 1e-3 eV/A and 1e-4 of the
   largest force, energy within 1e-5 relative, stress within 1e-6 eV/A^3;
   ms per request, and the host graph split into its three parts (the
   native cell list, the sort by receiver, and the device densify with the
   mirror map) beside the host graph the port built before (scipy's list
   and the host densify), with the count of lists each builder served.
   Then the same with ``_normalize_sph: False`` (the
   legacy config every pre-0.10 checkpoint loads as): 5 B4 + 5 B4 bwd
   launches per request and none of B1/B2.
4. Trains SevenNet-0 (full width and depth) on 16 water boxes of 192 atoms
   labelled by a teacher of the same architecture: the first 3 steps of the
   kernel path against the plain path at the same weights (loss within 1e-5
   relative, every gradient leaf within 1e-4 of its largest entry), 5 B1 +
   10 B2' launches per step, the same for the legacy config (5 B4 + 10 B4'
   per step), then 2 epochs through ``train_run`` (lc.csv, checkpoint
   reload); step time, structures/s, peak memory.
5. Runs NVE MD of water (0.5 fs steps, 300 K) through ``MDEngine``: 3,000
   atoms for 10 steps against an engine on the plain conv (positions within
   1e-4 A, energy within 1e-5 relative, a device rebuild whose slots equal
   a host build); 9,999 atoms unchunked (40 timed steps); 99,999 atoms
   with the ring backward in every layer: B3 against its plain twin at the
   ring's chunk shape and on its edges (an interior and a wrapped chunk,
   the other slots bitwise unchanged; timed over the nb chunks), the ring
   engine's initial forces against an unchunked engine's (1e-3 eV/A and
   1e-4 of max |F|), the peak memory of one step of each, then 10 timed
   ring steps. Launches per force evaluation: 5 B1 + 5 B2, or with the
   ring 5 B1 + 5 nb B3 and no B2. Then the other ensembles at 3,000 atoms,
   5 steps each from one state: ``langevin`` and ``npt`` (MTK) against a
   plain-conv engine (positions 1e-4 A, energy 1e-5 relative, the npt cell
   1e-6 relative), ``nose_hoover`` and ``npt_berendsen`` on the kernels
   alone (finite; Berendsen changes the volume); ms/step of each beside
   NVE's, the drift of the MTK invariant; 5 B1 + 5 B2 per force
   evaluation, with the stress for NPT. Then Grimme D3 (PBE, BJ damping;
   plain PyTorch, no kernel of its own): ``D3Calculator`` against the
   reference CUDA goldens (H2O; strained NaCl with the full lattice sum); a
   192-atom request through ``SevenNetCalculator(...).with_d3()`` at the
   full ~50.2 A cutoff (about 1e7 D3 edges), its fp32 D3 against float64 on
   the card and against another chunk size, its wall clock split into the
   model, the D3 host list and D3's device time, D3's peak memory; NVE with
   D3 at 3,000 atoms (the D3 cutoff bounded by the box, about 30.4 A): the
   engine's D3 term against ``D3Calculator`` at that cutoff, 10 steps
   against a plain-conv engine with D3, ms/step with and without D3, D3's
   ms per force evaluation, live edges and slots, the peak memory of a step
   and of a rebuild; 5 ``npt`` steps with D3. Then a SevenNet-0 checkpoint saved
   by the port under its registry name in a temporary
   ``$SEVENN_TPU_CHECKPOINT_DIR``, served by name
   (``SevenNetCalculator("7net-0")``, 192 atoms) against the spec-and-params
   calculator (bitwise, else 1e-6 relative; the log says which). Then a
   frozen TorchScript deployment of the same SevenNet-0 weights (written by
   ``tests/torch_deployed_artifact.py``, one linear behind an explicit
   ``x * s``) imported by ``io/torchscript_import.py`` (the import's host
   seconds; the spec equal, the parameters within 1e-6 of each leaf's
   largest entry) and served for 3,000 atoms (5 B1 + 5 B2) against the
   spec-and-params calculator and the plain path at the request limits,
   both requests timed in turns; and ``7net-mf-ompa``'s registry entry
   pointed at a ``file://`` stock ``.pth`` of those weights: a wrong pinned
   digest refused with no ``.partial`` left, the right one downloaded,
   loaded and served by name for 192 atoms (bitwise, else 1e-6 relative).
   Then batched inference (``BatchedCalculator``): eight water boxes of
   66-384 atoms in one call, each structure against ``SevenNetCalculator``
   (the request limits above), the call's time beside eight single
   requests'; the scripts and the CLI in this process: ``scripts.inference``
   over the 16 teacher-labelled boxes (its errors against an
   ``ErrorRecorder`` fed ``model_compute``), ``run_md_from_config`` (192
   atoms, ``nvt``, with and without the ``d3:`` key, its thermo rows against
   a direct ``MDEngine`` run), ``cli.main.main`` for ``preset``,
   ``checkpoint``, ``get_model`` (parameters bitwise) and ``inference``,
   and ``profiling.trace`` around an MD chunk (the trace names both conv
   kernels). Then distributed MD (``parallel.DistributedMDEngine``, the ext
   conv): world 1 on an ``nccl`` group in this process, 3,000 atoms, 20 NVE
   steps of 1 fs against the serial engine (first forces and energy at the
   request limits, PE and KE within 5e-3 x max(1, |E|)); then two ranks
   sharing the card, spawned, on ``gloo`` with the halos staged through
   host memory: 3,000 atoms at 600 K, 30 steps and ``compute_stress``
   against the serial engine (trajectories as above, atoms conserved,
   each atom within 5e-3 A to the nearest image, stress 1e-4 of max
   |stress|, a rebuild with migration); ms/step, peak memory and ghost rows per rank; 5 B1 + 5·nb
   B2 per force evaluation.
6. SevenNet-l3i5 (``bench.py:89-106``: lmax 3, 128x0e+64x1e+32x2e+32x3e,
   poly cutoff, nequip self-connection; random weights from the seed):
   B1, B2 and B2' at its layer shapes on the same box against their plain
   versions (each layer's column blocks of w and shared-memory carve
   printed), then radial MLPs of no, one and three hidden layers at SevenNet-0's
   widths (B1, B2 against plain), then requests of 192 and 3,000 atoms
   through the calculator (5 B1 + 5 B2 each; forces against the plain-conv
   model within 1e-3 eV/A and 1e-4 of max |F|).
7. SevenNet-MF-ompa (``sevennet_tpu_torch/model/presets.py``: five parity
   layers up to lmax 3, 6 A cutoff, two modalities; random weights from the
   seed): B1 and B2 at each of its five layer shapes against their plain
   versions on a 192-atom water box (each layer's CTAs a receiver row,
   blocks and carve printed; layers 2 and 3 run on a cluster of 2 CTAs,
   whose B2 and B2' are also launched twice and held bitwise equal, and
   whose B4 fwd, B4 bwd and B3 on a ring chunk are held against plain at
   layer 3), timed there and on the
   3,000-atom box; then requests of 192 and 3,000 atoms through the
   calculator with each modality pinned by ``select_modality`` (5 B1 + 5 B2
   each; the 192-atom request against the plain-conv model, forces within
   1e-3 eV/A and 1e-4 of max |F|; the two modalities' energies differ),
   with the model's time, the request's, the host graph's parts and the
   peak memory. B2' and its reduction join B1 and B2 at the five layer
   shapes (against plain at 192 atoms, the reduction also bitwise twice and
   against a float64 sum; timed at 192 and 3,000 atoms, the reduction beside
   one torch.mm per weight matrix). Then mf-ompa training on 8
   teacher-labelled 192-atom boxes, 4 of each modality: the first 3 steps
   on batches of 4 that mix the modalities, kernel path against plain
   (loss 1e-5 relative, every gradient leaf 1e-4 of its max; 5 B1 + 10 B2'
   + 10 reductions a step), the step's ms, structures/s and peak memory,
   then 1 epoch of ``train_run`` on the two-modality config with a
   modal-wise shift, its checkpoint reloaded and each modality served from
   it (against the trained model, 1e-6 relative).
8. The Hopper probes (``sevennet_tpu_torch/probes``): every variant of the
   matmul-rate probe (both contracts, every shape of its TPU scripts) and
   the batched products at N 10,016 against their plain versions
   (``mm_rate.PROBE_TOL``), then the probe path with the counts from 0:
   each timed the TPU script's way on the device alone (CUDA graphs), with
   TFLOP/s per card and the card rate over the SM count, beside the library
   calls (torch.matmul with TF32 off and on, torch.bmm); every variant of
   both contracts at its first shape, and of the rate contract at 480 x
   512 x 1024, also at REP 0, 16 and 32 (every product computed: REP 32's
   time less REP 0's at least 1.6x REP 16's less REP 0's, one copy, best
   of 3 each); the 3xTF32 variants with their raw TF32 rate and REP 32's
   whole call at least 1.6x REP 16's; each matmul
   entry of the ``kernels`` line also names its shape slowest against its
   library call. After the build, each matmul instance's SASS keeps its
   variant's instruction (``mm_sass``). Then the FMA-rate
   and gather probes (``probes/fma_rate.py``, ``probes/gather.py``): each
   against its plain version at every shape of its TPU script (the chains
   within 1e-5 of max |plain|, the gathers bitwise), then with the counts
   from 0 each timed by its script's method, the FMA chains also at the
   copies that fill the card with the SM clock read before and after, the
   row gather at SevenNet-0's 9,999-atom x[src] shape with and without
   streaming stores, beside torch.index_select; the column gather (p1) also
   at ragged shapes (its one call alone is split right after the build
   into the launch floor, an empty kernel timed the same way, the kernel's
   own duration from torch.profiler and the rest, beside index_select's).
   The SASS of the FMA kernels (``cuobjdump``) is counted after the build.
   Then the K-reduction, transpose and fold probes (``probes/reduce.py``,
   ``probes/xpose.py``, ``probes/fold.py``, ``probes/fold_conv.py``): each
   variant against its plain version at every shape of its TPU script (sums
   within 1e-5 of max |plain|, the conv fold 1e-4, streamed transposes
   bitwise), the conv fold also against B4 fwd on the same x[src], the fold's
   mxu variants also at DM 800 on a cluster of 2 CTAs and mxu3 on an input
   whose fold needs its third bf16 piece; then with the counts
   from 0 each timed by its script's method beside the library calls
   (torch.sum, x.t().contiguous(), x.clone()), the mxu folds also beside
   their tensor-core floor. After the build the mxu fold kernels' SASS must
   show wgmma (HGMMA) and no mma.sync (HMMA).
   Then the breakdown and knock-out probes (``probes/breakdown.py``,
   ``probes/knockout.py``: kernel B4 fwd instantiated with the phases of
   each variant of ``r2_fused_breakdown.py`` and ``r3_fwd_knockout.py``):
   their SASS (HMMA, FFMA, FADD, STS: one TF32 pass a third of 3xTF32's
   HMMAs, each knocked-out phase's gone, the per-edge uvu product on the
   CUDA cores with every term of every path in nofold as in tpred and
   nofold's staging stores, the 0/1 sums' two TF32 passes), each variant
   against its plain version
   at its script's shape (3xTF32 1e-4 of max |plain|, one TF32 pass 2^-8,
   the transpose bitwise), ``full_hi`` and the knock-out's ``full`` bitwise
   against B4 fwd, then with the counts from 0 each timed the knock-out
   script's way, with the knock-outs' savings beside B4 fwd's section
   clocks (``conv_breakdown.py``'s profile build). The B2'/B4' reduction's
   row times one torch.mm per weight matrix as its library call.
9. Prints a ``kernels`` JSON line, the card's name and power limit, and as
   its last line ``{"ok": true, "device": {...}}``.

``--fold-probe`` builds and runs only the fold probe (its SASS check, its
checks against plain, its timing); ``--bd-probe`` likewise the batched-dot
probe (its SASS counts, its checks against torch.bmm at the script's and
the ragged shapes, its times at rep 1 and 4 beside torch.bmm and the
bound). ``probe_ab.py`` times both probes of several trees in turns.

Exits non-zero, printing no result, without CUDA or without the package.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time

FP32_PEAK = 67e12     # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
TC_3XTF32_PEAK = 495e12 / 3  # TF32 tensor cores (data sheet), three products per fp32 one
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s
REL_TOL = 1e-4        # kernel vs plain: fp32 with another summation order
FORCE_TOL = 1e-3      # eV/A, the repo's force budget (BASELINE.md)
# kernel path against plain path, both fp32 on the card, sums in another
# order (the limits of tests/test_torch_kernels.py); the relative force
# limit keeps the check sharp when random weights give small forces
FORCE_REL_TOL = 1e-4  # of max |F_plain|
ENERGY_REL_TOL = 1e-5
STRESS_TOL = 1e-6     # eV/A^3
SIZES = (192, 3000, 9999)
REPS = 5              # timed requests per size
PLAIN_MAX_ATOMS = 3000  # the plain path's autograd graph grows past ~30 GB above this
# training phase: full SevenNet-0 on water boxes labelled by a teacher
TRAIN_BOXES = 16       # structures of 192 atoms (64 molecules)
TRAIN_BATCH = 4
TRAIN_EPOCHS = 2
TRAIN_LR = 1e-3
TRAIN_CMP_STEPS = 3    # steps held against the plain path
# MD phases: NVE of water boxes at 300 K
MD_T = 300.0
MD_DT = 0.5            # fs
MD_CMP_STEPS = 10      # 3,000 atoms, kernel engine vs plain-conv engine
MD_CMP_SKIN = 0.2      # A: a device rebuild within the compared steps
MD_POS_TOL = 1e-4      # A, positions after MD_CMP_STEPS steps
MD_CHUNK = 10          # steps per chunk (a capacity growth retries one chunk)
MD_WARMUP_STEPS = 10   # 9,999 atoms
MD_TIMED_STEPS = 40
MD_RING_WARMUP = 4     # 99,999 atoms, ring: after one step measured alone
MD_RING_STEPS = 5
MD_RING_EDGE_CHUNK = 163840  # slots per chunk, bench.py:139-141
MD_RING_THRESHOLD = 1_000_000_000  # bytes: every layer chunks, bench.py:355-357
MD_LEGACY_STEPS = 3    # 99,999 atoms, legacy config: timed steps of each chunked engine
EXT_GHOST = 0.3        # ghost rows of the ext conv's x_ext, beyond the receivers
THRESHOLD_MOLECULES = 66666  # --threshold-probe: 199,998 atoms, one unchunked MD step
LOSS_REL_TOL = 1e-5    # kernel vs plain train step, loss
GRAD_REL_TOL = 1e-4    # kernel vs plain train step, per leaf of max |g_plain|


def log(msg):
    print(msg, flush=True)


def water_box(n_molecules: int, density_g_cm3: float = 1.0, seed: int = 0):
    """Simple-cubic lattice of water molecules (bench.py's water_box)."""
    import numpy as np

    mass_h2o = 18.015
    n_av = 6.02214076e23
    vol_cm3 = n_molecules * mass_h2o / (n_av * density_g_cm3)
    box = (vol_cm3 ** (1 / 3)) * 1e8
    n_side = int(np.ceil(n_molecules ** (1 / 3)))
    a = box / n_side
    rng = np.random.default_rng(seed)
    pos, Z = [], []
    count = 0
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                if count >= n_molecules:
                    break
                o = (np.array([i, j, k]) + 0.5) * a
                pos += [o, o + [0.757, 0.586, 0.0], o + [-0.757, 0.586, 0.0]]
                Z += [8, 1, 1]
                count += 1
    pos = np.asarray(pos) + rng.normal(scale=0.01, size=(len(pos), 3))
    return pos, np.asarray(Z), np.eye(3) * box


SEVENNET0 = {  # bench.py:87-147
    "lmax": 2,
    "irreps_manual": ["128x0e"] + ["128x0e+64x1e+32x2e"] * 4 + ["128x0e"],
    "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 4.5},
    "self_connection_type": "linear",
    "cutoff": 5.0,
    "channel": 128,
    "is_parity": False,
    "num_convolution_layer": 5,
    "weight_nn_hidden_neurons": [64, 64],
    "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": 8},
    "conv_denominator": 35.0,
    "chemical_species": ["H", "O"],
}


# SevenNet-l3i5 (bench.py:89-106): lmax 3, 128x0e+64x1e+32x2e+32x3e, poly
# cutoff p 6, nequip self-connection; the rest as SevenNet-0
L3I5 = dict(SEVENNET0, lmax=3,
            irreps_manual=["128x0e"] + ["128x0e+64x1e+32x2e+32x3e"] * 4 + ["128x0e"],
            cutoff_function={"cutoff_function_name": "poly_cut", "poly_cut_p_value": 6},
            self_connection_type="nequip")
L3I5_SIZES = (192, 3000)
MF_SIZES = (192, 3000)
MF_PLAIN_MAX_ATOMS = 192   # the plain mf-ompa conv's messages: 15,552 floats an edge
MF_MODALITIES = ("mpa", "omat24")
MF_DENOMINATOR = 81.0      # mean neighbours of a water atom at 6 A
MF_TRAIN_BOXES = 4         # teacher-labelled 192-atom water boxes per modality
MF_TRAIN_BATCH = 4         # structures per mf-ompa training batch
MF_TRAIN_EPOCHS = 1
ENS_STEPS = 5              # steps of each ensemble at 3,000 atoms
CELL_REL_TOL = 1e-6        # npt cell, kernel engine vs plain-conv engine
# MDEngine.run keywords of each ensemble: the JAX engine's defaults, but
# MTK's piston at tau_p 100 fs (default 1000), so that its cell moves by
# about 1e-4 in the 5 steps and CELL_REL_TOL tests it
ENSEMBLES = {
    "nve": {},
    "langevin": dict(temperature=MD_T, friction=0.01),
    "nose_hoover": dict(temperature=MD_T, tau=50.0),
    "npt": dict(temperature=MD_T, pressure=0.0, tau_t=100.0, tau_p=100.0),
    "npt_berendsen": dict(temperature=MD_T, pressure=0.0, tau_t=100.0, tau_p=1000.0),
}
ENS_PLAIN = ("langevin", "npt")  # also run on a plain-conv engine and compared
# a box that NPT compresses past its cell grid's slack (5 cells a side at
# cutoff + skin 5.6 A fit to about 0.90 of the 3,000-atom box's edge):
# Berendsen with a fast piston toward COMPRESS_DP eV/A^3 above the box's own
# pressure at the start (random weights: any sign), about 1.2 % of the edge
# a step at first
COMPRESS_KW = dict(integrator="npt_berendsen", temperature=MD_T, tau_p=50.0)
COMPRESS_DP, COMPRESS_STEPS, COMPRESS_AFTER = 0.05, 40, 5
# D3 phase: Grimme D3 (PBE, BJ damping), the calculator at the full ~50.2 A
# cutoff and the MD engine at the box-bounded one
D3 = {"functional": "pbe", "damping": "damp_bj"}
D3_REQ_MOLECULES = 64      # the 192-atom request
D3_E64_REL_TOL = 1e-5      # fp32 D3 against float64 on the card: energy, relative
D3_F64_REL_TOL = 1e-4      # forces, of max |F_float64|
D3_CHUNK_E_REL_TOL = 1e-6  # two chunk sizes: energy, relative
D3_CHUNK_F_REL_TOL = 1e-5  # forces, of max |F| (sums by atomics in another order)
D3_ENGINE_TOL = 5e-5       # eV and eV/A: the engine's D3 term against D3Calculator
D3_MD_STEPS = 10
D3_NPT_STEPS = 5
# radial MLPs of other depths held at SevenNet-0's widths
MLP_DEPTHS = ((), (64,), (64, 64, 64))
# batched inference: water boxes of 66-384 atoms in one call
BATCH_MOLECULES = (22, 32, 43, 54, 64, 86, 107, 128)
BATCH_REPS = 3             # timed batched calls (and sequential rounds)
SCRIPT_MD_STEPS = 20       # run_md_from_config, 192 atoms, nvt
# distributed MD: 3,000 atoms of water, NVE steps of DIST_DT
DIST_MOLECULES = 1000
DIST_DT = 1.0              # fs
DIST1_WARM, DIST1_TIMED = 5, 15    # world 1 (nccl, this process)
DIST2_WARM, DIST2_TIMED = 10, 20   # two ranks sharing the card (gloo)
DIST_HOT_T = 600.0         # K: atoms cross the slab faces within the run
DIST_JOIN_S = 300          # s, each rank's join
# the two-rank run against the serial engine at its own default slot
# margin: PE and KE within DIST2_TRAJ_REL x max(1, |E|), each atom within
# DIST2_POS_TOL A (against the serial engine at the distributed margin, the
# proof run of the first version read 3.1e-5 eV of KE and 7.6e-6 A; at the
# default margin, once both engines keep every pair within the cutoff,
# 3.052e-5 eV and 7.451e-6 A; NVIDIA H100 80GB HBM3, 700 W)
DIST2_TRAJ_REL = 2e-6
DIST2_POS_TOL = 1e-4


def sevennet0_spec():
    """SevenNet-0 (bench.py:87-147): 5 layers, 128x0e+64x1e+32x2e, lmax 2,
    XPLOR cutoff 5.0 A (on at 4.5), radial MLP [8, 64, 64, numel]."""
    from sevennet_tpu_torch.model.build import build_model_spec

    return build_model_spec(SEVENNET0)


def nvidia_smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_line() -> str:
    return nvidia_smi("name,power.limit")


def cuda_time(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_median(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls, each timed alone with CUDA
    events, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def work(op, N: int, K: int, n_edges: int, kind: str):
    """(flops, bytes, tc_flops) the kernel's function needs on these inputs:
    ``tc_flops`` is the part of ``flops`` that the kernels run on the tensor
    cores as 3xTF32: every product counted here (the radial MLP's layers,
    ``tmp``, the uvu product and, in the backward, their transposes and
    pullbacks) and the parameter-gradient sums of B2' and B4', which the
    reduction kernel runs as wgmma products (2E operations per dW entry,
    and 2E per dcoef entry: a product with a ones column); the rest of
    dcoef's 4E - 1 (its per-edge terms) at fp32. The fp32
    multiplies and adds of the edges inside the cutoff (activations, envelope
    and spherical harmonics left out), each input read once, each output
    written once. ``kind``: ``fwd`` (B1), ``bwd`` (B2, and B3: B2 writing
    into a slot), ``bwd_pg`` (B2'), ``reduce`` (B2''s second pass alone),
    ``fwd_embsh`` (B4's forward and B6: the forward on a precomputed
    embedding and spherical harmonics), ``bwd_embsh`` (B4's backward and
    B5: ``dxg``, ``demb`` and ``dsh`` in place of ``dvec``) or
    ``bwd_embsh_pg`` (B4': no ``dcoef``). The emb/sh backward needs every
    slot, padding included: a zero emb row still has a nonzero ``demb``.

    A sum of n products counts 2n - 1 operations. Per edge: the MLP's three
    products, ``tmp = w3j_pack @ sh`` over the nonzeros of ``w3j_pack``, and
    the uvu product with the sums over m factored as the JAX kernel factors
    them (sevennet_tpu/ops/fused_conv.py:906-920). An output column is
    ``w[u] * s``, ``s = sum_m x[m, u] tmp[m, p]``, one product per elementary
    term (c, xc, wc, r); the forward scales s by w and sums it over the
    receiver's edges. The backward recomputes the MLP and tmp, then forms
    ``a[m, u] = sum_p ybar[p, u] tmp[m, p]`` and ``dtmp[r] = sum_u
    (ybar w)[p, u] x[m, u]`` (one product per term each), ``ybar * w`` per
    output column, ``dxg = sum w a`` and ``dw = sum x a`` per gathered x entry
    of each instruction, ``dsh = w3j_packᵀ dtmp`` and the MLP's backward. It
    writes no output of the forward.

    B2' adds the parameter gradients, sums over all E edges:
    ``dW_l = sum_e h_l ⊗ g_l / sqrt(d_l)`` (2E operations per entry) and
    ``dcoef[n] = sum_e demb * (2/rc) cos(c_n r) env`` (4E - 1 per basis
    function), and writes them. Its per-edge records are an intermediate of
    the kernel's design, not of the function, and are not counted. The
    reduction alone reads the records of the E edges (and a validity byte
    per slot) and does the same sums."""

    def mv(n_in, n_out):
        return n_out * (2 * n_in - 1)

    d = op.mlp_spec.dims
    embsh = "_embsh" in kind
    n_dw = sum(a * b for a, b in zip(d[:-1], d[1:]))
    n_dc = 0 if embsh else d[0]
    pg_flops = n_dw * 2 * n_edges + n_dc * (4 * n_edges - 1)
    pg_tc = (n_dw + n_dc) * 2 * n_edges
    pg_bytes = 4 * (n_dw + n_dc)
    if kind == "reduce":
        record = sum(d[:-1]) + sum(d[1:]) + d[0]  # emb h1 h2 | dz1 dz2 dw | dcoef terms
        return pg_flops, 4 * n_edges * record + N * K + pg_bytes, pg_tc
    mlp = sum(mv(a, b) for a, b in zip(d[:-1], d[1:]))
    nnz = int((op.w3j_pack != 0).sum())
    tmp = 2 * nnz - op.R
    conv = op.conv
    x_entries = sum(conv.irreps_x[i].dim for i, _, _, _ in conv.instructions)
    # per edge slot: the edge vector, or in emb/sh mode (B4, B5, B6) the
    # precomputed embedding and spherical harmonics
    edge_in = op.n_basis + op.dim_f if embsh else 3
    ins = 4 * (N * op.dim_x + N * K + edge_in * N * K + d[0] + n_dw)
    if kind in ("fwd", "fwd_embsh"):
        # s: 2 n_terms - dim_mid per edge; w * s summed over each row's edges
        flops = (n_edges * (mlp + tmp + 2 * op.n_terms + op.dim_mid) - N * op.dim_mid)
        return flops, ins + 4 * N * op.dim_mid, flops
    mlp_bwd = sum(mv(b, a) for a, b in zip(d[:-1], d[1:]))
    uvu = (4 * op.n_terms - x_entries - op.R + op.dim_mid
           + (2 * x_entries - op.dim_x) + (2 * x_entries - op.numel))
    n_bwd = N * K if embsh else n_edges
    flops = n_bwd * (mlp + tmp + uvu + (2 * nnz - op.dim_f) + mlp_bwd)
    nbytes = ins + 4 * (N * op.dim_mid + N * K * op.dim_x + edge_in * N * K)
    if kind in ("bwd_pg", "bwd_embsh_pg"):
        return flops + pg_flops, nbytes + pg_bytes, flops + pg_tc
    return flops, nbytes, flops


def bound_ms(flops: float, nbytes: float, tc_flops: float = 0.0):
    """(ms, bound_by): the least time the card could take for this work, the
    larger of its operations over their peak rates and its bytes over the
    memory rate. The ``tc_flops`` of ``flops`` that the kernels run on the
    tensor cores as 3xTF32 (fp32 accuracy) count at a third of the TF32
    peak, the others at the fp32 peak (one after the other, as one CTA's
    warps issue them). ``tc_flops=0`` gives the fp32 bound: every operation
    at the fp32 peak."""
    t_ops = (tc_flops / TC_3XTF32_PEAK + (flops - tc_flops) / FP32_PEAK) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# kernel instances by mangled name and template arguments (ILb<PG>ELb<EMBSH>ELb<CL>EE,
# ILi<variant>ELb<carry>EE)
INSTANCES = {
    **{("fused_conv_fwd_kernel", f"{embsh}{cl}"):
       f"fwd<{'emb/sh' if embsh else 'vec'}{', cluster' if cl else ''}> "
       f"({'B4 fwd, B6' if embsh else 'B1'})" for embsh in (0, 1) for cl in (0, 1)},
    **{("fused_conv_bwd_kernel", f"{pg}{embsh}{cl}"):
       f"bwd<{'emb/sh' if embsh else 'vec'}{', records' if pg else ''}"
       f"{', cluster' if cl else ''}> ({name})"
       for (pg, embsh), name in (((0, 0), "B2, B3"), ((1, 0), "B2' first pass"),
                                 ((0, 1), "B4 bwd, B5"), ((1, 1), "B4' first pass"))
       for cl in (0, 1)},
    ("pg_partial_kernel", ""): "pg_partial (reduction: 3xTF32 wgmma, cp.async ring)",
    ("pg_final_kernel", ""): "pg_final (reduction: the chunks in order)",
    ("batched_dot_kernel", ""): "batched_dot (probe: 3xTF32 wgmma, a ring of chunks)",
    **{("probe_mm_ffma_kernel", f"{c}{tr}"):
       f"probe_mm_ffma<{'carry' if c else 'rate'}, {8 * tr}-row tiles> (probe)"
       for c in (0, 1) for tr in (8, 4)},
    **{("probe_mm_tc_kernel", f"{i}{c}{bn}"): f"probe_mm_tc<{v}{', carry' if c else ''}, N {bn}> (probe)"
       for i, v in ((1, "tf32"), (4, "wgmma_tf32"), (5, "bf16")) for c in (0, 1)
       for bn in ((64, 128) if i == 4 else (64,))},
    **{("probe_mm3x_kernel", f"{p}{c}"):
       f"probe_mm3x<{'3xtf32_presplit' if p else '3xtf32'}{', carry' if c else ''}> "
       "(probe: 3xTF32 wgmma)" for p in (0, 1) for c in (0, 1)},
    **{("probe_fma_kernel", f"{i}{c}"): f"probe_fma<{lay}, {'carry' if c else 'one pass'}> (probe)"
       for i, lay in enumerate(("feat", "edge")) for c in (0, 1)},
    ("probe_vpu_kernel", ""): "probe_vpu (probe)",
    **{("probe_gather_rows_kernel", f"{i}{st}"):
       f"probe_gather_rows<{v}{', streaming' if st else ''}> (probe)"
       for i, v in enumerate(("ldg", "cp_async")) for st in (0, 1)},
    **{("probe_gather_cols_kernel", f"{r}{vec}"):
       f"probe_gather_cols<{r} row{'s' if r > 1 else ''} a thread, {'16' if vec else '4'}-byte "
       "accesses> (probe)" for r in (1, 2, 4) for vec in (0, 1)},
    ("probe_empty_kernel", ""): "probe_empty (the launch floor, probe)",
    ("probe_reduce_rows_kernel", "0"): "probe_reduce_rows<kreduce> (probe)",
    ("probe_reduce_rows_kernel", "1"): "probe_reduce_rows<scaled> (subreduce, probe)",
    ("probe_reduce_lanes_kernel", ""): "probe_reduce_lanes (lanereduce, probe)",
    **{("probe_xpose_kernel", f"{i}{pad}"): f"probe_xpose<{mode}, pad {pad}> (probe)"
       for i, mode in enumerate(("xpose", "round trip", "carry")) for pad in (0, 1)},
    **{("probe_xpose_rt_kernel", str(vec)): f"probe_xpose_rt<{'16' if vec else '4'}-byte "
       "accesses> (round trip, pad 0, probe)" for vec in (0, 1)},
    **{("probe_fold_roll_kernel", f"{k}{vec}"):
       f"probe_fold_roll<K {k}{', 16-byte runs' if vec else ''}> (probe)"
       for k in (8, 9, 72) for vec in (0, 1)},
    ("probe_fold_bprep_kernel", ""): "probe_fold_bprep (the mxu folds' B stages, probe)",
    **{("probe_fold_mma_kernel", f"{p}{pairs}"):
       f"probe_fold_mma<{p} pieces{', pairs' if pairs else ''}> (probe)"
       for p in (2, 3) for pairs in (0, 1)},
    **{("probe_fold_conv_kernel", f"{i}{k}"):
       f"probe_fold_conv<{v}, K {k}> (probe: 3xTF32 wgmma MLP, K sum in registers)"
       for i, v in enumerate(("sliceadd", "group4", "group8")) for k in (24, 72)},
    ("probe_fold_conv_prep_kernel", ""): "probe_fold_conv_prep (the conv fold's weights split)",
    **{("probe_breakdown_kernel", str(i)): f"probe_breakdown<{v}> (probe)"
       for i, v in enumerate(("mlp", "mlp_hi", "tmp", "tp", "tpred", "full", "full_hi", "tpredk",
                              "storek", "fullk", "tpredmm", "fullmm", "feat_full",
                              "feat_transpose", "featroll_full", "featroll_mlp", "ko full",
                              "ko nomlp", "ko notp", "ko nofold", "ko nothing"))},
}


def ptxas_table(libs):
    """Registers, stack frame and spills of every kernel instance, from the
    ptxas reports (``-Xptxas -v``) that ``kernels.build`` keeps beside each
    library."""
    import re

    rows, row = [], None
    for so in libs.values():
        for ln in open(str(so) + ".log"):
            m = re.search(r"Compiling entry function '_Z(\d+)(\w+)", ln)
            if m:
                n = int(m.group(1))
                name, rest = m.group(2)[:n], m.group(2)[n:]
                args = "".join(re.findall(r"L[bi](\d+)E", rest.split("Ev")[0])) if rest[:1] == "I" else ""
                row = dict(instance=INSTANCES.get((name, args), name + args),
                           registers=None, stack=None, spill_stores=None, spill_loads=None)
                rows.append(row)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and row is not None:
                row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and row is not None:
                row["registers"] = int(m.group(1))
    return rows


def check_close(tag: str, name: str, got, want, tol: float = REL_TOL):
    """max |got - want| within ``tol`` of max |want|, all finite; returns
    the max abs error. Raises SystemExit otherwise."""
    import torch

    ok = bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / max(scale, 1e-30)
    status = "ok" if ok and rel <= tol else "FAIL"
    log(f"  {tag} {name}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
        f"rel={rel:.3e} (tol {tol:g}) {status}")
    if status != "ok":
        raise SystemExit(f"{name} disagrees with its plain version at {tag}")
    return err


KERNELS = ("fwd", "bwd", "bwd_pg", "reduce", "fwd_embsh", "bwd_embsh", "bwd_embsh_pg", "b6")
# per 3,000-atom pass: layer 0 once, layers 1-3 three times, layer 4 once
SHAPES = (("layer0", 0, 1), ("layers1-3", 1, 3), ("layer4", 4, 1))


def pg_float64_check(tag, op, args, ybar, outs_k, outs_p):
    """When B2''s parameter gradients miss the limit: both sides against a
    float64 plain version on the card, printed, to tell the kernel's error
    from the fp32 plain version's."""
    from sevennet_tpu_torch.ops import fused_conv as fc

    op_, x, src, vec, coef, ws = args
    ref = fc.fused_conv_bwd_plain(op_, x.double(), src, vec.double(), coef.double(),
                                  [w.double() for w in ws], ybar.double(), param_grads=True)
    for i, name in enumerate(("dW1", "dW2", "dW3")):
        r = ref[2][i]
        for side, o in (("kernel", outs_k), ("plain fp32", outs_p)):
            err = float((o[2][i].double() - r).abs().max()) / float(r.abs().max())
            log(f"  {tag} {name} {side} vs float64: rel {err:.3e}")


def reduce_check(tag, op, work_, valid, N, K, reps: int = 10):
    """The B2'/B4' reduction alone on the records of a first pass: against
    its plain version (REL_TOL of max |plain| per output), two calls
    bitwise equal, then timed (CUDA events) beside its plain version and its
    library call, one torch.mm(A_l^T, B_l) per weight matrix over the valid
    rows (fp32, TF32 off; the 1 / sqrt(d_in) scale and dcoef's column sums
    left out). Returns (ms, plain_ms, library_ms, max abs error)."""
    import torch

    from sevennet_tpu_torch.ops import fused_conv as fc

    names = [f"dW{i + 1}" for i in range(len(op.mlp_spec.dims) - 1)] + ["dcoef"]
    dws, dcoef = fc.param_grad_reduce(op, work_, valid, N, K)
    dws2, dcoef2 = fc.param_grad_reduce(op, work_, valid, N, K)
    pw, pc = fc.param_grad_reduce_plain(op, work_, valid)
    got, again, want = [*dws, dcoef], [*dws2, dcoef2], [*pw, pc]
    torch.cuda.synchronize()
    err = max(check_close(tag, f"reduce {n}", a, b) for n, a, b in zip(names, got, want)
              if b is not None)
    dws64, dcoef64 = fc.param_grad_reduce_plain(op, work_.double(), valid)
    exact = [*dws64, dcoef64]
    rel = [max(float((a.double() - e).abs().max()) / float(e.abs().max())
               for a, e in zip(side, exact) if e is not None and float(e.abs().max()) > 0)
           for side in (got, want)]
    log(f"  {tag} reduce against a float64 sum: kernel {rel[0]:.2e}, plain fp32 {rel[1]:.2e} "
        f"of max |float64| (worst output)")
    same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
    log(f"  {tag} reduce: two calls bitwise equal: {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit(f"the reduction is not deterministic at {tag}")
    ms = cuda_time(lambda: fc.param_grad_reduce(op, work_, valid, N, K), reps)
    plain_ms = cuda_time(lambda: fc.param_grad_reduce_plain(op, work_, valid), 3)
    rows = work_[valid.bool()]
    mats = [(rows[:, a:a + da], rows[:, b:b + db]) for a, da, b, db in op.reduce_products
            if a >= 0]
    lib_ms = cuda_time(lambda: [torch.mm(m_a.t(), m_b) for m_a, m_b in mats], reps)
    log(f"  {tag} reduce: kernel {ms:.4f} ms, library {lib_ms:.4f} ms (torch.mm per weight "
        f"matrix over the {rows.shape[0]} valid rows of {N * K}, chunk "
        f"{fc.reduce_chunk(N * K)}), kernel/library {ms / lib_ms:.3f}, plain {plain_ms:.4f} ms")
    return ms, plain_ms, lib_ms, err


def reduce_device_kernels(op, work_, valid, N, K):
    """The device kernels of one reduction call, from torch.profiler:
    [(name, device us)]. Raises SystemExit unless there are at most 2, the
    partial sums' among them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sevennet_tpu_torch.ops import fused_conv as fc

    fc.param_grad_reduce(op, work_, valid, N, K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fc.param_grad_reduce(op, work_, valid, N, K)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    n = sum(c for _, c, _ in kernels)
    log(f"  reduce: device kernels of one call (torch.profiler): {n}: "
        + ", ".join(f"{k} x{c} {us:.1f} us" for k, c, us in kernels))
    if not 0 < n <= 2 or not any("pg_partial" in k for k, _, _ in kernels):
        raise SystemExit(f"one reduction call ran {n} device kernels: {kernels}")
    return kernels


def kernel_phase(spec, params, dev, atoms):
    """Each kernel against its plain version at the three SevenNet-0 layer
    shapes, in vec mode on the box's edge vectors and in emb/sh mode on the
    embedding and unnormalized spherical harmonics a legacy model computes
    from them; and the two modes against each other. Returns per-kernel
    records (times summed over one 3,000-atom pass) and the shapes."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.model.model import edge_emb_sh, edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops.pallas_conv import dense_conv_pallas

    calc, g, vec, src, coef = box_edges(spec, params, dev, atoms)
    N, K, n_edges = g.n_atoms_cap, g.dense_k, int(g.edge_mask.sum())
    # what the legacy model (unnormalized spherical harmonics) feeds the conv
    emb_l, sh_l = (t.contiguous() for t in edge_emb_sh(
        dataclasses.replace(spec, normalize_sph=False), coef, vec, g.edge_mask))
    log(f"kernel shapes: N={N} K={K} real edges={n_edges}")
    gen = torch.Generator(device="cpu").manual_seed(1)
    per_shape, ops = {}, {}
    for tag, t, _ in SHAPES:
        layer = spec.layers[t]
        op = ops[tag] = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        op_e = fc.conv_op(layer.conv, layer.radial_mlp)
        ws = calc.params[f"{t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, op.dim_x, generator=gen).to(dev)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
        args = (op, x, src, vec, coef, ws)
        eargs = (op_e, x, src, emb_l, sh_l, ws)
        errs = {}
        out_b1 = fc.fused_conv_fwd(*args)
        errs["fwd"] = check_close(tag, "fwd", out_b1, fc.fused_conv_fwd_plain(*args))
        dxg_k, dvec_k = fc.fused_conv_bwd(*args, ybar)
        dxg_p, dvec_p = fc.fused_conv_bwd_plain(*args, ybar)
        errs["bwd"] = max(check_close(tag, "dxg", dxg_k, dxg_p),
                          check_close(tag, "dvec", dvec_k, dvec_p))
        del dxg_p, dvec_p
        # B2': both passes through the wrapper, against the plain twin
        outs_k = fc.fused_conv_bwd(*args, ybar, param_grads=True)
        outs_p = fc.fused_conv_bwd_plain(*args, ybar, param_grads=True)
        torch.cuda.synchronize()
        pairs = [("pg dxg", outs_k[0], outs_p[0]), ("pg dvec", outs_k[1], outs_p[1])]
        pairs += [(f"dW{i + 1}", a, b) for i, (a, b) in enumerate(zip(outs_k[2], outs_p[2]))]
        pairs += [("dcoef", outs_k[3], outs_p[3])]
        try:
            errs["bwd_pg"] = max(check_close(tag, n, a, b) for n, a, b in pairs)
        except SystemExit:
            pg_float64_check(tag, op, args, ybar, outs_k, outs_p)
            raise
        del outs_k, outs_p
        # the reduction alone, on the records of the first pass: against
        # plain, bitwise twice, timed beside torch.mm
        _, _, work_, valid = fc.fused_conv_bwd_pg_records(*args, ybar)
        red_ms, red_plain, reduce_lib, errs["reduce"] = reduce_check(tag, op, work_, valid, N, K)
        if tag == "layers1-3":
            reduce_device_kernels(op, work_, valid, N, K)

        # emb/sh mode against vec mode on the same edges: B4 on the normalized
        # emb/sh of the edge vectors matches B1; B4 bwd's demb and dsh, chained
        # to the edge vectors by autograd, match B2's dvec
        emb_n, sh_n = fc.edge_embedding_plain(op, vec, coef)
        nargs = (op_e, x, src, emb_n.contiguous(), sh_n.contiguous(), ws)
        check_close(tag, "B4 fwd (normalized emb/sh) vs B1", fc.fused_conv_fwd_embsh(*nargs),
                    out_b1)
        dxg_n, demb_n, dsh_n = fc.fused_conv_bwd_embsh(*nargs, ybar)
        v = vec.clone().requires_grad_(True)
        (dvec_chain,) = torch.autograd.grad(fc.edge_embedding_plain(op, v, coef), v,
                                            (demb_n, dsh_n))
        check_close(tag, "B4 bwd dxg vs B2", dxg_n, dxg_k)
        check_close(tag, "B4 bwd demb, dsh chained to dvec vs B2", dvec_chain, dvec_k)
        del dxg_k, dvec_k, dxg_n, demb_n, dsh_n, dvec_chain, emb_n, sh_n

        # emb/sh mode on the legacy model's inputs: B4, B4 bwd, B4' and B6
        out_p = fc.fused_conv_fwd_embsh_plain(*eargs)
        errs["fwd_embsh"] = check_close(tag, "B4 fwd", fc.fused_conv_fwd_embsh(*eargs), out_p)
        errs["b6"] = check_close(tag, "B6 dense_conv_pallas", dense_conv_pallas(
            layer.conv, layer.radial_mlp, x, emb_l.view(N, K, -1), sh_l.view(N, K, -1), src, ws),
            out_p)
        got = fc.fused_conv_bwd_embsh(*eargs, ybar)
        want = fc.fused_conv_bwd_embsh_plain(*eargs, ybar, param_grads=True)
        errs["bwd_embsh"] = max(check_close(tag, f"B4 bwd {n}", a, b)
                                for n, a, b in zip(("dxg", "demb", "dsh"), got, want))
        got = fc.fused_conv_bwd_embsh(*eargs, ybar, param_grads=True)
        pairs = [(f"B4' {n}", a, b) for n, a, b in zip(("dxg", "demb", "dsh"), got, want)]
        pairs += [(f"B4' dW{i + 1}", a, b) for i, (a, b) in enumerate(zip(got[3], want[3]))]
        errs["bwd_embsh_pg"] = max(check_close(tag, n, a, b) for n, a, b in pairs)
        del got, want, out_p

        reps = 10
        times = {
            "fwd": (cuda_time(lambda: fc.fused_conv_fwd(*args), reps),
                    cuda_time(lambda: fc.fused_conv_fwd_plain(*args), 3)),
            "bwd": (cuda_time(lambda: fc.fused_conv_bwd(*args, ybar), reps),
                    cuda_time(lambda: fc.fused_conv_bwd_plain(*args, ybar), 3)),
            "bwd_pg": (cuda_time(lambda: fc.fused_conv_bwd(*args, ybar, param_grads=True), reps),
                       cuda_time(lambda: fc.fused_conv_bwd_plain(*args, ybar, param_grads=True), 3)),
            "reduce": (red_ms, red_plain),
            "fwd_embsh": (cuda_time(lambda: fc.fused_conv_fwd_embsh(*eargs), reps),
                          cuda_time(lambda: fc.fused_conv_fwd_embsh_plain(*eargs), 3)),
            "bwd_embsh": (cuda_time(lambda: fc.fused_conv_bwd_embsh(*eargs, ybar), reps),
                          cuda_time(lambda: fc.fused_conv_bwd_embsh_plain(*eargs, ybar), 3)),
            "bwd_embsh_pg": (
                cuda_time(lambda: fc.fused_conv_bwd_embsh(*eargs, ybar, param_grads=True), reps),
                cuda_time(lambda: fc.fused_conv_bwd_embsh_plain(*eargs, ybar, param_grads=True),
                          3)),
            "b6": (cuda_time(lambda: dense_conv_pallas(
                layer.conv, layer.radial_mlp, x, emb_l.view(N, K, -1), sh_l.view(N, K, -1), src,
                ws), reps), cuda_time(lambda: fc.fused_conv_fwd_embsh_plain(*eargs), 3)),
        }
        per_shape[tag] = {"reduce_lib": reduce_lib}
        for k in KERNELS:
            tk, tp = times[k]
            fl, by, tc = work(op_e if "embsh" in k or k == "b6" else op, N, K, n_edges,
                              "fwd_embsh" if k == "b6" else k)
            per_shape[tag][k] = (tk, tp, (fl, by, tc), errs[k])
            log(f"  {tag} {k}: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound "
                f"{bound_ms(fl, by, tc)[0]:.4f} ms (fp32 {bound_ms(fl, by)[0]:.4f} ms; "
                f"{fl / 1e9:.2f} GFLOP of which {tc / 1e9:.2f} 3xTF32, {by / 1e6:.1f} MB), "
                f"{fl / tk / 1e9:.2f} TFLOP/s")
        del work_, valid
        torch.cuda.empty_cache()
    records = {}
    for k in KERNELS:
        rows = [(per_shape[tag][k], n) for tag, _, n in SHAPES]
        records[k] = dict(ms=sum(n * r[0] for r, n in rows), plain_ms=sum(n * r[1] for r, n in rows),
                          flops=sum(n * r[2][0] for r, n in rows),
                          bytes=sum(n * r[2][1] for r, n in rows),
                          tc_flops=sum(n * r[2][2] for r, n in rows), err=max(r[3] for r, _ in rows))
    records["reduce"]["library_ms"] = sum(n * per_shape[tag]["reduce_lib"] for tag, _, n in SHAPES)
    return records, np.asarray([N, K, n_edges])


def slot_check(eng, st, dev, card: str):
    """The ring backward's per-chunk kernel against its plain twin at the
    shape the ring engine ``eng`` runs it on the state ``st``: B3
    (``fused_conv_bwd_slot``: B2 on one row chunk, its dxg written into a
    slot of the ring's buffer) in vec mode, B4 bwd's slot entry
    (``fused_conv_bwd_embsh_slot``) on a legacy model's emb/sh. Chunks of
    RC = ``eng.row_chunk`` rows of K = ``eng.k_model`` slots on the state's
    edges, x over all nb * RC rows, a buffer of 4W + 1 slots pre-filled
    with a sentinel; at the three SevenNet-0 layer shapes, random x and
    ybar. For an interior and a wrapped (pinned) chunk: the slot's dxg and
    the chunk's dvec (or demb and dsh) within REL_TOL of max |plain|, every
    other slot bitwise unchanged. Times: the kernel over the nb chunks per
    force evaluation (layer 0 + 3 x layers 1-3 + layer 4), CUDA events;
    bound: B2's (B4 bwd's) work over the chunks' rows. Returns the
    kernels-line record."""
    import torch

    from sevennet_tpu_torch.model.model import _vec_mode, edge_emb_sh, edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    spec = eng.spec
    vec_mode = _vec_mode(spec)
    N, K, RC, W, nb = st.n_atoms_cap, eng.k_model, eng.row_chunk, eng._ring_w, eng._ring_nb
    S = 4 * W + 1
    g = eng._graph(st)
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=dev)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel[:, None]).contiguous()
    src = g.edge_src.view(N, K).to(torch.int32).contiguous()
    coef = eng.params["edge_embedding"]["bessel_coeffs"]
    valid = g.edge_mask.view(N, K)
    gen = torch.Generator(device="cpu").manual_seed(4)
    if vec_mode:
        name, kind = "B3", "bwd"
        fn, twin, plain = fc.fused_conv_bwd_slot, fc.fused_conv_bwd_slot_plain, fc.fused_conv_bwd_plain

        def chunk(j, ybar):
            src_c, vec_c, yb = fc._chunk(RC, K, j, src, vec, ybar)
            return src_c, vec_c, coef, yb
    else:
        name, kind = "B4 bwd slot", "bwd_embsh"
        fn, twin = fc.fused_conv_bwd_embsh_slot, fc.fused_conv_bwd_embsh_slot_plain
        plain = fc.fused_conv_bwd_embsh_plain
        emb, sh = (t.contiguous() for t in edge_emb_sh(spec, coef, vec, g.edge_mask))

        def chunk(j, ybar):
            rows = slice(j * RC * K, (j + 1) * RC * K)
            return src[j * RC:(j + 1) * RC], emb[rows], sh[rows], ybar[j * RC:(j + 1) * RC]

    log(f"  {name} at the ring's shape: N={N} K={K}, {nb} chunks of RC={RC} rows, W={W}, "
        f"{S} slots")
    rec = dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, tc_flops=0.0, err=0.0)
    for tag, t, n_layers in SHAPES:
        layer = spec.layers[t]
        op = fc.conv_op(layer.conv, layer.radial_mlp,
                        edge_embed_spec(spec, layer) if vec_mode else None)
        ws = eng.params[f"{t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, op.dim_x, generator=gen).to(dev)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
        buf = torch.full((S * RC * K, op.dim_x), -7.25e30, device=dev)
        for j in (nb // 2, 0):  # an interior chunk and a wrapped (pinned) one
            slot = fc.ring_slot(j, W)
            before = buf.clone()
            src_c, a_c, b_c, yb = chunk(j, ybar)
            out = fn(op, x, src_c, a_c, b_c, ws, yb, buf, slot)
            dxg_p, *edge_p = plain(op, x, src_c, a_c, b_c, ws, yb)
            torch.cuda.synchronize()
            rows = slice(slot * RC * K, (slot + 1) * RC * K)
            errs = [check_close(f"{tag} chunk {j}", f"{name} dxg in its slot", buf[rows], dxg_p)]
            errs += [check_close(f"{tag} chunk {j}", f"{name} d{e}", got, want) for e, got, want
                     in zip(("vec",) if vec_mode else ("emb", "sh"),
                            (out,) if vec_mode else out, edge_p)]
            rec["err"] = max(rec["err"], *errs)
            other = torch.ones(S * RC * K, dtype=torch.bool, device=dev)
            other[rows] = False
            if not torch.equal(buf[other], before[other]):
                raise SystemExit(f"{name} at {tag}, chunk {j}: rows outside slot {slot} changed")
            log(f"  {tag} chunk {j} (slot {slot}): the other {S - 1} slots bitwise unchanged")
            del dxg_p, edge_p, before, other
        torch.cuda.empty_cache()

        chunks = [chunk(j, ybar) for j in range(nb)]

        def run(f):
            return lambda: [f(op, x, s_c, a_c, b_c, ws, y_c, buf, fc.ring_slot(j, W))
                            for j, (s_c, a_c, b_c, y_c) in enumerate(chunks)]

        tk = cuda_time(run(fn), 3)
        tp = cuda_time(run(twin), 1)
        parts = [work(op, RC, K, int(valid[j * RC:(j + 1) * RC].sum()), kind) for j in range(nb)]
        fl, by, tc = (sum(p[i] for p in parts) for i in range(3))
        log(f"  {tag} {name} over {nb} chunks: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound "
            f"{bound_ms(fl, by, tc)[0]:.4f} ms (fp32 {bound_ms(fl, by)[0]:.4f} ms; "
            f"{fl / 1e9:.2f} GFLOP, {by / 1e6:.1f} MB) | {card}")
        for key, v in (("ms", tk), ("plain_ms", tp), ("flops", fl), ("bytes", by),
                       ("tc_flops", tc)):
            rec[key] += n_layers * v
        del buf, chunks, x, ybar
        torch.cuda.empty_cache()
    return rec


def b6_path(spec, params, dev, atoms):
    """B6's own path: ``dense_conv_pallas`` (the counterpart of the JAX
    package's, whose one caller runs a forward conv) over the five
    SevenNet-0 layers of the box, on the legacy model's emb/sh and random
    features, counts from 0. Returns the launches."""
    import torch

    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.model.model import edge_emb_sh
    from sevennet_tpu_torch.ops.pallas_conv import dense_conv_pallas

    calc = SevenNetCalculator(spec, params, device=str(dev))
    g = calc.graph(atoms)
    N, K = g.n_atoms_cap, g.dense_k
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=dev)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel[:, None])
    emb, sh = edge_emb_sh(spec, calc.params["edge_embedding"]["bessel_coeffs"], vec, g.edge_mask)
    gen = torch.Generator(device="cpu").manual_seed(3)
    src = g.edge_src.view(N, K)
    reset_launches()
    for layer in spec.layers:
        ws = calc.params[f"{layer.t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, layer.conv.irreps_x.dim, generator=gen).to(dev)
        out = dense_conv_pallas(layer.conv, layer.radial_mlp, x, emb.view(N, K, -1),
                                sh.view(N, K, -1), src, ws)
        if out.shape != (N, layer.conv.irreps_mid.dim) or not bool(torch.isfinite(out).all()):
            raise SystemExit(f"B6 path, layer {layer.t}: {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    counts = read_launches()
    want = dict.fromkeys(counts, 0)
    want["b6"] = len(spec.layers)
    if counts != want:
        raise SystemExit(f"B6 path launches {counts}, expected {want}")
    return counts


def counters():
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops.pallas_conv import dense_conv_pallas

    return {"fwd": fc.fused_conv_fwd, "bwd": fc.fused_conv_bwd, "bwd_slot": fc.fused_conv_bwd_slot,
            "bwd_pg": fc.fused_conv_bwd_pg_records, "reduce": fc.param_grad_reduce,
            "fwd_embsh": fc.fused_conv_fwd_embsh, "bwd_embsh": fc.fused_conv_bwd_embsh,
            "bwd_embsh_pg": fc.fused_conv_bwd_embsh_pg_records,
            "bwd_embsh_slot": fc.fused_conv_bwd_embsh_slot, "b6": dense_conv_pallas}


def reset_launches():
    for fn in counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in counters().items()}


def host_graph_split(calc, at, reps: int = REPS):
    """Median wall ms of the host graph's parts as the calculator runs
    them (the neighbour list, the sort by receiver, the device densify with
    the mirror map, synchronised), and of the host graph before them
    (scipy's list and the host densify with ``mirror_map_numpy``, then the
    copy to the card): ``(list, sort, densify, before)``."""
    import torch

    from sevennet_tpu_torch.data.graph import (
        dense_graph_device,
        dense_graph_from_arrays,
        receiver_sorted,
    )
    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy, neighbor_list_scipy

    species = calc.spec.z_to_type[at.numbers]
    parts = {"list": [], "sort": [], "densify": [], "before": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        dst, src, sh = neighbor_list_numpy(at.positions, calc.spec.cutoff, at.cell, at.pbc)
        t1 = time.perf_counter()
        dst, src, sh = receiver_sorted(dst, src, sh)
        t2 = time.perf_counter()
        dense_graph_device(at.positions, species, src, dst, sh, at.cell, device=calc.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        dst, src, sh = neighbor_list_scipy(at.positions, calc.spec.cutoff, at.cell, at.pbc)
        dense_graph_from_arrays(at.positions, species, src, dst, sh, at.cell, device=calc.device)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, a, b in (("list", t0, t1), ("sort", t1, t2), ("densify", t2, t3),
                          ("before", t3, t4)):
            parts[key].append((b - a) * 1e3)
    return tuple(statistics.median(parts[k]) for k in ("list", "sort", "densify", "before"))


def request_errors(got, want):
    """max |dF|, max |F_want|, relative dE, max |dS| of two requests."""
    import numpy as np

    df = float(np.abs(got["forces"] - want["forces"]).max())
    fmax = float(np.abs(want["forces"]).max())
    de = abs(got["energy"] - want["energy"]) / max(abs(want["energy"]), 1e-30)
    ds = float(np.abs(got["stress"] - want["stress"]).max())
    return df, fmax, de, ds


def check_request(label, got, want):
    """The request limits of PERF.md section 2."""
    df, fmax, de, ds = request_errors(got, want)
    for ok, why in ((df <= FORCE_TOL, f"max|dF| {df} > {FORCE_TOL} eV/A"),
                    (df <= FORCE_REL_TOL * fmax, f"max|dF| {df} > {FORCE_REL_TOL} * {fmax}"),
                    (de <= ENERGY_REL_TOL, f"rel dE {de} > {ENERGY_REL_TOL}"),
                    (ds <= STRESS_TOL, f"max|dS| {ds} > {STRESS_TOL} eV/A^3")):
        if not ok:
            raise SystemExit(f"{label}: {why}")
    return (f"max|dF| {df:.3e} eV/A (max|F| {fmax:.3e}), rel dE {de:.3e}, "
            f"max|dS| {ds:.3e} eV/A^3")


def request_phase(spec, params, dev, label: str, fwd: str, bwd: str, graph_times: bool = True,
                  sizes=SIZES, plain_max: int = PLAIN_MAX_ATOMS, energies=None):
    """Calculator requests at full width for water boxes of ``sizes``
    atoms, each launching the kernels ``fwd`` and ``bwd`` (keys of
    :func:`counters`) once per layer and no other, held against the
    plain-conv model up to ``plain_max`` atoms; with ``graph_times`` the
    host graph's parts timed (:func:`host_graph_split`). Returns the
    launches of each kernel over the whole phase; ``energies`` (a dict)
    gets each size's energy."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
    from sevennet_tpu_torch.model.model import model_compute

    calc = SevenNetCalculator(spec, params, device=str(dev))
    plain = SevenNetCalculator(spec, params, device=str(dev), plain=True)
    boxes = {n: water_box(n // 3) for n in sizes}
    reset_launches()
    for n in sizes:
        pos, Z, cell = boxes[n]
        at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
        torch.cuda.reset_peak_memory_stats()
        before = read_launches()
        res = calc.calculate(at)
        got = {k: v - before[k] for k, v in read_launches().items()}
        want = dict.fromkeys(got, 0)
        want[fwd] = want[bwd] = len(spec.layers)
        if got != want:
            raise SystemExit(f"{label} request, {n} atoms: launches {got}, expected {want}")
        if not (np.isfinite(res["energy"]) and np.isfinite(res["forces"]).all()
                and np.isfinite(res["stress"]).all()):
            raise SystemExit(f"{n} atoms: non-finite results")
        if res["forces"].shape != (n, 3) or res["stress"].shape != (6,):
            raise SystemExit(f"{n} atoms: forces {res['forces'].shape}, "
                             f"stress {res['stress'].shape}")
        drift = float(np.abs(res["forces"].sum(0)).max())
        if energies is not None:
            energies[n] = res["energy"]
        line = (f"{label} request {n} atoms: E={res['energy']:.6f} eV, "
                f"|sum F|={drift:.2e}, launches {got[fwd]} {fwd} + {got[bwd]} {bwd}")
        if n <= plain_max:
            line += ", vs plain: " + check_request(
                f"{n} atoms: kernel path against plain path", res, plain.calculate(at))
        log(line)
        # timing after the request above as warm-up: host wall clock of
        # whole requests (neighbour list and host-device copies included),
        # and CUDA events around the model on a prebuilt graph
        walls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            calc.calculate(at)
            walls.append((time.perf_counter() - t0) * 1e3)
        graph_walls = []
        for _ in range(REPS if graph_times else 1):
            t0 = time.perf_counter()
            graph = calc.graph(at)
            torch.cuda.synchronize()
            graph_walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        model_ms = cuda_median(lambda: model_compute(spec, calc.params, graph, True, device=dev),
                               REPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        host = (f"host graph median {statistics.median(graph_walls):.1f} ms (wall), "
                if graph_times else "")
        if graph_times:
            served = dict(neighbor_list_numpy.served)
            lst, srt, dens, before = host_graph_split(calc, at)
            builders = {k: v - served[k] for k, v in neighbor_list_numpy.served.items()}
            log(f"  {label} {n} atoms host graph: list {lst:.2f} ms, sort {srt:.2f} ms, device "
                f"densify + mirror map {dens:.2f} ms (wall medians, {REPS} runs); before "
                f"(scipy list + host densify + copy) {before:.2f} ms; lists served {builders}")
        log(f"  {label} {n} atoms: K={graph.dense_k} edges={int(graph.edge_mask.sum())} "
            f"request median {statistics.median(walls):.1f} ms (wall, {REPS} runs), {host}"
            f"model median {model_ms:.2f} ms (CUDA events, {REPS} runs), "
            f"model peak mem {peak:.2f} GiB")
    return read_launches()


def training_set(spec, params_teacher, dev, seed: int, path: str):
    """TRAIN_BOXES water boxes of 192 atoms, jittered from ``seed``, labelled
    (energy, forces, stress) by a teacher of the same architecture through
    the port's calculator; written as extxyz to ``path``."""
    import numpy as np

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.data.extxyz import write_extxyz

    teacher = SevenNetCalculator(spec, params_teacher, device=str(dev))
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(TRAIN_BOXES):
        pos, Z, cell = water_box(64, seed=seed * 1000 + i)
        pos = pos + rng.normal(scale=0.05, size=pos.shape)
        r = teacher.calculate(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
        # ASE Voigt (xx,yy,zz,yz,xz,xy) -> the label: -stress, (xx,yy,zz,xy,yz,zx)
        label = -np.asarray(r["stress"])[[0, 1, 2, 5, 3, 4]]
        frames.append(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True,
                                energy=r["energy"], forces=r["forces"], stress=label))
    write_extxyz(path, frames)
    return frames


def step_breakdown(spec, trainer, batch):
    """Parts of a train step at the batch's shapes, ms, CUDA events: the
    energy and forces with the graph kept (``model_compute(...,
    create_graph=True)``, median of 5), and per step the kernels (5 B1 and
    2 x 5 B2' launches) and the conv's plain second-order rule (5 calls),
    each layer on the batch's edge vectors with random x, cotangent and
    second-order cotangents (mean of 5)."""
    import torch

    from sevennet_tpu_torch.model.model import edge_embed_spec, model_compute
    from sevennet_tpu_torch.ops import fused_conv as fc

    N, K = batch.n_atoms_cap, batch.dense_k
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=batch.device)
    vec = torch.where(batch.edge_mask[None], batch.edge_vectors().T, sentinel[:, None]).contiguous()
    src = batch.edge_src.view(N, K).to(torch.int32).contiguous()
    coef = trainer.params["edge_embedding"]["bessel_coeffs"].detach()
    gen = torch.Generator(device="cpu").manual_seed(2)
    out = {"fwd_forces": cuda_median(lambda: model_compute(
        spec, trainer.params, batch, device=batch.device, create_graph=True), REPS),
        "b1": 0.0, "b2pg": 0.0, "second_order": 0.0}
    for layer in spec.layers:
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        ws = [w.detach() for w in trainer.params[f"{layer.t}_convolution"]["weight_nn"]["w"]]

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).to(batch.device)

        x, ybar = rnd(N, op.dim_x), rnd(N, op.dim_mid)
        cots = (rnd(N * K, op.dim_x), rnd(3, N * K))
        out["b1"] += cuda_time(lambda: fc.fused_conv_fwd(op, x, src, vec, coef, ws), 5)
        out["b2pg"] += 2 * cuda_time(lambda: fc.fused_conv_bwd(
            op, x, src, vec, coef, ws, ybar, param_grads=True), 5)
        out["second_order"] += cuda_time(lambda: fc.fused_conv_bwd_vjp_plain(
            op, x, src, vec, coef, ws, ybar, cots), 5)
    return out


def reduce_batch(spec, trainer, batch, card):
    """The B2' reduction on one training batch's records (``reduce_check``),
    each layer's on the batch's edge vectors with random x and cotangent;
    per step B2' runs it twice a layer. Returns the summed (ms, library_ms)
    of a step."""
    import torch

    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    N, K = batch.n_atoms_cap, batch.dense_k
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=batch.device)
    vec = torch.where(batch.edge_mask[None], batch.edge_vectors().T, sentinel[:, None]).contiguous()
    src = batch.edge_src.view(N, K).to(torch.int32).contiguous()
    coef = trainer.params["edge_embedding"]["bessel_coeffs"].detach()
    gen = torch.Generator(device="cpu").manual_seed(3)
    ms = lib = 0.0
    for layer in spec.layers:
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        ws = [w.detach() for w in trainer.params[f"{layer.t}_convolution"]["weight_nn"]["w"]]
        x = torch.randn(N, op.dim_x, generator=gen).to(batch.device)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(batch.device)
        _, _, work_, valid = fc.fused_conv_bwd_pg_records(op, x, src, vec, coef, ws, ybar)
        k_ms, _, l_ms, _ = reduce_check(f"train batch layer {layer.t}", op, work_, valid, N, K)
        ms += 2 * k_ms
        lib += 2 * l_ms
    log(f"  train batch (N={N}, K={K}): the reduction per step (2 x 5 calls) kernel {ms:.4f} ms, "
        f"library {lib:.4f} ms | {card}")
    return ms, lib


def compare_steps(label, kern, plain, batches, want, card):
    """TRAIN_CMP_STEPS train steps of ``kern`` (the kernel path), each held
    against the plain path's loss and gradients at the same weights and
    batch, each launching exactly ``want``. Returns the launches summed over
    the steps."""
    import numpy as np
    import torch

    total = dict.fromkeys(want, 0)
    for step in range(TRAIN_CMP_STEPS):
        b = batches[step % len(batches)]
        torch.cuda.reset_peak_memory_stats()
        total_p, _, _ = plain._loss_and_metrics(kern.params, b)
        g_plain = torch.autograd.grad(total_p, kern.trainable)
        loss_p = total_p.item()
        del total_p
        peak_plain = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, _ = kern.train_step(b)
        counts = read_launches()
        peak_kern = torch.cuda.max_memory_allocated() / 2**30
        loss_k = losses["total"].item()
        rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
        worst = 0.0
        for p, gp in zip(kern.trainable, g_plain):
            err = float((p.grad - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
            worst = max(worst, err)
            if not (bool(torch.isfinite(p.grad).all()) and err <= GRAD_REL_TOL):
                raise SystemExit(f"{label} train step {step + 1}: gradient leaf {tuple(p.shape)} "
                                 f"differs from the plain path by {err:.3e} of its max")
        log(f"  {label} step {step + 1}: loss kernel {loss_k:.8e} plain {loss_p:.8e} rel "
            f"{rel:.3e} (tol {LOSS_REL_TOL:g}); worst gradient leaf {worst:.3e} of its max "
            f"(tol {GRAD_REL_TOL:g}); launches {counts}; peak GiB kernel {peak_kern:.2f} "
            f"plain {peak_plain:.2f} | {card}")
        if not (np.isfinite(loss_k) and rel <= LOSS_REL_TOL):
            raise SystemExit(f"{label} train step {step + 1}: loss {loss_k} vs plain {loss_p}")
        if counts != want:
            raise SystemExit(f"{label} train step {step + 1}: launches {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
        del g_plain
    return total


def dataset_check(trainset, z2t, K: int, batches, tmp: str, card: str):
    """The training set's data paths on this machine: the graphs built over
    a fork pool of 4 processes (``preprocess_num_cores: 4``) bitwise equal
    to the serial build's; the disk cache (the JAX package's format)
    written and loaded back to the same graphs and statistics; lazy batches,
    built as they are made, bitwise equal to the built set's ``batches``
    (the same shuffle)."""
    import os

    import torch

    from sevennet_tpu_torch.data.dataset import CACHE_KEYS, GraphDataset

    def same(a, b, keys):  # bit for bit, NaN labels equal
        return all(torch.equal(*(torch.nan_to_num(getattr(g, k), nan=7.25e30) for g in (a, b)))
                   for k in keys)

    t0 = time.perf_counter()
    pooled = GraphDataset(list(trainset.atoms_list), trainset.cutoff).build(z2t, processes=4)
    t_pool = time.perf_counter() - t0
    if not all(same(a, b, CACHE_KEYS) for a, b in zip(pooled.graphs, trainset.graphs)):
        raise SystemExit("the 4-process build differs from the serial one")
    path = os.path.join(tmp, "trainset_cache")
    pooled.save_cache(path)
    cached = GraphDataset.load_cache(path)
    if (not all(same(a, b, CACHE_KEYS) for a, b in zip(cached.graphs, trainset.graphs))
            or cached.statistics != trainset.statistics):
        raise SystemExit("the cache does not load back to the built graphs and statistics")
    lazy = GraphDataset(list(trainset.atoms_list), trainset.cutoff, z2t)
    got = list(lazy.batches(TRAIN_BATCH, shuffle=True, seed=1, dense_k=K, lazy=True))
    fields = ("positions", "species", "edge_src", "edge_shift", "edge_mask", "edge_mir", "energy",
              "forces", "stress", "batch", "atom_mask")
    if len(got) != len(batches) or not all(same(a.to(b.device), b, fields)
                                           for a, b in zip(got, batches)):
        raise SystemExit("lazy batches differ from the built set's")
    log(f"  data: the 4-process build ({t_pool:.2f} s), the cache round trip "
        f"({os.path.getsize(path + '.npz') / 1e6:.2f} MB) and {len(got)} lazy batches equal the "
        f"serial build | {card}")


def data_parallel_check(spec, params, tcfg, batch, dev, card: str):
    """Data-parallel training on the card: one train step of a trainer in a
    world-1 ``nccl`` group (``Trainer(data_parallel=True)``: the broadcast,
    the flattened gradient all-reduce, the losses and metrics reduced)
    bitwise equal, parameters and losses, to the same step of a trainer
    without a group; a second trainer without a group says whether the
    step itself repeats bit for bit. NCCL refuses two ranks on one device,
    so the two-rank check is the CPU test (tests/test_torch_dp.py)."""
    import socket

    import torch
    import torch.distributed as dist

    from sevennet_tpu_torch.train.trainer import Trainer, init_process_group, tree_leaves

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_process_group(f"tcp://localhost:{port}", 0, 1, device=str(dev))
    try:
        runs = []
        for dp in (True, False, False):
            trainer = Trainer(spec, params, tcfg, device=str(dev), data_parallel=dp)
            trainer.set_epoch(0)
            losses, _ = trainer.train_step(batch)
            runs.append(([p.detach().clone() for p in tree_leaves(trainer.params)],
                         {k: v.clone() for k, v in losses.items()}))
            del trainer
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()

    def equal(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
                and all(torch.equal(a[1][k], b[1][k]) for k in a[1]))

    repeats = equal(runs[1], runs[2])
    ok = equal(runs[0], runs[1])
    log(f"  data parallel: a world-1 nccl step {'bitwise equal' if ok else 'DIFFERS from'} the "
        f"step without a group ({len(runs[0][0])} parameter leaves and "
        f"{len(runs[0][1])} losses); the step without a group repeats bit for bit: {repeats} "
        f"| {card}")
    if not ok:
        raise SystemExit("the world-1 data-parallel step differs from the plain trainer step")


def training_phase(dev, seed: int, card: str):
    """SevenNet-0 training on the card: the kernel path against the plain
    path for TRAIN_CMP_STEPS steps, step timing, the same for the legacy
    config (unnormalized spherical harmonics: B4 and B4'), then
    ``train_run`` (the main path). Returns the launches of the ``train_run``
    run and of the legacy config's compared steps."""
    import csv
    import os

    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.data.dataset import GraphDataset
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.io.native_checkpoint import load_checkpoint
    from sevennet_tpu_torch.logger import Logger
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.scripts.train import dense_capacity, resolve_statistics, train_run
    from sevennet_tpu_torch.train import LossConfig, Trainer, TrainerConfig
    from sevennet_tpu_torch.train.trainer import tree_map

    spec0 = sevennet0_spec()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        path = os.path.join(tmp, "water.extxyz")
        teacher = params_from_numpy(spec0, random_params(spec0, seed + 1))
        training_set(spec0, teacher, dev, seed, path)
        model_cfg = dict(SEVENNET0, shift="per_atom_energy_mean", scale="force_rms",
                         conv_denominator="avg_num_neigh")
        train_cfg = {"epoch": TRAIN_EPOCHS, "optimizer": "adam", "optim_param": {"lr": TRAIN_LR},
                     "force_loss_weight": 0.1, "stress_loss_weight": 1e-6, "per_epoch": 1,
                     "random_seed": seed}
        data_cfg = {"batch_size": TRAIN_BATCH, "load_trainset_path": [path], "ratio": 0.25,
                    "preprocess_num_cores": 4}

        # train_run's set-up, to hold its first steps against the plain path:
        # split, statistics, spec, weights from the seed, K, batch order
        trainset, validset = GraphDataset.from_files(path, SEVENNET0["cutoff"]).split(0.25)
        cfg = dict(model_cfg)
        resolve_statistics(cfg, data_cfg, trainset, Logger(None, screen=False))
        spec = build_model_spec(cfg)
        params = params_from_numpy(spec, random_params(spec, seed))
        trainset.build(spec.z_to_type)
        validset.build(spec.z_to_type)
        K = dense_capacity(max(trainset.max_neighbors(), validset.max_neighbors()))
        batches = [b.to(dev) for b in
                   trainset.batches(TRAIN_BATCH, shuffle=True, seed=1, dense_k=K)]
        tcfg = TrainerConfig(loss=LossConfig(force_weight=0.1, stress_weight=1e-6),
                             optimizer="adam", lr=TRAIN_LR)
        kern = Trainer(spec, params, tcfg, device=str(dev))
        plain = Trainer(spec, params, tcfg, device=str(dev), plain=True)
        kern.set_epoch(0)
        n_layers = len(spec.layers)
        log(f"training: {len(trainset)} train / {len(validset)} valid structures of "
            f"{len(trainset.atoms_list[0])} atoms, batch {TRAIN_BATCH}, K={K}, "
            f"batch capacity {batches[0].n_atoms_cap} atoms, "
            f"{int(batches[0].edge_mask.sum())} edges")
        # each step: the plain path's loss and gradients at the kernel path's
        # current weights, then the kernel path's step (same weights, same batch)
        want = dict(dict.fromkeys(counters(), 0), fwd=n_layers, bwd_pg=2 * n_layers,
                    reduce=2 * n_layers)
        compare_steps("vec", kern, plain, batches, want, card)
        dataset_check(trainset, spec.z_to_type, K, batches, tmp, card)
        data_parallel_check(spec, params, tcfg, batches[0], dev, card)
        reset_launches()
        kern.eval_step(batches[0])
        log(f"  eval step launches: {read_launches()}")

        # step timing on one batch, CUDA events
        b = batches[0]
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_median(lambda: kern.train_step(b), REPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_ms = cuda_median(lambda: plain.train_step(b), 2)
        parts = step_breakdown(spec, kern, b)
        reduce_batch(spec, kern, b, card)
        n_struct = int(b.graph_mask.sum())
        kern_ms = parts["b1"] + parts["b2pg"]
        log(f"  train step: median {step_ms:.2f} ms ({REPS} runs, CUDA events), "
            f"{n_struct / step_ms * 1e3:.1f} structures/s, peak {peak:.2f} GiB; plain path "
            f"{plain_ms:.2f} ms (median of 2) | {card}")
        log(f"  step parts: energy + forces with the graph kept {parts['fwd_forces']:.2f} ms, "
            f"the rest (loss backward, optimizer) {step_ms - parts['fwd_forces']:.2f} ms; "
            f"kernels per step B1 {parts['b1']:.3f} ms + B2' {parts['b2pg']:.3f} ms = "
            f"{100 * kern_ms / step_ms:.1f} % of the step; the conv's plain second-order rule "
            f"{parts['second_order']:.2f} ms = "
            f"{100 * parts['second_order'] / step_ms:.1f} % | {card}")
        del kern, plain

        # the legacy config: the same data, B4 and B4' in place of B1 and B2'
        spec_l = build_model_spec(dict(cfg, _normalize_sph=False))
        params_l = params_from_numpy(spec_l, random_params(spec_l, seed))
        kern = Trainer(spec_l, params_l, tcfg, device=str(dev))
        plain = Trainer(spec_l, params_l, tcfg, device=str(dev), plain=True)
        kern.set_epoch(0)
        want = dict(dict.fromkeys(counters(), 0), fwd_embsh=n_layers, bwd_embsh_pg=2 * n_layers,
                    reduce=2 * n_layers)
        legacy = compare_steps("legacy", kern, plain, batches, want, card)
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_median(lambda: kern.train_step(b), REPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_ms = cuda_median(lambda: plain.train_step(b), 2)
        log(f"  legacy train step: median {step_ms:.2f} ms ({REPS} runs, CUDA events), "
            f"{n_struct / step_ms * 1e3:.1f} structures/s, peak {peak:.2f} GiB; plain path "
            f"{plain_ms:.2f} ms (median of 2) | {card}")
        del kern, plain, batches
        torch.cuda.empty_cache()

        # the main path: train_run, counts from 0
        wd = os.path.join(tmp, "run")
        reset_launches()
        trainer = train_run(dict(model_cfg), dict(train_cfg), dict(data_cfg), working_dir=wd,
                            device=str(dev))
        counts = read_launches()
        n_train = TRAIN_EPOCHS * -(-len(trainset) // TRAIN_BATCH)
        n_eval = TRAIN_EPOCHS * -(-len(validset) // TRAIN_BATCH)
        want = dict(dict.fromkeys(counters(), 0), fwd=n_layers * (n_train + n_eval),
                    bwd=n_layers * n_eval, bwd_pg=2 * n_layers * n_train,
                    reduce=2 * n_layers * n_train)
        log(f"train_run: {n_train} train steps, {n_eval} eval steps, launches {counts}")
        if counts != want:
            raise SystemExit(f"train_run launches {counts}, expected {want}")
        with open(os.path.join(wd, "lc.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != TRAIN_EPOCHS:
            raise SystemExit(f"lc.csv has {len(rows)} rows, expected {TRAIN_EPOCHS}")
        for r in rows:
            vals = {k: float(v) for k, v in r.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise SystemExit(f"non-finite losses in lc.csv: {r}")
            log(f"  epoch {int(vals['epoch'])}: train loss {vals['train_loss_total']:.6e} "
                f"(E {vals['train_loss_energy']:.4e}, F {vals['train_loss_force']:.4e}, "
                f"S {vals['train_loss_stress']:.4e}), "
                f"valid loss {vals['valid_loss_total']:.6e} | {card}")
        spec_ck, params_ck, meta = load_checkpoint(os.path.join(wd, "checkpoint_last"))
        pos, Z, cell = water_box(64, seed=seed * 1000 + 999)
        at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
        e_loaded = SevenNetCalculator(spec_ck, params_ck, device=str(dev)).calculate(at)["energy"]
        e_trained = SevenNetCalculator(trainer.spec, tree_map(lambda p: p.detach(), trainer.params),
                                       device=str(dev)).calculate(at)["energy"]
        log(f"  checkpoint_last (epoch {meta['epoch']}) reloads: E {e_loaded:.8f} vs trained "
            f"{e_trained:.8f} eV")
        # not bit for bit: the per-graph energy sum (index_add_ on CUDA) adds in
        # no fixed order
        if spec_ck != trainer.spec or abs(e_loaded - e_trained) > 1e-6 * abs(e_trained):
            raise SystemExit("the reloaded checkpoint gives other energies")
        return counts, legacy


def unsorted(state, n, name):
    """Rows of ``state.<name>`` in the input order (``atom_index``), numpy."""
    import numpy as np

    a = getattr(state, name).cpu().numpy()
    idx = state.atom_index.cpu().numpy()
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    real = idx < n
    out[idx[real]] = a[real]
    return out


def slots_match_host(eng, st):
    """The slots of the engine's last device rebuild against a host build at
    the same positions: per row the same ``(src, shift)`` set, the same skin
    limit (1e-4 relative), and every mirror pointing back (``src[mir[e]]``
    is the row of ``e``, the shift negated, ``mir[mir[e]] == e``). Returns
    the number of edges."""
    import numpy as np

    n_cap, K = st.n_atoms_cap, eng.k_model
    host = eng._host_initial_edges(st.nl_positions[: int(st.atom_mask.sum())].cpu().numpy(),
                                   n_cap, st.cell.cpu().numpy())
    if host is None:
        raise SystemExit("the host build at the rebuilt positions failed its capacity checks")
    rows = np.repeat(np.arange(n_cap), K)
    src, shift = st.edge_src.cpu().numpy(), st.edge_shift.cpu().numpy()
    mask, mir = st.edge_mask.cpu().numpy(), st.edge_mir.cpu().numpy()

    def edge_set(s_, sh_, m_):
        return set(zip(rows[m_].tolist(), s_[m_].tolist(),
                       *[np.rint(sh_[m_, i]).astype(int).tolist() for i in range(3)]))

    if edge_set(src, shift, mask) != edge_set(host["src"], host["shift"], host["mask"]):
        raise SystemExit("the device rebuild's slots differ from a host build")
    if abs(float(st.nl_limit) - float(host["limit"])) > 1e-4 * float(host["limit"]):
        raise SystemExit(f"the device rebuild's skin limit {float(st.nl_limit)} differs from a "
                         f"host build's {float(host['limit'])}")
    e = np.flatnonzero(mask)
    if not ((src[mir[e]] == rows[e]).all() and (shift[mir[e]] == -shift[e]).all()
            and (mir[mir[e]] == e).all()):
        raise SystemExit("the device rebuild's mirror map does not pair the edges")
    return len(e)


def cut_margin(eng, st) -> float:
    """``d_drop - cutoff`` of the state's last slot build: ``d_drop`` is the
    nearest distance past each row's K nearest in a host list at cutoff +
    skin at the build's positions (inf: nothing cut)."""
    import numpy as np

    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy

    rows = np.flatnonzero(st.atom_mask.cpu().numpy())
    pos = st.nl_positions.cpu().numpy()[rows].astype(np.float64)
    cell = st.cell.cpu().numpy().astype(np.float64)
    dst, src, sh = neighbor_list_numpy(pos, eng.spec.cutoff + eng.skin, cell, (True,) * 3)
    d = np.linalg.norm(pos[src] + sh @ cell - pos[dst], axis=1)
    order = np.lexsort((d, dst))
    dst, d = dst[order], d[order]
    cut = np.arange(len(dst)) - np.searchsorted(dst, dst) >= eng.k_model
    return float(d[cut].min() - eng.spec.cutoff) if cut.any() else float("inf")


def missing_pairs(eng, st) -> int:
    """The pairs within the cutoff at the state's positions (a host list)
    that hold no masked slot: 0 when the slots are complete."""
    import numpy as np

    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy

    rows = np.flatnonzero(st.atom_mask.cpu().numpy())
    pos = st.positions.cpu().numpy()[rows].astype(np.float64)
    dst, src, sh = neighbor_list_numpy(pos, eng.spec.cutoff, st.cell.cpu().numpy(), (True,) * 3)
    want = set(zip(rows[dst].tolist(), rows[src].tolist(), *np.rint(sh).astype(int).T.tolist()))
    slot_row = np.repeat(np.arange(st.n_atoms_cap), eng.k_model)
    m = st.edge_mask.cpu().numpy()
    have = set(zip(slot_row[m].tolist(), st.edge_src.cpu().numpy()[m].tolist(),
                   *np.rint(st.edge_shift.cpu().numpy()[m]).astype(int).T.tolist()))
    return len(want - have)


def skin_line(eng, st, rebuilds: int, steps: int) -> str:
    """K, the nearest cut distance less the cutoff (host list at the last
    build's positions), the state's limit as ``min(skin, d_drop - cutoff)``
    and the device rebuilds per 100 steps."""
    margin = 2.0 * float(st.nl_limit) ** 0.5
    return (f"K {eng.k_model} of {eng.cl_spec.neighbor_capacity}, d_drop - cutoff "
            f"{cut_margin(eng, st):.4f} A at the last build (limit min(skin, d_drop - cutoff) "
            f"{margin:.4f} A), {100.0 * rebuilds / steps:.1f} device rebuilds per 100 steps")


def record_evaluations(eng):
    """Wraps the engine's force evaluation to record, per evaluation, the
    ring's chunk count (0: no ring); returns the list it fills."""
    seen = []
    forces = eng._forces

    def counted(state, compute_stress=False):
        seen.append(eng._ring_nb)
        return forces(state, compute_stress)

    eng._forces = counted
    return seen


def md_compare_phase(spec, params, dev, seed: int, card: str):
    """NVE MD of a 3,000-atom water box: the kernel engine against an engine
    on the plain conv, from the same state, for MD_CMP_STEPS steps of MD_DT;
    positions within MD_POS_TOL, potential energy within ENERGY_REL_TOL
    relative at every step, 5 B1 + 5 B2 launches per force evaluation, at
    least one device rebuild (skin MD_CMP_SKIN), whose slots equal a host
    build; K, the nearest cut distance less the cutoff and the rebuilds per
    100 steps printed. Returns the kernel engine's launches."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine

    pos, Z, cell = water_box(1000)
    n = len(pos)
    engines = {k: MDEngine(spec, params, cell, skin=MD_CMP_SKIN, device=str(dev),
                           plain=(k == "plain")) for k in ("kernel", "plain")}
    out = {}
    for k, eng in engines.items():
        st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
        evals = record_evaluations(eng)
        reset_launches()
        t0 = time.perf_counter()
        st, (pe, ke) = eng.run(st, MD_CMP_STEPS, dt=MD_DT, chunk=MD_CMP_STEPS)
        torch.cuda.synchronize()
        out[k] = (st, pe.cpu().numpy(), ke.cpu().numpy(), read_launches(),
                  (time.perf_counter() - t0) / MD_CMP_STEPS * 1e3, len(evals))
    (st_k, pe_k, ke_k, counts, ms_k, n_evals), (st_p, pe_p, _, counts_p, ms_p, _) = (
        out["kernel"], out["plain"])
    dx = float(np.abs(unsorted(st_k, n, "positions") - unsorted(st_p, n, "positions")).max())
    de = float(np.abs(pe_k - pe_p).max() / np.abs(pe_p).max())
    want = dict(dict.fromkeys(counts, 0), fwd=5 * n_evals, bwd=5 * n_evals)
    rebuilds = engines["kernel"].n_rebuilds
    log(f"MD 3,000 atoms, {MD_CMP_STEPS} NVE steps of {MD_DT} fs, kernel vs plain conv: "
        f"max|dx|={dx:.3e} A (tol {MD_POS_TOL:g}), max rel dPE={de:.3e} (tol "
        f"{ENERGY_REL_TOL:g}), PE {pe_k[0]:.6f} -> {pe_k[-1]:.6f} eV, KE {ke_k[-1]:.4f} eV, "
        f"device rebuilds {rebuilds}, growths {engines['kernel'].n_growths}, K="
        f"{engines['kernel'].k_model}; {ms_k:.1f} ms/step kernel, {ms_p:.1f} plain (host "
        f"clock); {n_evals} force evaluations, launches {counts} | {card}")
    log(f"  skin {MD_CMP_SKIN} A: {skin_line(engines['kernel'], st_k, rebuilds, MD_CMP_STEPS)}")
    checks = ((dx <= MD_POS_TOL, f"max|dx| {dx}"), (de <= ENERGY_REL_TOL, f"rel dPE {de}"),
              (counts == want, f"launches {counts}, expected {want}"),
              (not any(counts_p.values()), f"plain engine launched {counts_p}"),
              (rebuilds > 0, "no device rebuild happened"),
              (bool(np.isfinite(pe_k).all()), "non-finite energies"))
    for ok, why in checks:
        if not ok:
            raise SystemExit(f"MD at 3,000 atoms: {why}")
    n_edges = slots_match_host(engines["kernel"], st_k)
    log(f"  the last device rebuild's {n_edges} edges equal a host build at its positions, "
        f"mirrors paired")
    return counts


def md_timed_phase(spec, params, dev, seed: int, card: str):
    """NVE MD of a 9,999-atom water box, unchunked: a warm-up chunk, then
    MD_TIMED_STEPS timed steps in chunks of MD_CHUNK (host clock around
    synchronized work): ms per step, atom-steps/s, peak memory, capacity
    growths (a growth retries its chunk, and its steps count in the time);
    exactly 5 B1 + 5 B2 per force evaluation; K, the nearest cut distance
    less the cutoff at make_state and at the last rebuild, the rebuilds per
    100 steps; then every pair within the cutoff at the final positions (a
    host list) must hold a slot. Returns the launches of the timed
    steps."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine

    pos, Z, cell = water_box(3333)
    n = len(pos)
    eng = MDEngine(spec, params, cell, device=str(dev))
    t0 = time.perf_counter()
    st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
    t_setup = time.perf_counter() - t0
    k0 = eng.k_model
    log(f"MD 9,999 atoms at make_state: {skin_line(eng, st, 0, 1)} (host build)")
    st, _ = eng.run(st, MD_WARMUP_STEPS, dt=MD_DT, chunk=MD_CHUNK)
    rebuilds, growths = eng.n_rebuilds, eng.n_growths
    evals = record_evaluations(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    st, (pe, ke) = eng.run(st, MD_TIMED_STEPS, dt=MD_DT, chunk=MD_CHUNK)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = dict(dict.fromkeys(counts, 0), fwd=5 * len(evals), bwd=5 * len(evals))
    etot = (pe + ke).cpu().numpy()
    log(f"MD 9,999 atoms (unchunked, K {k0} at make_state, {eng.k_model} timed; growths "
        f"{growths} in the {MD_WARMUP_STEPS} warm-up steps): make_state {t_setup:.1f} s; "
        f"{MD_TIMED_STEPS} timed NVE steps: {dt_s / MD_TIMED_STEPS * 1e3:.2f} ms/step, "
        f"{n * MD_TIMED_STEPS / dt_s:.4e} atom-steps/s (host clock), peak {peak:.2f} GiB, "
        f"device rebuilds {eng.n_rebuilds - rebuilds}, growths {eng.n_growths - growths}, "
        f"{len(evals)} force evaluations, E_tot drift {float(np.abs(etot - etot[0]).max()):.3e} "
        f"eV; launches {counts} | {card}")
    missing = missing_pairs(eng, st)
    log(f"  after the timed steps: {skin_line(eng, st, eng.n_rebuilds - rebuilds, MD_TIMED_STEPS)}"
        f"; pairs within the cutoff at the final positions without a slot: {missing} | {card}")
    if counts != want:
        raise SystemExit(f"MD at 9,999 atoms: launches {counts}, expected {want}")
    if not np.isfinite(etot).all():
        raise SystemExit("MD at 9,999 atoms: non-finite energies")
    if missing:
        raise SystemExit(f"MD at 9,999 atoms: {missing} pairs within the cutoff hold no slot")
    return counts


def md_ring_phase(params, dev, seed: int, card: str):
    """NVE MD of a 99,999-atom water box with full SevenNet-0 and the ring
    backward engaged in every layer (SEVENNET_TPU_CHUNK_THRESHOLD=1e9 and
    an edge chunk of 163,840 slots, as bench.py:139-141 and :349-358 run
    it; MD_RING_THRESHOLD, MD_RING_EDGE_CHUNK), against an unchunked engine (``_edge_chunk: 0``) at the same
    positions: initial forces within FORCE_TOL and FORCE_REL_TOL of max
    |F|, energy within ENERGY_REL_TOL; the peak memory of one step of each;
    then MD_RING_WARMUP + MD_RING_STEPS timed ring steps with 5 B1 + 5 nb B3
    launches per force evaluation and no B2 (nb as it stands at each
    evaluation: a capacity growth may re-size the ring). Before the
    reference engine, :func:`slot_check` (B3) at the ring's shape. Returns the
    launches of the timed steps and B3's kernels-line record."""
    import os

    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.ops.fused_conv import CHUNK_THRESHOLD_BYTES

    os.environ["SEVENNET_TPU_CHUNK_THRESHOLD"] = str(MD_RING_THRESHOLD)
    try:
        pos, Z, cell = water_box(33333)
        n = len(pos)
        ring = MDEngine(build_model_spec(dict(SEVENNET0, _edge_chunk=MD_RING_EDGE_CHUNK)),
                        params, cell, device=str(dev))
        dim_x = max(layer.conv.irreps_x.dim for layer in ring.spec.layers)
        t0 = time.perf_counter()
        reset_launches()
        st_r = ring.make_state(pos, Z, temperature=MD_T, seed=seed)
        torch.cuda.synchronize()
        t_ring = time.perf_counter() - t0
        counts = read_launches()
        RC, nb, W = ring.row_chunk, ring._ring_nb, ring._ring_w
        log(f"MD 99,999 atoms, ring: RC={RC} rows, nb={nb} chunks, W={W} (buffer of {4 * W + 1} "
            f"slots, {(4 * W + 1) * RC * ring.k_model * dim_x * 4 / 2**30:.2f} GiB at dim_x "
            f"{dim_x}), "
            f"K={ring.k_model}, atom capacity {st_r.n_atoms_cap}, host window "
            f"{ring._ring_window} rows; make_state {t_ring:.1f} s, launches {counts}")
        want = dict(dict.fromkeys(counts, 0), fwd=5, bwd_slot=5 * nb)
        if not nb or ring.spec.conv_ring != W or counts != want:
            raise SystemExit(f"the ring is not engaged at 99,999 atoms: nb={nb}, launches "
                             f"{counts}, expected {want}")
        b3 = slot_check(ring, st_r, dev, card)
        ref = MDEngine(build_model_spec(dict(SEVENNET0, _edge_chunk=0)), params, cell,
                       device=str(dev))
        t0 = time.perf_counter()
        st_u = ref.make_state(pos, Z, temperature=MD_T, seed=seed)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        f_r, f_u = unsorted(st_r, n, "forces"), unsorted(st_u, n, "forces")
        df, fmax = float(np.abs(f_r - f_u).max()), float(np.abs(f_u).max())
        e_r, e_u = float(st_r.potential_energy), float(st_u.potential_energy)
        de = abs(e_r - e_u) / abs(e_u)
        log(f"  ring vs unchunked forces at the same positions: max|dF|={df:.3e} eV/A "
            f"(max|F|={fmax:.3e}), E {e_r:.6f} vs {e_u:.6f} eV, rel dE={de:.3e}; unchunked "
            f"make_state {t_ref:.1f} s")
        for ok, why in ((df <= FORCE_TOL, f"max|dF| {df} > {FORCE_TOL}"),
                        (df <= FORCE_REL_TOL * fmax, f"max|dF| {df} > {FORCE_REL_TOL} * {fmax}"),
                        (de <= ENERGY_REL_TOL, f"rel dE {de}")):
            if not ok:
                raise SystemExit(f"MD at 99,999 atoms, ring vs unchunked: {why}")

        _, ms_u, peak_u = one_step(ref, st_u)
        gathered = st_u.n_atoms_cap * ref.k_model * dim_x * 4
        log(f"  unchunked step: {ms_u:.1f} ms (host clock, one step), peak {peak_u:.2f} GiB; "
            f"gathered edge tensor at dim_x {dim_x}: {gathered / 1e9:.2f} GB; peak / gathered = "
            f"{peak_u * 2**30 / gathered:.3f}, so a 60 GiB peak at "
            f"{60 * 2**30 / (peak_u * 2**30 / gathered) / 1e9:.1f} GB gathered (default "
            f"chunk_threshold {CHUNK_THRESHOLD_BYTES / 1e9:.1f} GB) | {card}")
        del ref, st_u
        torch.cuda.empty_cache()
        st_r, ms_r1, peak_r = one_step(ring, st_r)
        log(f"  ring step: {ms_r1:.1f} ms (host clock, one step), peak {peak_r:.2f} GiB | {card}")
        st_r, _ = ring.run(st_r, MD_RING_WARMUP, dt=MD_DT, chunk=MD_CHUNK)
        rebuilds, growths = ring.n_rebuilds, ring.n_growths
        evals = record_evaluations(ring)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        st_r, (pe, ke) = ring.run(st_r, MD_RING_STEPS, dt=MD_DT, chunk=MD_CHUNK)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        counts = read_launches()
        want = dict(dict.fromkeys(counts, 0), fwd=5 * len(evals), bwd_slot=5 * sum(evals))
        etot = (pe + ke).cpu().numpy()
        log(f"  {MD_RING_STEPS} timed ring steps: {dt_s / MD_RING_STEPS * 1e3:.1f} ms/step, "
            f"{n * MD_RING_STEPS / dt_s:.4e} atom-steps/s (host clock), device rebuilds "
            f"{ring.n_rebuilds - rebuilds}, growths {ring.n_growths - growths} (before: "
            f"{growths}), {len(evals)} force evaluations, ring chunks now {ring._ring_nb} "
            f"(W {ring._ring_w}, K {ring.k_model}), E_tot drift "
            f"{float(np.abs(etot - etot[0]).max()):.3e} eV; launches {counts} | {card}")
        if not all(evals) or counts != want:
            raise SystemExit(f"MD at 99,999 atoms: launches {counts}, expected {want}")
        if not np.isfinite(etot).all():
            raise SystemExit("MD at 99,999 atoms: non-finite energies")
        return counts, b3
    finally:
        del os.environ["SEVENNET_TPU_CHUNK_THRESHOLD"]


def one_step(eng, st):
    """One MD step alone: ``(state, host ms, peak GiB)``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, _ = eng.run(st, 1, dt=MD_DT, chunk=1)
    torch.cuda.synchronize()
    return st, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 2**30


def scatter_chunks(eng, n_cap: int) -> int:
    """Chunks of the chunked scatter backward in one force evaluation of
    ``eng`` at atom capacity ``n_cap``: each chunking layer's rows in
    chunks of ``conv_row_chunk`` rows, the last one padded."""
    from sevennet_tpu_torch.model.model import conv_row_chunk

    rcs = [conv_row_chunk(eng.spec, n_cap, eng.k_model, layer.conv.irreps_x.dim)
           for layer in eng.spec.layers]
    return sum(-(-n_cap // rc) for rc in rcs if rc)


def md_legacy_phase(params, dev, seed: int, card: str):
    """NVE MD of the 99,999-atom water box with SevenNet-0's legacy config
    (``_normalize_sph: False``: full width and depth on the emb/sh conv, as
    every checkpoint older than SevenNet 0.10 loads) and every layer
    chunked (MD_RING_THRESHOLD and MD_RING_EDGE_CHUNK, as
    :func:`md_ring_phase`). (a) The default engine: the ring stays off in
    emb/sh mode and each layer runs the chunked scatter backward, 5 B4 +
    (chunks) B4 bwd per force evaluation (:func:`scatter_chunks`), no B1,
    B2 or B3. (b) ``SEVENNET_TPU_RING=1``: the ring at W = 1 on cell-sorted
    atoms, 5 B4 + 5 nb B4-bwd-slot, after :func:`slot_check` has held the
    slot entry against its plain twin at the ring's chunk shape. Each
    engine's initial forces against an unchunked legacy engine's at the same
    positions (FORCE_TOL and FORCE_REL_TOL of max |F|, energy
    ENERGY_REL_TOL); the peak memory of one step of each engine; then
    MD_LEGACY_STEPS timed steps of (a) and (b): ms/step and atom-steps/s
    (host clock). Returns the launches of the timed steps of (a) and (b)
    and the slot entry's kernels-line record."""
    import os

    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine
    from sevennet_tpu_torch.model.build import build_model_spec

    legacy = dict(SEVENNET0, _normalize_sph=False)
    pos, Z, cell = water_box(33333)
    n = len(pos)
    initial, counts, slot = {}, {}, None
    os.environ["SEVENNET_TPU_CHUNK_THRESHOLD"] = str(MD_RING_THRESHOLD)
    try:
        for mode in ("scatter", "ring"):
            if mode == "ring":
                os.environ["SEVENNET_TPU_RING"] = "1"
            eng = MDEngine(build_model_spec(dict(legacy, _edge_chunk=MD_RING_EDGE_CHUNK)), params,
                           cell, device=str(dev))
            t0 = time.perf_counter()
            reset_launches()
            st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
            torch.cuda.synchronize()
            t_make = time.perf_counter() - t0
            got = read_launches()
            per_eval = 5 * eng._ring_nb if mode == "ring" else scatter_chunks(eng, st.n_atoms_cap)
            key = "bwd_embsh_slot" if mode == "ring" else "bwd_embsh"
            want = dict(dict.fromkeys(got, 0), fwd_embsh=5, **{key: per_eval})
            log(f"MD 99,999 atoms, legacy, {mode}: RC={eng.row_chunk or eng.spec.edge_chunk // eng.k_model} "
                f"rows, ring nb={eng._ring_nb} W={eng._ring_w}, K={eng.k_model}, atom capacity "
                f"{st.n_atoms_cap}, host window {eng._ring_window} rows; make_state {t_make:.1f} s, "
                f"launches {got}")
            if got != want or (mode == "ring") != bool(eng._ring_nb):
                raise SystemExit(f"legacy {mode} at 99,999 atoms: launches {got}, expected {want}")
            if mode == "ring":
                slot = slot_check(eng, st, dev, card)
            initial[mode] = (unsorted(st, n, "forces"), float(st.potential_energy))
            st, ms1, peak = one_step(eng, st)
            evals = []
            forces = eng._forces

            def counted(state, compute_stress=False, eng=eng, forces=forces, evals=evals,
                        ring=mode == "ring"):
                evals.append(5 * eng._ring_nb if ring else scatter_chunks(eng, state.n_atoms_cap))
                return forces(state, compute_stress)

            eng._forces = counted
            growths = eng.n_growths
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            st, (pe, ke) = eng.run(st, MD_LEGACY_STEPS, dt=MD_DT, chunk=MD_LEGACY_STEPS)
            torch.cuda.synchronize()
            dt_s = time.perf_counter() - t0
            counts[mode] = read_launches()
            want = dict(dict.fromkeys(got, 0), fwd_embsh=5 * len(evals), **{key: sum(evals)})
            etot = (pe + ke).cpu().numpy()
            log(f"  legacy {mode}: one step {ms1:.1f} ms, peak {peak:.2f} GiB; "
                f"{MD_LEGACY_STEPS} timed steps: {dt_s / MD_LEGACY_STEPS * 1e3:.1f} ms/step, "
                f"{n * MD_LEGACY_STEPS / dt_s:.4e} atom-steps/s (host clock), growths "
                f"{eng.n_growths - growths}, {len(evals)} force evaluations, E_tot drift "
                f"{float(np.abs(etot - etot[0]).max()):.3e} eV; launches {counts[mode]} | {card}")
            if counts[mode] != want or not np.isfinite(etot).all():
                raise SystemExit(f"legacy {mode} at 99,999 atoms: launches {counts[mode]}, "
                                 f"expected {want}, E_tot finite {np.isfinite(etot).all()}")
            del eng, st
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("SEVENNET_TPU_RING", None)
        del os.environ["SEVENNET_TPU_CHUNK_THRESHOLD"]
    ref = MDEngine(build_model_spec(dict(legacy, _edge_chunk=0)), params, cell, device=str(dev))
    t0 = time.perf_counter()
    st_u = ref.make_state(pos, Z, temperature=MD_T, seed=seed)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    f_u, e_u = unsorted(st_u, n, "forces"), float(st_u.potential_energy)
    fmax = float(np.abs(f_u).max())
    for mode, (f, e) in initial.items():
        df, de = float(np.abs(f - f_u).max()), abs(e - e_u) / abs(e_u)
        log(f"  legacy {mode} vs unchunked forces at the same positions: max|dF|={df:.3e} eV/A "
            f"(max|F|={fmax:.3e}), E {e:.6f} vs {e_u:.6f} eV, rel dE={de:.3e}")
        for ok, why in ((df <= FORCE_TOL, f"max|dF| {df} > {FORCE_TOL}"),
                        (df <= FORCE_REL_TOL * fmax, f"max|dF| {df} > {FORCE_REL_TOL} * {fmax}"),
                        (de <= ENERGY_REL_TOL, f"rel dE {de}")):
            if not ok:
                raise SystemExit(f"MD at 99,999 atoms, legacy {mode} vs unchunked: {why}")
    _, ms_u, peak_u = one_step(ref, st_u)
    log(f"  legacy unchunked: make_state {t_ref:.1f} s, one step {ms_u:.1f} ms (host clock), "
        f"peak {peak_u:.2f} GiB | {card}")
    return counts["scatter"], counts["ring"], slot


def ext_conv_check(spec, spec_legacy, params, dev, atoms, card: str):
    """The ext conv (``fused_conv_apply_ext_vec`` and ``fused_conv_apply_ext``:
    senders index an extended set of owned and ghost rows, the chunked
    scatter backward) at SevenNet-0's layer-1 shape on the box's edges, in
    both modes: ``x_ext`` EXT_GHOST larger than the receivers, a third of
    the senders moved onto ghost rows, three row chunks; the output and the
    gradients of ``x_ext`` (ghost rows included), the edge inputs and the
    MLP weights against the plain versions on the same inputs, within
    REL_TOL of max |plain|."""
    import torch

    from sevennet_tpu_torch.model.model import edge_emb_sh, edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    calc, g, vec, src, coef = box_edges(spec, params, dev, atoms)
    N, K = src.shape
    n_ext = int(N * (1 + EXT_GHOST))
    src_ext = torch.where(src % 3 == 0, N + src % (n_ext - N), src).long()
    layer = spec.layers[1]
    ws = calc.params["1_convolution"]["weight_nn"]["w"]
    gen = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn(n_ext, layer.conv.irreps_x.dim, generator=gen).to(dev)
    ybar = torch.randn(N, layer.conv.irreps_mid.dim, generator=gen).to(dev)
    emb, sh = edge_emb_sh(spec_legacy, coef, vec, g.edge_mask)
    for mode, edge in (("vec", (vec,)), ("emb/sh", (emb.view(N, K, -1), sh.view(N, K, -1)))):
        outs = {}
        for plain in (False, True):
            xs = x.clone().requires_grad_(True)
            es = [e.detach().clone().requires_grad_(True) for e in edge]
            wl = [w.detach().clone().requires_grad_(True) for w in ws]
            if mode == "vec":
                out = fc.fused_conv_apply_ext_vec(layer.conv, layer.radial_mlp, wl, coef,
                                                  edge_embed_spec(spec, layer), xs, es[0],
                                                  src_ext, plain=plain, row_chunk=-(-N // 3))
            else:
                out = fc.fused_conv_apply_ext(layer.conv, layer.radial_mlp, wl, xs, *es, src_ext,
                                              plain=plain, row_chunk=-(-N // 3))
            outs[plain] = [out.detach(), *torch.autograd.grad(out, (xs, *es, *wl), ybar)]
        names = ["out", "dx_ext"] + (["dvec"] if mode == "vec" else ["demb", "dsh"]) + [
            f"dW{i}" for i in range(len(ws))]
        err = max(check_close(f"ext conv {mode}", nm, a, b)
                  for nm, a, b in zip(names, outs[False], outs[True]))
        log(f"  ext conv {mode} at layer 1 (N {N}, x_ext {n_ext} rows, 3 chunks): max abs err "
            f"{err:.3e}, each within {REL_TOL:g} of max |plain| | {card}")
        del outs
    torch.cuda.empty_cache()


def threshold_probe(params, dev, seed: int, card: str):
    """``--threshold-probe``: the measurements ``CHUNK_THRESHOLD_BYTES``
    rests on. One unchunked SevenNet-0 MD step (``_edge_chunk: 0``) of
    THRESHOLD_MOLECULES water molecules (near 200k atoms): its peak memory
    per byte of the largest layer's gathered edge tensor ``N * K * dim_x *
    4``; and the calculator's peak per gathered byte at 99,999 atoms with
    SevenNet-0 (vec mode) and its legacy config (emb/sh mode), the second
    of two requests."""
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.md import MDEngine
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.ops.fused_conv import chunk_threshold

    spec = build_model_spec(dict(SEVENNET0, _edge_chunk=0))
    dim_x = max(layer.conv.irreps_x.dim for layer in spec.layers)
    pos, Z, cell = water_box(THRESHOLD_MOLECULES)
    eng = MDEngine(spec, params, cell, device=str(dev))
    t0 = time.perf_counter()
    st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    st, ms, peak = one_step(eng, st)
    gathered = st.n_atoms_cap * eng.k_model * dim_x * 4
    log(f"threshold probe: unchunked MD step of {len(pos)} atoms (K {eng.k_model}, capacity "
        f"{st.n_atoms_cap}): make_state {t_make:.1f} s, one step {ms:.1f} ms (host clock), peak "
        f"{peak:.2f} GiB; gathered edge tensor at dim_x {dim_x}: {gathered / 1e9:.3f} GB; peak / "
        f"gathered = {peak * 2**30 / gathered:.4f} (chunk_threshold now "
        f"{chunk_threshold() / 1e9:.1f} GB) | {card}")
    del eng, st
    torch.cuda.empty_cache()
    pos, Z, cell = water_box(33333)
    at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    for label, cfg in (("vec", SEVENNET0), ("legacy", dict(SEVENNET0, _normalize_sph=False))):
        calc = SevenNetCalculator(build_model_spec(cfg), params, device=str(dev))
        calc.calculate(at)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        calc.calculate(at)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        g = calc.graph(at)
        gathered = g.n_atoms_cap * g.dense_k * dim_x * 4
        log(f"threshold probe: calculator, {label}, {len(pos)} atoms (K {g.dense_k}): request "
            f"{ms:.1f} ms (host clock), peak {peak:.2f} GiB; gathered {gathered / 1e9:.3f} GB; "
            f"peak / gathered = {peak * 2**30 / gathered:.4f} | {card}")
        del calc
        torch.cuda.empty_cache()


def box_edges(spec, params, dev, atoms):
    """The box's dense graph as the kernels take it: ``(calc, graph, vec,
    src, coef)``, vec with the sentinel on padded slots."""
    import torch

    from sevennet_tpu_torch.calculator import SevenNetCalculator

    calc = SevenNetCalculator(spec, params, device=str(dev))
    g = calc.graph(atoms)
    N, K = g.n_atoms_cap, g.dense_k
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=dev)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel[:, None]).contiguous()
    src = g.edge_src.view(N, K).to(torch.int32).contiguous()
    coef = calc.params["edge_embedding"]["bessel_coeffs"]
    return calc, g, vec, src, coef


def l3i5_kernel_phase(spec, params, dev, atoms):
    """B1, B2 and B2' (records pass and reduction) at SevenNet-l3i5's widths
    (layer 0, layers 1-3, layer 4) on the box, each against its plain
    version (REL_TOL of max |plain|), timed with CUDA events, and the
    reduction alone (``reduce_check``: against plain, twice bitwise, beside
    torch.mm); prints each layer shape's column blocks of w and its
    shared-memory carve. Returns per-kernel records (times summed over one
    pass: layer 0 + 3 x layers 1-3 + layer 4)."""
    import torch

    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    calc, g, vec, src, coef = box_edges(spec, params, dev, atoms)
    N, K, n_edges = g.n_atoms_cap, g.dense_k, int(g.edge_mask.sum())
    log(f"l3i5 kernel shapes: N={N} K={K} real edges={n_edges}")
    gen = torch.Generator(device="cpu").manual_seed(5)
    recs = {k: dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, tc_flops=0.0, err=0.0)
            for k in ("fwd", "bwd", "bwd_pg")}
    recs["reduce"] = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    for tag, t, n_layers in SHAPES:
        layer = spec.layers[t]
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        d = op.dims(N, K)
        log(f"  l3i5 {tag}: w's {op.numel} columns in {len(op.plan.blocks)} blocks of "
            f"{list(op.plan.widths)} columns; carve at K={K} (bytes, W3 stages): forward "
            f"{fc.carve_bytes(d, False)}, backward {fc.carve_bytes(d, True)}, limit "
            f"{fc.SMEM_LIMIT}")
        ws = calc.params[f"{t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, op.dim_x, generator=gen).to(dev)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
        args = (op, x, src, vec, coef, ws)
        errs = {"fwd": check_close(f"l3i5 {tag}", "fwd", fc.fused_conv_fwd(*args),
                                   fc.fused_conv_fwd_plain(*args))}
        got, want = fc.fused_conv_bwd(*args, ybar), fc.fused_conv_bwd_plain(*args, ybar)
        errs["bwd"] = max(check_close(f"l3i5 {tag}", n, a, b)
                          for n, a, b in zip(("dxg", "dvec"), got, want))
        del got, want
        got = fc.fused_conv_bwd(*args, ybar, param_grads=True)
        want = fc.fused_conv_bwd_plain(*args, ybar, param_grads=True)
        pairs = [("pg dxg", got[0], want[0]), ("pg dvec", got[1], want[1]),
                 ("dcoef", got[3], want[3])]
        pairs += [(f"dW{i + 1}", a, b) for i, (a, b) in enumerate(zip(got[2], want[2]))]
        errs["bwd_pg"] = max(check_close(f"l3i5 {tag}", n, a, b) for n, a, b in pairs)
        del got, want, pairs
        _, _, work_, valid = fc.fused_conv_bwd_pg_records(*args, ybar)
        red = reduce_check(f"l3i5 {tag}", op, work_, valid, N, K, reps=5)
        for key, v in zip(("ms", "plain_ms", "library_ms"), red):
            recs["reduce"][key] += n_layers * v
        del work_, valid
        times = {
            "fwd": (cuda_time(lambda: fc.fused_conv_fwd(*args), 5),
                    cuda_time(lambda: fc.fused_conv_fwd_plain(*args), 2)),
            "bwd": (cuda_time(lambda: fc.fused_conv_bwd(*args, ybar), 5),
                    cuda_time(lambda: fc.fused_conv_bwd_plain(*args, ybar), 2)),
            "bwd_pg": (cuda_time(lambda: fc.fused_conv_bwd(*args, ybar, param_grads=True), 5),
                       cuda_time(lambda: fc.fused_conv_bwd_plain(*args, ybar, param_grads=True),
                                 2)),
        }
        for k, (tk, tp) in times.items():
            fl, by, tc = work(op, N, K, n_edges, k)
            log(f"  l3i5 {tag} {k}: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound "
                f"{bound_ms(fl, by, tc)[0]:.4f} ms (fp32 {bound_ms(fl, by)[0]:.4f} ms; "
                f"{fl / 1e9:.2f} GFLOP), {fl / tk / 1e9:.2f} TFLOP/s")
            for key, v in (("ms", tk), ("plain_ms", tp), ("flops", fl), ("bytes", by),
                           ("tc_flops", tc)):
                recs[k][key] += n_layers * v
            recs[k]["err"] = max(recs[k]["err"], errs[k])
        del x, ybar, args
        torch.cuda.empty_cache()
    r = recs["reduce"]
    log(f"  l3i5 reduce per pass: kernel {r['ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms")
    return recs


MF_RING_ROWS = 16  # rows of the ring chunk on which B3 is held at mf-ompa's layer 3


def _flat(outs):
    """The tensors of a kernel's outputs (nested tuples and lists)."""
    import torch

    if torch.is_tensor(outs):
        return [outs]
    return [t for o in outs for t in _flat(o)]


def bitwise_twice(tag, name, fn):
    """Two launches of ``fn`` give bitwise-equal outputs (the kernels sum in
    a fixed order); raises SystemExit otherwise."""
    import torch

    a, b = _flat(fn()), _flat(fn())
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"  {tag} {name} twice: {'bitwise equal' if same else 'DIFFER'} ({len(a)} outputs)")
    if not same:
        raise SystemExit(f"{name}: two launches differ at {tag}")


def mf_cluster_entries(tag, op, layer, x, src, vec, coef, ws, ybar, valid, dev):
    """At a cluster layer: B4 fwd and B4 bwd on the edges' embedding and
    spherical harmonics, and B3 (B2 into a slot of the ring's buffer) on
    the MF_RING_ROWS rows from row MF_RING_ROWS, against plain (REL_TOL of
    max |plain|; the buffer's other slots untouched); each timed with CUDA
    events (kernel 3 launches, plain 1) beside its bound (``work``: B4's
    over every slot of the box, B3's over the chunk's edges inside the
    cutoff, ``valid``)."""
    import torch

    from sevennet_tpu_torch.ops import fused_conv as fc

    card = gpu_line()
    N, K = src.shape
    n_edges = int(valid.sum())

    def timed(name, kind, fn, plain, n, edges):
        tk, tp = cuda_time(fn, 3), cuda_time(plain, 1)
        fl, by, tc = work(op_e if "embsh" in kind else op, n, K, edges, kind)
        bnd = bound_ms(fl, by, tc)[0]
        log(f"  {tag} {name}: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound {bnd:.4f} ms "
            f"({tk / bnd:.1f}x; fp32 {bound_ms(fl, by)[0]:.4f} ms) | {card}")

    op_e = fc.conv_op(layer.conv, layer.radial_mlp)
    assert op_e.plan.cluster == op.plan.cluster
    emb, sh = (t_.contiguous() for t_ in fc.edge_embedding_plain(op, vec, coef))
    e = (op_e, x, src, emb, sh, ws)
    check_close(tag, "B4 fwd", fc.fused_conv_fwd_embsh(*e), fc.fused_conv_fwd_embsh_plain(*e))
    for name, a, b in zip(("B4 bwd dxg", "B4 bwd demb", "B4 bwd dsh"),
                          fc.fused_conv_bwd_embsh(*e, ybar), fc.fused_conv_bwd_embsh_plain(*e, ybar)):
        check_close(tag, name, a, b)
    timed("B4 fwd", "fwd_embsh", lambda: fc.fused_conv_fwd_embsh(*e),
          lambda: fc.fused_conv_fwd_embsh_plain(*e), N, n_edges)
    timed("B4 bwd", "bwd_embsh", lambda: fc.fused_conv_bwd_embsh(*e, ybar),
          lambda: fc.fused_conv_bwd_embsh_plain(*e, ybar), N, n_edges)
    del emb, sh, e
    RC = MF_RING_ROWS
    src_c = src[RC:2 * RC].contiguous()
    vec_c = vec.view(3, -1, K)[:, RC:2 * RC].reshape(3, RC * K).contiguous()
    buf = torch.full((3 * RC * K, op.dim_x), -7.25, device=dev)
    buf_p = buf.clone()
    dv = fc.fused_conv_bwd_slot(op, x, src_c, vec_c, coef, ws, ybar[RC:2 * RC].contiguous(),
                                buf, 1)
    dv_p = fc.fused_conv_bwd_slot_plain(op, x, src_c, vec_c, coef, ws,
                                        ybar[RC:2 * RC].contiguous(), buf_p, 1)
    check_close(tag, f"B3 on a {RC}-row ring chunk, dvec", dv, dv_p)
    check_close(tag, f"B3 on a {RC}-row ring chunk, its slot", buf[RC * K:2 * RC * K],
                buf_p[RC * K:2 * RC * K])
    if not (torch.equal(buf[:RC * K], buf_p[:RC * K]) and torch.equal(buf[2 * RC * K:],
                                                                      buf_p[2 * RC * K:])):
        raise SystemExit(f"B3 wrote outside its slot at {tag}")
    yb_c = ybar[RC:2 * RC].contiguous()
    timed(f"B3 on a {RC}-row ring chunk", "bwd",
          lambda: fc.fused_conv_bwd_slot(op, x, src_c, vec_c, coef, ws, yb_c, buf, 1),
          lambda: fc.fused_conv_bwd_slot_plain(op, x, src_c, vec_c, coef, ws, yb_c, buf_p, 1),
          RC, int(valid[RC:2 * RC].sum()))


def wide4_check(dev, seed: int):
    """The cluster of 4 CTAs a receiver row, which no published model's layer
    needs: ``WIDE4_LAYER``'s second layer (mf-ompa's parity irreps at twice
    the channels, x of 2,560 columns) on the 192-atom water box. B1, B2 and
    B2' against plain (REL_TOL of max |plain|, as at mf-ompa's 2-CTA
    layers), B2 and B2' twice bitwise, then B4 fwd, B4 bwd and B3 on a ring
    chunk (:func:`mf_cluster_entries`, each also timed); one forward and one
    backward launch timed with CUDA events beside the bound. Launches are
    not counted (no main path runs the layer)."""
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.model.presets import WIDE4_LAYER
    from sevennet_tpu_torch.ops import fused_conv as fc

    card = gpu_line()
    spec = build_model_spec(dict(WIDE4_LAYER, chemical_species=["H", "O"],
                                 conv_denominator=MF_DENOMINATOR))
    params = params_from_numpy(spec, random_params(spec, seed))
    pos, Z, cell = water_box(MF_SIZES[0] // 3)
    calc, g, vec, src, coef = box_edges(spec, params, dev, AtomsLite(
        positions=pos, numbers=Z, cell=cell, pbc=True))
    layer = spec.layers[1]
    op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
    plan = op.plan
    N, K, n_edges = g.n_atoms_cap, g.dense_k, int(g.edge_mask.sum())
    d = op.dims(N, K)
    log(f"  wide4 layer 1: x {op.dim_x}, mid {op.dim_mid}, w {op.numel} columns; a cluster of "
        f"{plan.cluster} CTAs a receiver row, ranks of x irreps "
        f"{[list(r.xi) for r in plan.ranks]}, {[r.xw for r in plan.ranks]} x columns, "
        f"{list(plan.rank_blocks)} blocks of {list(plan.widths)} columns; carve per CTA at "
        f"K={K}: forward {op.carve(d, False)}, backward {op.carve(d, True)}, limit "
        f"{fc.SMEM_LIMIT}")
    if plan.cluster != 4:
        raise SystemExit(f"WIDE4_LAYER's layer 1 plans {plan.cluster} CTAs, not 4")
    gen = torch.Generator(device="cpu").manual_seed(seed + 4)
    ws = calc.params["1_convolution"]["weight_nn"]["w"]
    x = torch.randn(N, op.dim_x, generator=gen).to(dev)
    ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
    args = (op, x, src, vec, coef, ws)
    tag = f"wide4 layer 1 ({MF_SIZES[0]} atoms, 4 CTAs)"
    check_close(tag, "B1 fwd", fc.fused_conv_fwd(*args), fc.fused_conv_fwd_plain(*args))
    for name, a, b in zip(("B2 dxg", "B2 dvec"), fc.fused_conv_bwd(*args, ybar),
                          fc.fused_conv_bwd_plain(*args, ybar)):
        check_close(tag, name, a, b)
    got = fc.fused_conv_bwd(*args, ybar, param_grads=True)
    want = fc.fused_conv_bwd_plain(*args, ybar, param_grads=True)
    pairs = [("B2' dxg", got[0], want[0]), ("B2' dvec", got[1], want[1])]
    pairs += [(f"B2' dW{i + 1}", a, b) for i, (a, b) in enumerate(zip(got[2], want[2]))]
    pairs += [("B2' dcoef", got[3], want[3])]
    for name, a, b in pairs:
        check_close(tag, name, a, b)
    del got, want, pairs
    bitwise_twice(tag, "B2", lambda: fc.fused_conv_bwd(*args, ybar))
    bitwise_twice(tag, "B2'", lambda: fc.fused_conv_bwd(*args, ybar, param_grads=True))
    mf_cluster_entries(tag, op, layer, x, src, vec, coef, ws, ybar, g.edge_mask.view(N, K), dev)
    for kind, fn in (("fwd", lambda: fc.fused_conv_fwd(*args)),
                     ("bwd", lambda: fc.fused_conv_bwd(*args, ybar))):
        ms = cuda_time(fn, 3)
        fl, by, tc = work(op, N, K, n_edges, kind)
        bnd = bound_ms(fl, by, tc)[0]
        log(f"  {tag} {'B1' if kind == 'fwd' else 'B2'}: kernel {ms:.4f} ms, bound {bnd:.4f} ms "
            f"({ms / bnd:.1f}x; fp32 {bound_ms(fl, by)[0]:.4f} ms) | {card}")
    del x, ybar, args
    torch.cuda.empty_cache()


def mf_ompa_kernel_phase(spec, params, dev):
    """B1, B2, B2' (both passes) and the B2' reduction alone at each of
    SevenNet-MF-ompa's five layer shapes: against their plain versions
    (REL_TOL of max |plain|; the reduction also twice bitwise and against a
    float64 sum, :func:`reduce_check`) on the 192-atom water box, B2 and B2'
    also launched twice and held bitwise equal, timed with CUDA events
    there (kernel and plain; the reduction beside one torch.mm per weight
    matrix) and on the 3,000-atom box (kernel, and the reduction's library
    call); at layer 3 (a cluster) also B4 fwd and B4 bwd on the box's
    embedding and spherical harmonics and B3 on a ring chunk of
    MF_RING_ROWS rows, against plain. Prints each layer's CTAs a receiver
    row (a cluster's ranks), column blocks and carve per CTA. Returns
    per-kernel records summed over the five layers (one request's or one
    force pass's launches): at the 192-atom box ``ms``, ``plain_ms``,
    ``library_ms`` and the work, at the 3,000-atom box ``ms_big``,
    ``library_ms_big`` and its work."""
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    boxes = {}
    for n in MF_SIZES:
        pos, Z, cell = water_box(n // 3)
        boxes[n] = box_edges(spec, params, dev, AtomsLite(positions=pos, numbers=Z, cell=cell,
                                                          pbc=True))
    gen = torch.Generator(device="cpu").manual_seed(11)
    recs = {k: dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, tc_flops=0.0, err=0.0,
                    ms_big=0.0, flops_big=0.0, bytes_big=0.0, tc_flops_big=0.0,
                    library_ms=0.0, library_ms_big=0.0)
            for k in ("fwd", "bwd", "bwd_pg", "reduce")}
    for t, layer in enumerate(spec.layers):
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        plan = op.plan
        for n in MF_SIZES:
            calc, g, vec, src, coef = boxes[n]
            N, K, n_edges = g.n_atoms_cap, g.dense_k, int(g.edge_mask.sum())
            d = op.dims(N, K)
            if n == MF_SIZES[0]:
                ranks = (f"a cluster of {plan.cluster} CTAs a receiver row, ranks of x irreps "
                         f"{[list(r.xi) for r in plan.ranks]}, {[r.xw for r in plan.ranks]} x "
                         f"columns, {[r.mw for r in plan.ranks]} output columns, "
                         f"{list(plan.rank_blocks)} blocks" if plan.cluster > 1
                         else f"1 CTA a receiver row, {len(plan.blocks)} blocks")
                log(f"  mf-ompa layer {t}: x {op.dim_x}, mid {op.dim_mid}, w {op.numel} columns; "
                    f"{ranks} of {list(plan.widths)} columns; carve per CTA at K={K} (bytes, W3 "
                    f"stages): forward {op.carve(d, False)}, backward {op.carve(d, True)}, limit "
                    f"{fc.SMEM_LIMIT}")
            ws = calc.params[f"{t}_convolution"]["weight_nn"]["w"]
            x = torch.randn(N, op.dim_x, generator=gen).to(dev)
            ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
            args = (op, x, src, vec, coef, ws)
            tag = f"mf-ompa layer {t} ({n} atoms)"
            times = {"fwd": cuda_time(lambda: fc.fused_conv_fwd(*args), 3),
                     "bwd": cuda_time(lambda: fc.fused_conv_bwd(*args, ybar), 3),
                     "bwd_pg": cuda_time(lambda: fc.fused_conv_bwd(*args, ybar,
                                                                   param_grads=True), 3)}
            _, _, work_, valid = fc.fused_conv_bwd_pg_records(*args, ybar)
            plain, lib = {}, {}
            if n <= MF_PLAIN_MAX_ATOMS:
                errs = {"fwd": check_close(tag, "fwd", fc.fused_conv_fwd(*args),
                                           fc.fused_conv_fwd_plain(*args))}
                got, want = fc.fused_conv_bwd(*args, ybar), fc.fused_conv_bwd_plain(*args, ybar)
                errs["bwd"] = max(check_close(tag, name, a, b)
                                  for name, a, b in zip(("dxg", "dvec"), got, want))
                got = fc.fused_conv_bwd(*args, ybar, param_grads=True)
                want = fc.fused_conv_bwd_plain(*args, ybar, param_grads=True)
                pairs = [("pg dxg", got[0], want[0]), ("pg dvec", got[1], want[1])]
                pairs += [(f"dW{i + 1}", a, b) for i, (a, b) in enumerate(zip(got[2], want[2]))]
                pairs += [("dcoef", got[3], want[3])]
                errs["bwd_pg"] = max(check_close(tag, name, a, b) for name, a, b in pairs)
                del got, want
                bitwise_twice(tag, "B2", lambda: fc.fused_conv_bwd(*args, ybar))
                bitwise_twice(tag, "B2'", lambda: fc.fused_conv_bwd(*args, ybar,
                                                                   param_grads=True))
                if plan.cluster > 1 and t == 3:
                    mf_cluster_entries(tag, op, layer, x, src, vec, coef, ws, ybar,
                                       g.edge_mask.view(N, K), dev)
                red_ms, red_plain, lib["reduce"], errs["reduce"] = reduce_check(
                    tag, op, work_, valid, N, K, reps=3)
                times["reduce"] = red_ms
                plain = {"fwd": cuda_time(lambda: fc.fused_conv_fwd_plain(*args), 2),
                         "bwd": cuda_time(lambda: fc.fused_conv_bwd_plain(*args, ybar), 2),
                         "bwd_pg": cuda_time(lambda: fc.fused_conv_bwd_plain(
                             *args, ybar, param_grads=True), 2),
                         "reduce": red_plain}
            else:
                times["reduce"] = cuda_time(lambda: fc.param_grad_reduce(op, work_, valid, N, K),
                                            3)
                rows = work_[valid.bool()]
                mats = [(rows[:, a:a + da], rows[:, b:b + db])
                        for a, da, b, db in op.reduce_products if a >= 0]
                lib["reduce"] = cuda_time(lambda: [torch.mm(m_a.t(), m_b) for m_a, m_b in mats],
                                          3)
                del rows, mats
            del work_, valid
            for k, tk in times.items():
                fl, by, tc = work(op, N, K, n_edges, k)
                bnd = bound_ms(fl, by, tc)[0]
                line = (f"  {tag} {k}: kernel {tk:.4f} ms, bound {bnd:.4f} ms "
                        f"({tk / bnd:.1f}x; fp32 {bound_ms(fl, by)[0]:.4f} ms), "
                        f"{fl / tk / 1e9:.2f} TFLOP/s")
                r = recs[k]
                if k in lib:
                    line += f", library (torch.mm per weight matrix) {lib[k]:.4f} ms"
                if k in plain:
                    line += f", plain {plain[k]:.4f} ms"
                    for key, v in (("ms", tk), ("plain_ms", plain[k]), ("flops", fl),
                                   ("bytes", by), ("tc_flops", tc),
                                   ("library_ms", lib.get(k, 0.0))):
                        r[key] += v
                    r["err"] = max(r["err"], errs[k])
                else:
                    for key, v in (("ms_big", tk), ("flops_big", fl), ("bytes_big", by),
                                   ("tc_flops_big", tc), ("library_ms_big", lib.get(k, 0.0))):
                        r[key] += v
                log(line)
            del x, ybar, args
            torch.cuda.empty_cache()
    for k, r in recs.items():
        libs = (f", library {r['library_ms']:.4f} / {r['library_ms_big']:.4f} ms"
                if k == "reduce" else "")
        log(f"  mf-ompa {k} per pass of the five layers: {r['ms']:.4f} ms at {MF_SIZES[0]} atoms "
            f"(plain {r['plain_ms']:.4f} ms, bound "
            f"{bound_ms(r['flops'], r['bytes'], r['tc_flops'])[0]:.4f} ms), {r['ms_big']:.4f} ms "
            f"at {MF_SIZES[1]} atoms (bound "
            f"{bound_ms(r['flops_big'], r['bytes_big'], r['tc_flops_big'])[0]:.4f} ms){libs}")
    return recs


def mf_ompa_phase(dev, seed: int):
    """SevenNet-MF-ompa on the card: the layer shapes' kernel checks
    (:func:`mf_ompa_kernel_phase`), then requests of MF_SIZES atoms with
    each modality pinned by ``select_modality`` (:func:`request_phase`,
    held against the plain-conv model up to MF_PLAIN_MAX_ATOMS atoms). The
    two modalities' energies must differ. Returns ``(records, launches)``,
    the launches over the requests."""
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.model.presets import MF_OMPA
    from sevennet_tpu_torch.scripts.modal_tools import select_modality

    # the reference sets the conv denominator to the training set's average
    # neighbour count (avg_num_neigh), which the checkpoint carries; the
    # preset leaves it at 1.0. The water box's at 6 A is 81 (K 82).
    cfg = dict(MF_OMPA, chemical_species=["H", "O"], conv_denominator=MF_DENOMINATOR)
    spec = build_model_spec(cfg)
    params = params_from_numpy(spec, random_params(spec, seed))
    t0 = time.perf_counter()
    records = mf_ompa_kernel_phase(spec, params, dev)
    log(f"mf-ompa kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide4_check(dev, seed)
    log(f"wide4 (4-CTA cluster) check: {time.perf_counter() - t0:.1f} s")
    launches, energies = None, {}
    for modal in MF_MODALITIES:
        cfg_m, params_m = select_modality(cfg, params, modal)
        energies[modal] = {}
        got = request_phase(build_model_spec(cfg_m), params_m, dev, f"mf-ompa {modal}", "fwd",
                            "bwd", sizes=MF_SIZES, plain_max=MF_PLAIN_MAX_ATOMS,
                            energies=energies[modal])
        launches = got if launches is None else {k: v + got[k] for k, v in launches.items()}
    for n in MF_SIZES:
        e = [energies[m][n] for m in MF_MODALITIES]
        log(f"  mf-ompa {n} atoms: E {dict(zip(MF_MODALITIES, e))} eV")
        if abs(e[0] - e[1]) <= 1e-6 * max(abs(e[0]), 1.0):
            raise SystemExit(f"mf-ompa {n} atoms: the modalities give the same energy {e}")
    return records, launches


def mf_training_set(cfg, teacher, dev, seed: int, tmp: str):
    """MF_TRAIN_BOXES water boxes of 192 atoms per modality, jittered from
    ``seed``, labelled (energy, forces, stress) by ``teacher`` with that
    modality pinned; one extxyz per modality under ``tmp``. Returns the
    multi-modal data entries (the reference's multi_modal.yaml format)."""
    import os

    import numpy as np

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.data.extxyz import write_extxyz
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.scripts.modal_tools import select_modality

    entries = []
    for m, modal in enumerate(MF_MODALITIES):
        cfg_m, params_m = select_modality(cfg, teacher, modal)
        calc = SevenNetCalculator(build_model_spec(cfg_m), params_m, device=str(dev))
        rng = np.random.default_rng(seed + 100 * m)
        frames = []
        for i in range(MF_TRAIN_BOXES):
            pos, Z, cell = water_box(64, seed=seed * 1000 + 500 + 10 * m + i)
            pos = pos + rng.normal(scale=0.05, size=pos.shape)
            r = calc.calculate(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
            label = -np.asarray(r["stress"])[[0, 1, 2, 5, 3, 4]]
            frames.append(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True,
                                    energy=r["energy"], forces=r["forces"], stress=label))
        path = os.path.join(tmp, f"{modal}.extxyz")
        write_extxyz(path, frames)
        entries.append({"data_modality": modal, "file_list": [{"file": path}]})
    return entries


def mf_train_phase(dev, seed: int, card: str):
    """SevenNet-MF-ompa training on the card, both modalities in one set: the
    kernel path against the plain path for TRAIN_CMP_STEPS steps on batches
    that mix the modalities (5 B1 + 10 B2' + 10 reductions a step), the
    step's time, structures/s and peak memory, then MF_TRAIN_EPOCHS epoch
    through ``train_run`` on the two-modality config with a modal-wise shift
    (the main path), the checkpoint reloaded and one 192-atom request per
    modality served from it (5 B1 + 5 B2 each), against the trained model.
    Returns the launches of ``train_run`` and the requests."""
    import os

    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.data.modal_dataset import MultiModalDataset
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.io.native_checkpoint import load_checkpoint
    from sevennet_tpu_torch.logger import Logger
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.model.presets import MF_OMPA
    from sevennet_tpu_torch.scripts.modal_tools import select_modality
    from sevennet_tpu_torch.scripts.train import dense_capacity, resolve_statistics, train_run
    from sevennet_tpu_torch.train import LossConfig, Trainer, TrainerConfig
    from sevennet_tpu_torch.train.trainer import tree_map

    base = dict(MF_OMPA, chemical_species=["H", "O"], conv_denominator=MF_DENOMINATOR)
    spec_t = build_model_spec(base)
    teacher = params_from_numpy(spec_t, random_params(spec_t, seed + 1))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mf_train_") as tmp:
        entries = mf_training_set(base, teacher, dev, seed, tmp)
        del teacher
        model_cfg = dict(base, shift="per_atom_energy_mean", scale="force_rms")
        train_cfg = {"epoch": MF_TRAIN_EPOCHS, "optimizer": "adam",
                     "optim_param": {"lr": TRAIN_LR}, "force_loss_weight": 0.1,
                     "stress_loss_weight": 1e-6, "per_epoch": 1, "random_seed": seed}
        data_cfg = {"batch_size": MF_TRAIN_BATCH, "load_trainset_path": entries, "ratio": 0.25}

        # the compared steps: the whole set, statistics, weights from the seed
        trainset = MultiModalDataset.from_config(entries, base["cutoff"], base["modal_map"])
        cfg = dict(model_cfg)
        resolve_statistics(cfg, data_cfg, trainset, Logger(None, screen=False))
        spec = build_model_spec(cfg)
        params = params_from_numpy(spec, random_params(spec, seed))
        trainset.build(spec.z_to_type)
        K = dense_capacity(trainset.max_neighbors())
        batches = [b.to(dev) for b in
                   trainset.batches(MF_TRAIN_BATCH, shuffle=True, seed=1, dense_k=K)]
        mixed = [sorted(set(b.modal[b.graph_mask].tolist())) for b in batches]
        log(f"mf-ompa training: {len(trainset)} structures of 192 atoms ({MF_TRAIN_BOXES} per "
            f"modality), batch {MF_TRAIN_BATCH}, K={K}, batch capacity "
            f"{batches[0].n_atoms_cap} atoms, {int(batches[0].edge_mask.sum())} edges, "
            f"modal-wise shift {cfg['shift']}, modalities per batch {mixed}")
        if all(len(m) < 2 for m in mixed):
            raise SystemExit("mf-ompa training: no batch mixes the modalities")
        tcfg = TrainerConfig(loss=LossConfig(force_weight=0.1, stress_weight=1e-6),
                             optimizer="adam", lr=TRAIN_LR)
        kern = Trainer(spec, params, tcfg, device=str(dev))
        plain = Trainer(spec, params, tcfg, device=str(dev), plain=True)
        kern.set_epoch(0)
        n_layers = len(spec.layers)
        want = dict(dict.fromkeys(counters(), 0), fwd=n_layers, bwd_pg=2 * n_layers,
                    reduce=2 * n_layers)
        compare_steps("mf-ompa", kern, plain, batches, want, card)
        b = batches[0]
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_median(lambda: kern.train_step(b), 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_median(lambda: plain.train_step(b), 1)
        peak_plain = torch.cuda.max_memory_allocated() / 2**30
        n_struct = int(b.graph_mask.sum())
        log(f"  mf-ompa train step ({n_struct} x 192 atoms, K={K}): median {step_ms:.2f} ms (3 "
            f"runs, CUDA events), {n_struct / step_ms * 1e3:.2f} structures/s, peak {peak:.2f} "
            f"GiB; plain path {plain_ms:.2f} ms (one run), peak {peak_plain:.2f} GiB | {card}")
        del kern, plain, batches, trainset
        torch.cuda.empty_cache()

        # the main path: train_run on the two-modality config, counts from 0
        wd = os.path.join(tmp, "run")
        tr, va = MultiModalDataset.from_config(entries, base["cutoff"]).split(0.25)
        n_train = MF_TRAIN_EPOCHS * -(-len(tr) // MF_TRAIN_BATCH)
        n_eval = MF_TRAIN_EPOCHS * -(-len(va) // MF_TRAIN_BATCH)
        reset_launches()
        t0 = time.perf_counter()
        trainer = train_run(dict(model_cfg), dict(train_cfg), dict(data_cfg), working_dir=wd,
                            device=str(dev))
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = read_launches()
        want = dict(dict.fromkeys(counters(), 0), fwd=n_layers * (n_train + n_eval),
                    bwd=n_layers * n_eval, bwd_pg=2 * n_layers * n_train,
                    reduce=2 * n_layers * n_train)
        log(f"mf-ompa train_run: {len(tr)} train / {len(va)} valid structures, {n_train} train "
            f"steps, {n_eval} eval steps in {t_run:.1f} s (host clock, set-up included), "
            f"launches {counts}")
        if counts != want:
            raise SystemExit(f"mf-ompa train_run launches {counts}, expected {want}")

        # serve each modality from the reloaded checkpoint (main path), then
        # the trained model itself with the modality pinned (reference)
        spec_ck, params_ck, meta = load_checkpoint(os.path.join(wd, "checkpoint_last"))
        cfg_ck = meta["model_config"]
        if cfg_ck.get("modal_map") != base["modal_map"] or len(cfg_ck["shift"]) != 2:
            raise SystemExit(f"mf-ompa checkpoint lost its modal map or modal-wise shift: "
                             f"{cfg_ck.get('modal_map')}, {cfg_ck.get('shift')}")
        pos, Z, cell = water_box(64, seed=seed * 1000 + 998)
        at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
        served = {}
        reset_launches()
        for modal in MF_MODALITIES:
            cfg_m, params_m = select_modality(cfg_ck, params_ck, modal)
            served[modal] = SevenNetCalculator(build_model_spec(cfg_m), params_m,
                                               device=str(dev)).calculate(at)["energy"]
        requests = read_launches()
        want = dict(dict.fromkeys(counters(), 0), fwd=2 * n_layers, bwd=2 * n_layers)
        live = tree_map(lambda p: p.detach(), trainer.params)
        for modal in MF_MODALITIES:
            spec_m = dataclasses.replace(trainer.spec, pinned_modal=cfg_ck["modal_map"][modal])
            e_live = SevenNetCalculator(spec_m, live, device=str(dev)).calculate(at)["energy"]
            log(f"  checkpoint_last serves {modal}: E {served[modal]:.8f} eV, trained model "
                f"{e_live:.8f} eV")
            if not (np.isfinite(served[modal])
                    and abs(served[modal] - e_live) <= 1e-6 * abs(e_live)):
                raise SystemExit(f"mf-ompa checkpoint serves {modal} at {served[modal]}, the "
                                 f"trained model {e_live}")
        if requests != want:
            raise SystemExit(f"mf-ompa requests from the checkpoint launched {requests}, "
                             f"expected {want}")
        e = list(served.values())
        if abs(e[0] - e[1]) <= 1e-6 * max(abs(e[0]), 1.0):
            raise SystemExit(f"mf-ompa checkpoint: the modalities give the same energy {e}")
        return {k: counts[k] + requests[k] for k in counts}


def ensemble_phase(spec, params, dev, seed: int, card: str):
    """The ensembles of ``MDEngine.run`` on a 3,000-atom water box with
    SevenNet-0, ENS_STEPS steps of MD_DT from one state each: ms/step
    (host clock around synchronized work) beside NVE's; ENS_PLAIN also on a
    plain-conv engine (positions within MD_POS_TOL, energies within
    ENERGY_REL_TOL relative, the npt cell within CELL_REL_TOL relative);
    every run finite, 5 B1 + 5 B2 per force evaluation (with the stress
    for the NPT ones); Berendsen changes the volume; the drift of the MTK
    invariant. Returns the kernel engine's launches."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine, npt_conserved_quantity

    pos, Z, cell = water_box(1000)
    n = len(pos)
    engines = {k: MDEngine(spec, params, cell, device=str(dev), plain=(k == "plain"))
               for k in ("kernel", "plain")}
    start = {k: eng.make_state(pos, Z, temperature=MD_T, seed=seed) for k, eng in engines.items()}
    total = dict.fromkeys(counters(), 0)
    runs = {}
    for name, kw in ENSEMBLES.items():
        for side in ("kernel", "plain") if name in ENS_PLAIN else ("kernel",):
            eng = engines[side]
            evals = record_evaluations(eng)
            r0 = eng.n_rebuilds
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            st, (pe, ke) = eng.run(start[side], ENS_STEPS, dt=MD_DT, chunk=ENS_STEPS,
                                   integrator=name, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / ENS_STEPS * 1e3
            counts = read_launches()
            del eng._forces  # undo record_evaluations
            pe, ke = pe.cpu().numpy(), ke.cpu().numpy()
            runs[(name, side)] = (st, pe, ke, ms)
            if side == "plain":
                if any(counts.values()):
                    raise SystemExit(f"{name}: the plain engine launched {counts}")
                continue
            want = dict(dict.fromkeys(counts, 0), fwd=5 * len(evals), bwd=5 * len(evals))
            if counts != want:
                raise SystemExit(f"{name} at 3,000 atoms: launches {counts}, expected {want}")
            total = {k: total[k] + counts[k] for k in total}
            v0, v1 = float(start[side].volume()), float(st.volume())
            line = (f"{name} 3,000 atoms, {ENS_STEPS} steps of {MD_DT} fs {kw}: {ms:.1f} ms/step "
                    f"(host clock; NVE {runs[('nve', 'kernel')][3]:.1f}), PE {pe[0]:.6f} -> "
                    f"{pe[-1]:.6f} eV, T {float(st.temperature()):.1f} K, volume rel change "
                    f"{(v1 - v0) / v0:.3e}, {len(evals)} force evaluations, "
                    f"{eng.n_rebuilds - r0} device rebuilds, launches "
                    f"{want['fwd']} B1 + {want['bwd']} B2")
            if name == "npt":
                h = [float(npt_conserved_quantity(x, **kw)) for x in (start[side], st)]
                line += (f"; MTK invariant {h[0]:.6f} -> {h[1]:.6f} eV (drift {h[1] - h[0]:.3e} "
                         f"eV over {ENS_STEPS} steps, KE {float(st.kinetic_energy()):.3f} eV)")
            log(line + f" | {card}")
            if not (np.isfinite(pe).all() and np.isfinite(ke).all()
                    and bool(torch.isfinite(st.positions).all())):
                raise SystemExit(f"{name} at 3,000 atoms: non-finite state")
            if name == "npt_berendsen" and v1 == v0:
                raise SystemExit("npt_berendsen did not change the volume")
    for name in ENS_PLAIN:
        (st_k, pe_k, _, _), (st_p, pe_p, _, ms_p) = runs[(name, "kernel")], runs[(name, "plain")]
        dx = float(np.abs(unsorted(st_k, n, "positions") - unsorted(st_p, n, "positions")).max())
        de = float(np.abs(pe_k - pe_p).max() / np.abs(pe_p).max())
        dc = float((st_k.cell - st_p.cell).abs().max() / st_p.cell.abs().max())
        log(f"  {name} kernel vs plain conv over {ENS_STEPS} steps: max|dx|={dx:.3e} A (tol "
            f"{MD_POS_TOL:g}), max rel dPE={de:.3e} (tol {ENERGY_REL_TOL:g}), cell rel "
            f"{dc:.3e} (tol {CELL_REL_TOL:g}); plain {ms_p:.1f} ms/step | {card}")
        if not (dx <= MD_POS_TOL and de <= ENERGY_REL_TOL and dc <= CELL_REL_TOL):
            raise SystemExit(f"{name}: the kernel engine left the plain-conv engine: dx {dx}, "
                             f"dPE {de}, cell {dc}")
    cell0 = start["kernel"].cell
    dcell = float(((runs[("npt", "kernel")][0].cell - cell0).abs().max() / cell0.abs().max()))
    log(f"  npt cell moved {dcell:.3e} relative over {ENS_STEPS} steps")
    got = compress_check(spec, params, dev, seed, card)
    return {k: total[k] + got[k] for k in total}


def compress_check(spec, params, dev, seed: int, card: str):
    """A box that NPT compresses (``npt_berendsen`` at COMPRESS_KW toward
    COMPRESS_DP above its pressure at the start, 3,000 atoms, one MD_DT step
    a call) past its cell grid's slack: the pairs
    within the cutoff without a slot (:func:`missing_pairs`) must be 0 after
    every step, and the grid re-derived at least once, the run going on to
    COMPRESS_AFTER steps past it (at most COMPRESS_STEPS); 5 B1 + 5 B2 per
    force evaluation. Returns the launches."""
    import torch

    from sevennet_tpu_torch.md import MDEngine

    pos, Z, cell = water_box(1000)
    eng = MDEngine(spec, params, cell, device=str(dev))
    st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
    grid0, edge0 = eng.cl_spec.n_cells, float(st.cell[0, 0])
    kw = dict(COMPRESS_KW, pressure=float(st.pressure()) + COMPRESS_DP)
    evals = record_evaluations(eng)
    total = dict.fromkeys(counters(), 0)
    first, bad, t_run = None, [], 0.0
    for step in range(1, COMPRESS_STEPS + 1):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        st, _ = eng.run(st, 1, dt=MD_DT, chunk=1, **kw)
        torch.cuda.synchronize()
        t_run += time.perf_counter() - t0
        got = read_launches()
        total = {k: total[k] + got[k] for k in total}
        n_miss = missing_pairs(eng, st)
        if n_miss:
            bad.append((step, n_miss))
        if first is None and eng.n_regrids:
            first = step
        if first is not None and step >= first + COMPRESS_AFTER:
            break
    del eng._forces  # undo record_evaluations
    want = dict(dict.fromkeys(total, 0), fwd=5 * len(evals), bwd=5 * len(evals))
    log(f"  compressing npt_berendsen 3,000 atoms {kw}, {step} steps of {MD_DT} fs: box "
        f"edge {float(st.cell[0, 0]) / edge0:.4f} of its start, grid {grid0} -> "
        f"{eng.cl_spec.n_cells} (re-derived {eng.n_regrids} times, first at step {first}), "
        f"{eng.n_rebuilds} device rebuilds, {eng.n_growths} growths, {len(evals)} force "
        f"evaluations, {t_run / step * 1e3:.1f} ms/step (host clock); pairs within the cutoff "
        f"without a slot after any step: {bad or 0} | {card}")
    if bad:
        raise SystemExit(f"compressing npt: pairs within the cutoff without a slot {bad}")
    if first is None:
        raise SystemExit(f"compressing npt: the grid {grid0} was never re-derived in "
                         f"{COMPRESS_STEPS} steps")
    if total != want:
        raise SystemExit(f"compressing npt: launches {total}, expected {want}")
    return total


def d3_goldens(dev, card: str):
    """``D3Calculator()`` (PBE, BJ, full cutoff) on the card against the
    reference CUDA goldens that tests/test_d3.py embeds: H2O (energy 2e-6
    eV, forces 5e-6 eV/A) and strained NaCl with the full lattice sum
    (energy 5e-5 eV, forces and stress 2e-5)."""
    import numpy as np

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.d3 import D3Calculator

    calc = D3Calculator(device=str(dev))
    h2o = calc.calculate(AtomsLite(
        positions=np.array([[0.0, 0.2, 0.12], [0.0, 0.76, -0.48], [0.0, -0.76, -0.48]]),
        numbers=np.array([8, 1, 1]), cell=None, pbc=False))
    cell = np.array([[1.0, 2.815, 2.815], [2.815, 0.0, 2.815], [2.815, 2.815, 0.0]])
    nacl = calc.calculate(AtomsLite(positions=np.array([[0.0, 0.0, 0.0], [2.815, 0.0, 0.0]]),
                                    numbers=np.array([11, 17]), cell=cell, pbc=True))
    errs = {
        "H2O energy": (abs(h2o["energy"] + 0.009889134535170716), 2e-6),
        "H2O forces": (float(np.abs(h2o["forces"] - np.array([
            [0.0, 2.04263840e-03, 1.27477674e-03], [0.0, -9.90038901e-05, 1.18046682e-06],
            [0.0, -1.94363451e-03, -1.27595721e-03]])).max()), 5e-6),
        "NaCl energy": (abs(nacl["energy"] + 0.531393751583389), 5e-5),
        "NaCl forces": (float(np.abs(nacl["forces"] - np.array([
            [-0.00570205, 0.00107457, 0.00107459],
            [0.00570205, -0.00107457, -0.00107459]])).max()), 2e-5),
        "NaCl stress": (float(np.abs(nacl["stress"] - np.array([
            1.52403705e-02, 1.50417333e-02, 1.50417321e-02, -3.22684163e-05, -5.05532863e-05,
            -5.05586994e-05])).max()), 2e-5),
    }
    log("D3 goldens (reference CUDA D3, tests/test_d3.py:98-146) on the card: " + ", ".join(
        f"{k} err {e:.3e} (tol {t:g})" for k, (e, t) in errs.items()) + f" | {card}")
    bad = [k for k, (e, t) in errs.items() if not e <= t]
    if bad:
        raise SystemExit(f"D3 goldens: {bad} out of tolerance")


def d3_request(spec, params, dev, card: str):
    """A 192-atom water request through ``SevenNetCalculator(...).with_d3()``
    at the full ~50.2 A D3 cutoff: 5 B1 + 5 B2 launches, finite results; the
    fp32 D3 part against the same module in float64 on the card (energy
    D3_E64_REL_TOL relative, forces D3_F64_REL_TOL of max |F|), the default
    chunks against chunks of another size; the request's wall clock split
    into the model, the D3 host list (with the copy to the card) and D3's
    device time (CUDA events), and D3's peak memory. Returns the launches."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.d3 import D3Calculator, chunk_edges, d3_compute

    pos, Z, cell = water_box(D3_REQ_MOLECULES)
    n = len(pos)
    at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    calc = SevenNetCalculator(spec, params, device=str(dev)).with_d3(D3["functional"],
                                                                    D3["damping"])
    reset_launches()
    t0 = time.perf_counter()
    res = calc.calculate(at)
    first_s = time.perf_counter() - t0
    counts = read_launches()
    want = dict(dict.fromkeys(counts, 0), fwd=len(spec.layers), bwd=len(spec.layers))
    if counts != want:
        raise SystemExit(f"D3 request: launches {counts}, expected {want}")
    if not (np.isfinite(res["energy"]) and np.isfinite(res["forces"]).all()
            and np.isfinite(res["stress"]).all() and res["forces"].shape == (n, 3)):
        raise SystemExit("D3 request: non-finite or misshapen results")
    d3_32 = calc.d3.results
    d3_64 = D3Calculator(device=str(dev), dtype=torch.float64).calculate(at)
    de = abs(d3_32["energy"] - d3_64["energy"]) / abs(d3_64["energy"])
    df = float(np.abs(d3_32["forces"] - d3_64["forces"]).max())
    f64 = float(np.abs(d3_64["forces"]).max())
    ds = float(np.abs(d3_32["stress"] - d3_64["stress"]).max())
    # the split of one request: the model, the D3 host list, D3 on the card
    p = calc.d3.params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calc.base.calculate(at)
    t1 = time.perf_counter()
    edges = calc.d3.edges(at)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d3_ms = cuda_time(lambda: d3_compute(p, *edges), reps=3)
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    n_edges = int(edges[1].shape[0])
    e_a, f_a, _ = d3_compute(p, *edges)
    other = -(-n_edges // 7)
    e_b, f_b, _ = d3_compute(p, *edges, chunk=other)
    dce = abs(float(e_a - e_b)) / abs(float(e_a))
    dcf = float((f_a - f_b).abs().max() / f_a.abs().max())
    t3 = time.perf_counter()
    calc.calculate(at)
    wall = (time.perf_counter() - t3) * 1e3
    log(f"D3 request 192 atoms (SevenNet-0 + D3 PBE/BJ, cutoff {p.cutoff:.4f} A, {n_edges} edges, "
        f"{-(-n_edges // chunk_edges(torch.float32))} chunks of {chunk_edges(torch.float32)}): "
        f"E {res['energy']:.6f} eV (D3 {d3_32['energy']:.6f}); fp32 D3 vs float64 on the card: "
        f"rel dE {de:.3e} (tol {D3_E64_REL_TOL:g}), max|dF| {df:.3e} eV/A = {df / f64:.3e} of "
        f"max|F| {f64:.3e} (tol {D3_F64_REL_TOL:g}), max|dS| {ds:.3e} eV/A^3; "
        f"{-(-n_edges // other)} chunks vs the default: rel dE {dce:.3e} (tol "
        f"{D3_CHUNK_E_REL_TOL:g}), max|dF| "
        f"{dcf:.3e} of max|F| (tol {D3_CHUNK_F_REL_TOL:g}); launches {want['fwd']} B1 + "
        f"{want['bwd']} B2 | {card}")
    log(f"  D3 request split: request {wall:.1f} ms (wall; the first {first_s * 1e3:.1f} ms), "
        f"model {(t1 - t0) * 1e3:.1f} ms (wall), D3 host list + copy {(t2 - t1) * 1e3:.1f} ms "
        f"(wall), D3 on the card {d3_ms:.2f} ms (CUDA events, mean of 3), D3 peak "
        f"{peak:.2f} GiB over {before / 2**30:.2f} GiB held | {card}")
    checks = ((de <= D3_E64_REL_TOL, f"fp32 vs float64 rel dE {de}"),
              (df <= D3_F64_REL_TOL * f64, f"fp32 vs float64 max|dF| {df}"),
              (dce <= D3_CHUNK_E_REL_TOL, f"chunks rel dE {dce}"),
              (dcf <= D3_CHUNK_F_REL_TOL, f"chunks max|dF| {dcf} of max|F|"))
    for ok, why in checks:
        if not ok:
            raise SystemExit(f"D3 request: {why}")
    return counts


def d3_md(spec, params, dev, seed: int, card: str):
    """NVE with D3 at 3,000 atoms (SevenNet-0, the D3 cutoff bounded by the
    box): the initial energy and forces less the no-D3 engine's against
    ``D3Calculator(cutoff_ang=engine cutoff)`` (D3_ENGINE_TOL; the energy
    also as the engine's own D3 term, since two fp32 totals of about 1,400 eV
    resolve only 1.2e-4 eV); D3_MD_STEPS steps against a plain-conv engine
    with D3 (positions MD_POS_TOL, energy ENERGY_REL_TOL relative, 5 B1 + 5 B2
    per force evaluation); ms/step with and without D3, D3's ms per force
    evaluation (CUDA events), live D3 edges and slots, the peak memory of a
    step and of a rebuild; then D3_NPT_STEPS ``npt`` steps with D3 (the
    volume moves, all finite). Returns the kernel engine's launches."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.d3 import D3Calculator
    from sevennet_tpu_torch.md import MDEngine

    pos, Z, cell = water_box(1000)
    n = len(pos)
    eng0 = MDEngine(spec, params, cell, device=str(dev))
    eng = MDEngine(spec, params, cell, device=str(dev), d3=D3)
    plain = MDEngine(spec, params, cell, device=str(dev), d3=D3, plain=True)
    st0 = eng0.make_state(pos, Z, temperature=MD_T, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    cut = eng.d3_params.cutoff
    slots = st.d3_edge_mask.numel()
    live = int(st.d3_edge_mask.sum())
    t0 = time.perf_counter()
    ref = D3Calculator(cutoff_ang=cut, device=str(dev)).calculate(
        AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    t_calc = time.perf_counter() - t0
    e3, f3, _ = eng._d3_term(st)
    de_term = abs(float(e3) - ref["energy"])
    de_tot = abs(float(st.potential_energy - st0.potential_energy) - ref["energy"])
    e_res = 2 * float(np.spacing(np.float32(abs(float(st0.potential_energy)))))
    df = float(np.abs(unsorted(st, n, "forces") - unsorted(st0, n, "forces")
                      - ref["forces"]).max())
    log(f"D3 MD 3,000 atoms: cutoff {cut:.4f} A (box {cell[0, 0]:.4f} A, skin {eng.skin}), "
        f"{live} live D3 edges in {slots} slots (K3 {eng.d3_cl_spec.neighbor_capacity}, "
        f"{eng.d3_cl_spec.n_cells} grid cells), make_state {t_make:.1f} s; against "
        f"D3Calculator at that cutoff ({t_calc:.1f} s, host list of {len(ref['forces'])} atoms): "
        f"the engine's D3 term dE {de_term:.3e} eV, E(D3) - E(no D3) dE {de_tot:.3e} eV "
        f"(fp32 totals resolve {e_res:.2e} eV), max|dF| {df:.3e} eV/A (tol {D3_ENGINE_TOL:g}) "
        f"| {card}")
    if not (de_term <= D3_ENGINE_TOL and de_tot <= D3_ENGINE_TOL + e_res
            and df <= D3_ENGINE_TOL):
        raise SystemExit(f"D3 MD: the engine's D3 term left D3Calculator: dE {de_term}, "
                         f"total dE {de_tot}, dF {df}")
    runs = {}
    for key, e in (("kernel", eng), ("plain", plain), ("no_d3", eng0)):
        start = st0 if key == "no_d3" else (st if key == "kernel" else
                                             e.make_state(pos, Z, temperature=MD_T, seed=seed))
        evals = record_evaluations(e)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        end, (pe, _) = e.run(start, D3_MD_STEPS, dt=MD_DT, chunk=D3_MD_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / D3_MD_STEPS * 1e3
        del e._forces  # undo record_evaluations
        runs[key] = (end, pe.cpu().numpy(), ms, read_launches(), len(evals))
    (st_k, pe_k, ms_k, counts, n_evals), (st_p, pe_p, ms_p, counts_p, _) = (runs["kernel"],
                                                                             runs["plain"])
    dx = float(np.abs(unsorted(st_k, n, "positions") - unsorted(st_p, n, "positions")).max())
    dpe = float(np.abs(pe_k - pe_p).max() / np.abs(pe_p).max())
    want = dict(dict.fromkeys(counts, 0), fwd=5 * n_evals, bwd=5 * n_evals)
    d3_ms = cuda_median(lambda: eng._d3_term(st_k), 3)
    # one step with no rebuild in it (the integrator's step alone, no skin
    # test), then one rebuild alone
    step, forces_fn = eng._step_fn("nve", MD_DT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(st_k, forces_fn)
    torch.cuda.synchronize()
    peak_step = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng._rebuild(st_k)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    peak_rebuild = torch.cuda.max_memory_allocated() / 2**30
    log(f"  D3 NVE {D3_MD_STEPS} steps of {MD_DT} fs, kernel vs plain conv (both with D3): "
        f"max|dx|={dx:.3e} A (tol {MD_POS_TOL:g}), max rel dPE={dpe:.3e} (tol "
        f"{ENERGY_REL_TOL:g}), PE {pe_k[0]:.6f} -> {pe_k[-1]:.6f} eV; {ms_k:.1f} ms/step with "
        f"D3, {runs['no_d3'][2]:.1f} without, plain conv with D3 {ms_p:.1f} (host clock); D3 "
        f"{d3_ms:.2f} ms per force evaluation (CUDA events, median of 3); peak {peak_step:.2f} "
        f"GiB in a step without a rebuild, {peak_rebuild:.2f} GiB in a rebuild of both grids "
        f"({rebuild_ms:.1f} ms, wall); device "
        f"rebuilds {eng.n_rebuilds}, growths {eng.n_growths}; {n_evals} force evaluations, "
        f"launches {want['fwd']} B1 + {want['bwd']} B2 | {card}")
    checks = ((dx <= MD_POS_TOL, f"max|dx| {dx}"), (dpe <= ENERGY_REL_TOL, f"rel dPE {dpe}"),
              (counts == want, f"launches {counts}, expected {want}"),
              (not any(counts_p.values()), f"the plain engine launched {counts_p}"),
              (bool(np.isfinite(pe_k).all() and torch.isfinite(st_k.positions).all()),
               "non-finite state"))
    for ok, why in checks:
        if not ok:
            raise SystemExit(f"D3 MD at 3,000 atoms: {why}")
    total = dict(counts)
    # npt with D3: the D3 virial reaches the barostat
    evals = record_evaluations(eng)
    r0 = eng.n_rebuilds
    reset_launches()
    t0 = time.perf_counter()
    end, (pe, ke) = eng.run(st, D3_NPT_STEPS, dt=MD_DT, chunk=D3_NPT_STEPS, integrator="npt",
                            **ENSEMBLES["npt"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / D3_NPT_STEPS * 1e3
    del eng._forces
    counts = read_launches()
    v0, v1 = float(st.volume()), float(end.volume())
    log(f"  D3 npt {D3_NPT_STEPS} steps {ENSEMBLES['npt']}: {ms:.1f} ms/step (host clock), "
        f"volume rel change {(v1 - v0) / v0:.3e}, PE {float(pe[0]):.6f} -> {float(pe[-1]):.6f} "
        f"eV, pressure {float(end.pressure()):.3e} eV/A^3; {len(evals)} force evaluations, "
        f"{eng.n_rebuilds - r0} device rebuilds, launches {counts} | {card}")
    if counts != dict(dict.fromkeys(counts, 0), fwd=5 * len(evals), bwd=5 * len(evals)):
        raise SystemExit(f"D3 npt: launches {counts}")
    if not (v1 != v0 and np.isfinite(v1) and bool(torch.isfinite(pe).all())
            and bool(torch.isfinite(end.positions).all())):
        raise SystemExit(f"D3 npt: volume {v0} -> {v1}, or non-finite state")
    return {k: total[k] + counts[k] for k in total}


def d3_phase(spec, params, dev, seed: int, card: str):
    """Grimme D3 on the card: the goldens, the 192-atom request with D3 and
    MD with D3 at 3,000 atoms. Returns the launches of the main paths."""
    d3_goldens(dev, card)
    served = d3_request(spec, params, dev, card)
    md = d3_md(spec, params, dev, seed, card)
    return {k: served[k] + md[k] for k in served}


def resolution_phase(spec, params, dev, card: str):
    """A SevenNet-0 checkpoint saved by the port under its registry base
    name in a temporary ``$SEVENN_TPU_CHECKPOINT_DIR``, served by name
    (``SevenNetCalculator("7net-0")``) for a 192-atom water box (5 B1 +
    5 B2) and held against the spec-and-params calculator on the same
    weights: bitwise, or else within 1e-6 relative (the per-graph energy
    sum, ``index_add_`` on CUDA, adds in no fixed order). Returns the
    request's launches."""
    import os

    import numpy as np

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.io.native_checkpoint import save_checkpoint
    from sevennet_tpu_torch.io.registry import resolve_checkpoint

    pos, Z, cell = water_box(64, seed=7)
    at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    old = os.environ.get("SEVENN_TPU_CHECKPOINT_DIR")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_registry_") as tmp:
        os.environ["SEVENN_TPU_CHECKPOINT_DIR"] = tmp
        try:
            save_checkpoint(os.path.join(tmp, "checkpoint_sevennet_0"), dict(SEVENNET0), params)
            path = resolve_checkpoint("7net-0")
            t0 = time.perf_counter()
            by_name = SevenNetCalculator("7net-0", device=str(dev))
            t_load = time.perf_counter() - t0
            reset_launches()
            got = by_name.calculate(at)
            counts = read_launches()
        finally:
            if old is None:
                os.environ.pop("SEVENN_TPU_CHECKPOINT_DIR")
            else:
                os.environ["SEVENN_TPU_CHECKPOINT_DIR"] = old
    want = SevenNetCalculator(spec, params, device=str(dev)).calculate(at)
    bitwise = all(np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
                  for k in ("energy", "forces", "stress"))
    df, fmax, de, _ = request_errors(got, want)
    log(f"resolution: '7net-0' -> {os.path.basename(path)}, loaded in {t_load:.2f} s; 192 atoms "
        f"E {got['energy']:.8f} vs spec+params {want['energy']:.8f} eV (rel {de:.3e}), max|dF| "
        f"{df:.3e} eV/A; bitwise equal: {bitwise}; launches {counts} | {card}")
    n_layers = len(spec.layers)
    if counts != dict(dict.fromkeys(counts, 0), fwd=n_layers, bwd=n_layers):
        raise SystemExit(f"the request by name launched {counts}")
    if not bitwise and not (de <= 1e-6 and df <= 1e-6 * fmax):
        raise SystemExit("the request by name disagrees with the spec-and-params calculator")
    return counts


DEPLOYED_SCALE = 2.5  # the explicit ``x * s`` on one linear's data operand
DEPLOYED_CONFIG = {  # what a deployment's metadata does not record of SevenNet-0
    "irreps_manual": SEVENNET0["irreps_manual"],
    "cutoff_function": SEVENNET0["cutoff_function"],
    "_full_last_layer": False,
}
PARAM_ROUND_TRIP_TOL = 1e-6  # per leaf, of max |original|: fp32 rounding of the path norms


def deployed_phase(spec, params, dev, card: str):
    """A frozen TorchScript deployment of SevenNet-0 at full width (the
    weights drawn from the seed, metadata version 0.11.0, one linear behind
    an explicit ``x * s``), written by ``tests/torch_deployed_artifact.py``
    and imported by ``io/torchscript_import.py:load_deployed_model`` (given
    the per-layer irreps and the XPLOR cutoff, which the metadata lacks):
    the spec equal to SevenNet-0's, every parameter within 1e-6 of its
    largest original entry; a 3,000-atom water box served through it (5 B1
    + 5 B2 and no other conv kernel) against the spec-and-params calculator
    on the original weights and against the plain path on the imported
    ones, at the request limits; both requests timed in turns. Then the
    registry's download: ``7net-mf-ompa``'s entry pointed at a ``file://``
    stock ``.pth`` of the same weights outside a temporary
    ``$SEVENN_TPU_CHECKPOINT_DIR``; a wrong pinned digest must be refused
    with no ``.partial`` left, the right one must download, load through
    ``load_model`` with equal weights and serve a 192-atom request by name
    (5 B1 + 5 B2) as the spec-and-params calculator does (bitwise, else
    1e-6 relative). Returns the launches of the two requests."""
    import hashlib
    import os

    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.io import registry
    from sevennet_tpu_torch.io.torch_checkpoint import state_dict_from_params
    from sevennet_tpu_torch.io.torchscript_import import _ordered_constants, load_deployed_model
    from sevennet_tpu_torch.train.trainer import tree_leaves
    from tests.torch_deployed_artifact import write_deployed

    n_layers = len(spec.layers)

    def leaf_error(got_params):
        worst = 0.0
        for a, b in zip(tree_leaves(got_params), tree_leaves(params)):
            if a.shape != b.shape:
                raise SystemExit(f"deployed: a leaf of shape {tuple(a.shape)}, expected "
                                 f"{tuple(b.shape)}")
            scale = float(b.abs().max())
            worst = max(worst, float((a.cpu() - b.cpu()).abs().max()) / max(scale, 1e-30))
        return worst

    def served(calc, at):
        reset_launches()
        res = calc.calculate(at)
        counts = read_launches()
        if counts != dict(dict.fromkeys(counts, 0), fwd=n_layers, bwd=n_layers):
            raise SystemExit(f"deployed phase: a request launched {counts}")
        return res, counts

    pos, Z, cell = water_box(1000, seed=11)
    at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deployed_") as tmp:
        path = os.path.join(tmp, "deployed_serial.pt")
        t0 = time.perf_counter()
        stream = write_deployed(path, spec, params, scaled=("1_self_interaction_1.linear.weight",),
                                scale=DEPLOYED_SCALE)
        t_write = time.perf_counter() - t0
        consts = _ordered_constants(torch.jit.load(path, map_location="cpu"))
        n_scaled = sum(s == DEPLOYED_SCALE for _, s in consts)
        want_scaled = sum(k == "1_self_interaction_1.linear.weight" for k, _, _ in stream)
        if n_scaled != want_scaled:
            raise SystemExit(f"deployed: {n_scaled} constants behind x * {DEPLOYED_SCALE} in the "
                             f"frozen graph, {want_scaled} written")
        t0 = time.perf_counter()
        spec_d, params_d = load_deployed_model(path, config=DEPLOYED_CONFIG)
        t_import = time.perf_counter() - t0
        size = os.path.getsize(path)
    if spec_d != spec:
        raise SystemExit("deployed: the imported spec is not SevenNet-0's")
    err = leaf_error(params_d)
    log(f"deployed: SevenNet-0 artifact of {len(stream)} constants ({len(consts)} after "
        f"freezing pooled the denominators; {n_scaled} behind x * {DEPLOYED_SCALE}), "
        f"{size / 2**20:.2f} MiB, written in {t_write:.2f} s, imported in {t_import:.3f} s "
        f"(host wall clock, torch {torch.__version__}); parameters within "
        f"{err:.3e} of max |original| per leaf | {card}")
    if err > PARAM_ROUND_TRIP_TOL:
        raise SystemExit(f"deployed: imported parameters {err} > {PARAM_ROUND_TRIP_TOL} relative")

    calc_d = SevenNetCalculator(spec_d, params_d, device=str(dev))
    calc = SevenNetCalculator(spec, params, device=str(dev))
    got, counts_d = served(calc_d, at)
    want = calc.calculate(at)
    plain = SevenNetCalculator(spec_d, params_d, device=str(dev), plain=True).calculate(at)
    line_o = check_request(f"deployed {len(Z)} atoms against spec+params", got, want)
    line_p = check_request(f"deployed {len(Z)} atoms against the plain path", got, plain)
    walls = {"deployed": [], "spec+params": []}
    for _ in range(REPS):
        for name, c in (("deployed", calc_d), ("spec+params", calc), ("spec+params", calc),
                        ("deployed", calc_d)):
            t0 = time.perf_counter()
            c.calculate(at)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    log(f"deployed {len(Z)} atoms: E {got['energy']:.6f} eV; against spec+params {line_o}; "
        f"against plain {line_p}; launches {counts_d['fwd']} fwd + {counts_d['bwd']} bwd; "
        f"request median {statistics.median(walls['deployed']):.2f} ms through the imported "
        f"model, {statistics.median(walls['spec+params']):.2f} ms spec+params (wall clock, "
        f"{2 * REPS} each, in turns) | {card}")

    entry = registry._REGISTRY["sevennet-mf-ompa"]
    old_env = {k: os.environ.get(k) for k in ("SEVENN_TPU_CHECKPOINT_DIR", "SEVENN_TPU_CHECKSUMS")}
    small = water_box(64, seed=7)
    at_small = AtomsLite(positions=small[0], numbers=small[1], cell=small[2], pbc=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_download_") as tmp:
        cache, assets = os.path.join(tmp, "cache"), os.path.join(tmp, "assets")
        os.makedirs(cache)
        os.makedirs(assets)
        asset = os.path.join(assets, entry.basename)
        sd = state_dict_from_params(spec, params)
        torch.save({"config": dict(SEVENNET0, version="0.11.0"),
                    "model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
                   asset)
        with open(asset, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()
        pins = os.path.join(tmp, "checksums.json")
        os.environ["SEVENN_TPU_CHECKPOINT_DIR"] = cache
        os.environ["SEVENN_TPU_CHECKSUMS"] = pins
        registry._REGISTRY["sevennet-mf-ompa"] = registry._Entry(entry.basename,
                                                                 "file://" + asset)
        try:
            with open(pins, "w") as fh:
                json.dump({entry.basename: "0" * 64}, fh)
            try:
                registry.resolve_checkpoint("7net-mf-ompa")
                raise SystemExit("deployed: a download with a wrong pinned digest was accepted")
            except FileNotFoundError as exc:
                refused = str(exc)
            if "sha256 mismatch" not in refused or os.listdir(cache):
                raise SystemExit(f"deployed: the wrong digest: {refused}; left {os.listdir(cache)}")
            with open(pins, "w") as fh:
                json.dump({entry.basename: digest}, fh)
            size = os.path.getsize(asset)
            t0 = time.perf_counter()
            resolved = registry.resolve_checkpoint("7net-mf-ompa")
            t_download = time.perf_counter() - t0
            if resolved != os.path.join(cache, entry.basename) or sorted(os.listdir(cache)) != [
                    entry.basename]:
                raise SystemExit(f"deployed: resolved {resolved}, cache {os.listdir(cache)}")
            spec_r, params_r = registry.load_model(resolved)
            by_name = SevenNetCalculator("7net-mf-ompa", device=str(dev))
            got_r, counts_r = served(by_name, at_small)
        finally:
            registry._REGISTRY["sevennet-mf-ompa"] = entry
            for k, v in old_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    if spec_r != spec or leaf_error(params_r) != 0.0:
        raise SystemExit("deployed: the downloaded checkpoint's model differs from SevenNet-0's")
    want_r = calc.calculate(at_small)
    bitwise = all(np.array_equal(np.asarray(got_r[k]), np.asarray(want_r[k]))
                  for k in ("energy", "forces", "stress"))
    df, fmax, de, _ = request_errors(got_r, want_r)
    log(f"deployed download: '7net-mf-ompa' from a file:// stock .pth of {size / 2**20:.2f} MiB: "
        f"a wrong pin refused ({refused[refused.index('sha256 mismatch'):][:44]}...), no "
        f".partial left; the right pin downloaded in {t_download:.3f} s; {len(small[1])} atoms E {got_r['energy']:.8f} vs spec+params "
        f"{want_r['energy']:.8f} eV (rel {de:.3e}), max|dF| {df:.3e} eV/A; bitwise equal: "
        f"{bitwise}; launches {counts_r} | {card}")
    if not bitwise and not (de <= 1e-6 and df <= 1e-6 * fmax):
        raise SystemExit("deployed: the downloaded checkpoint's request disagrees with spec+params")
    return {k: counts_d[k] + counts_r[k] for k in counts_d}


def mlp_depth_phase(dev, atoms, seed: int):
    """B1 and B2 at SevenNet-0's layer 1-3 widths with radial MLPs of
    MLP_DEPTHS hidden layers (random weights from ``seed``), against their
    plain versions on the box (REL_TOL of max |plain|)."""
    import torch

    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device="cpu").manual_seed(6)
    for hidden in MLP_DEPTHS:
        spec = build_model_spec(dict(SEVENNET0, weight_nn_hidden_neurons=list(hidden)))
        params = params_from_numpy(spec, random_params(spec, seed))
        calc, g, vec, src, coef = box_edges(spec, params, dev, atoms)
        N, K = g.n_atoms_cap, g.dense_k
        layer = spec.layers[1]
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        ws = calc.params["1_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, op.dim_x, generator=gen).to(dev)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
        args = (op, x, src, vec, coef, ws)
        tag = f"MLP {list(layer.radial_mlp.dims)}"
        check_close(tag, "fwd", fc.fused_conv_fwd(*args), fc.fused_conv_fwd_plain(*args))
        for n, a, b in zip(("dxg", "dvec"), fc.fused_conv_bwd(*args, ybar),
                           fc.fused_conv_bwd_plain(*args, ybar)):
            check_close(tag, n, a, b)
        log(f"  {tag}: B1 {cuda_time(lambda: fc.fused_conv_fwd(*args), 5):.4f} ms, B2 "
            f"{cuda_time(lambda: fc.fused_conv_bwd(*args, ybar), 5):.4f} ms per layer")
        del x, ybar, args
        torch.cuda.empty_cache()


TF32_PEAK = 495e12    # H100 SXM dense TF32 tensor cores, NVIDIA data sheet
BF16_PEAK = 989e12    # H100 SXM dense bf16 tensor cores
PEAK_OF = {"ffma": FP32_PEAK, "tf32": TF32_PEAK, "wgmma_tf32": TF32_PEAK,
           "3xtf32": TC_3XTF32_PEAK, "3xtf32_presplit": TC_3XTF32_PEAK, "bf16": BF16_PEAK}


# the rate contract's k-512 shape at which REP 32's products are held to at
# least 1.6x REP 16's, besides every variant's first shape in both
# contracts. A call's products take its time less that of the same call at
# REP 0 (the launch, the staging, the store: 3-7 us of one copy,
# mm_breakdown.py's knock-outs), which does not depend on REP: at one copy
# bf16's 16 products take about 4.5 us beside about 4.6 of that, so that
# REP 32's whole call cannot reach 1.6x REP 16's however every product runs.
MM_REP_CHECK_K512 = (480, 512, 1024)
MM_REP_MIN = 1.6


def probe_inputs(variant, m, k, n, dev, seed):
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    dtype = torch.bfloat16 if variant == "bf16" else torch.float32
    return (torch.randn(m, k, generator=gen).to(dev, dtype),
            torch.randn(k, n, generator=gen).to(dev, dtype))


def probe_phase(dev, card: str):
    """The Hopper probes. First each kernel against its plain version at every
    shape of its TPU script (mm_rate.PROBE_TOL; s = 1e-3, 0 for bf16, so
    that the (1 + s i) factor is checked; the matmul variants also at copies
    whose CTAs outnumber the SMs twice, into a given output; launches not
    counted), then the
    probe path with the counts from 0: every variant of both matmul
    contracts timed the TPU script's way on the device alone (captured in
    CUDA graphs; one copy, the contract, and as many copies as fill the
    card; at 250-450 calls too, which shows the time per call is linear),
    the batched product at N 10,016 (rep 1 and 4); beside them the library
    calls at the same shapes (the REP products as REP torch.matmul calls in
    one graph, TF32 off and on, bf16; torch.bmm) and the plain versions.
    The rate per SM is the card rate over the SM count. Returns (records by
    kernels-line key, launches)."""
    import math

    import torch

    from sevennet_tpu_torch.probes import batched_dot as bd
    from sevennet_tpu_torch.probes import mm_rate as mr

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    s = torch.zeros((1, 1), device=dev)  # the TPU scripts' s (zeros, r2_pallas_mm.py:61)
    s_zero_factor = torch.full((1, 1), -0.125, device=dev)
    assert MM_REP_CHECK_K512 in mr.MM_SHAPES
    errs = {}
    for chain in (False, True):
        for v in mr.VARIANTS:
            s_check = torch.full((1, 1), 0.0 if v == "bf16" else 1e-3, device=dev)
            for m, k, n in mr.shapes(v, chain):
                a, b = probe_inputs(v, m, k, n, dev, m + k + n)
                extra = () if chain else (s_check,)
                fn = mr.mm_chain if chain else mr.mm_rate
                tag = f"probe {'mm_chain' if chain else 'mm_rate'} {v} {m}x{k}x{n}"
                want = fn(a, b, *extra, variant=v, plain=True)
                err = check_close(tag, "out", fn(a, b, *extra, variant=v), want,
                                  mr.PROBE_TOL[v])
                # and at copies whose CTAs outnumber the SMs twice, into a
                # given output
                cp = math.ceil(2 * n_sm / mr.mm_ctas(m, k, n, v, chain)) + 1
                out = torch.full((cp, m, n), float("nan"), device=dev)
                got = fn(a, b, *extra, variant=v, copies=cp, out=out)
                assert got is out
                err = max(err, check_close(f"{tag} {cp} copies, out=", "out", out, want,
                                           mr.PROBE_TOL[v]))
                if not chain and (m, k, n) == mr.shapes(v, chain)[0]:
                    # s -0.125: product 8's factor 1 + s i is 0, the later ones
                    # negative
                    err = max(err, check_close(f"{tag} s -0.125", "out",
                                               fn(a, b, s_zero_factor, variant=v),
                                               fn(a, b, s_zero_factor, variant=v, plain=True),
                                               mr.PROBE_TOL[v]))
                errs[(chain, v)] = max(errs.get((chain, v), 0.0), err)
                del out, got
    gen = torch.Generator(device="cpu").manual_seed(8)
    Ss = [(torch.randn(bd.N_ATOMS, d3, kk, generator=gen) * 0.1).to(dev) for d3, kk, _ in bd.GROUPS]
    XWs = [(torch.randn(bd.N_ATOMS, kk, mul, generator=gen) * 0.1).to(dev)
           for _, kk, mul in bd.GROUPS]
    errs["batched"] = bd_check(Ss, XWs, "probe batched_dot")
    bd_ragged_check(dev, n_sm)

    # the probe path, counts from 0
    recs = {}
    mr.mm_rate.launches = mr.mm_chain.launches = bd.batched_dot.launches = 0
    for fn in (mr.mm_rate, mr.mm_chain):
        fn.by_variant = dict.fromkeys(mr.VARIANTS, 0)
    for chain in (False, True):
        for v in mr.VARIANTS:
            for i, (m, k, n) in enumerate(mr.shapes(v, chain)):
                a, b = probe_inputs(v, m, k, n, dev, m + k + n)
                extra = () if chain else (s,)
                fn = mr.mm_chain if chain else mr.mm_rate
                ctas = mr.mm_ctas(m, k, n, v, chain)
                fill = max(1, math.ceil(n_sm / ctas))
                call = lambda: fn(a, b, *extra, variant=v)  # noqa: E731
                ms = mr.mm_time(call)
                lin = mr.mm_time(call, 250, 450, tries=1) / ms
                ms_fill = ms if fill == 1 else mr.mm_time(
                    lambda: fn(a, b, *extra, variant=v, copies=fill))
                fl, fl_fill = mr.mm_flops(m, k, n), mr.mm_flops(m, k, n, copies=fill)
                card_rate = fl_fill / ms_fill / 1e9
                lib_fn = lambda: [torch.matmul(a, b) for _ in range(mr.REP)]  # noqa: E731
                if v == "bf16":
                    lib = mr.mm_time(lib_fn)
                else:
                    lib_t = {}
                    for tf32 in (False, True):
                        torch.backends.cuda.matmul.allow_tf32 = tf32
                        lib_t[tf32] = mr.mm_time(lib_fn)
                    torch.backends.cuda.matmul.allow_tf32 = False
                    lib = lib_t[v in ("tf32", "wgmma_tf32")]
                plain = cuda_time(lambda: fn(a, b, *extra, variant=v, plain=True), 5)
                nbytes = a.element_size() * (a.numel() + b.numel()) + 4 * m * n
                log(f"  probe {'mm_chain' if chain else 'mm_rate'} {v} {m}x{k}x{n}: {ms:.5f} ms "
                    f"per call ({lin:.3f}x at 250-450 calls), {fl / ms / 1e9:.2f} TFLOP/s "
                    f"(1 copy, {ctas} CTAs); {fill} copies: {card_rate:.2f} TFLOP/s "
                    f"per card, {card_rate / n_sm * 1e3:.1f} GFLOP/s card rate / {n_sm} SMs; "
                    f"library {lib:.5f} ms for the same {mr.REP} products (one graph)"
                    + ("" if v == "bf16" else f" (TF32 off {lib_t[False]:.5f}, on {lib_t[True]:.5f})")
                    + f"; plain {plain:.4f} ms | {card}")
                tag = f"probe {'mm_chain' if chain else 'mm_rate'} {v} {m}x{k}x{n}"
                if v in mr.WGMMA_3X and i == 0:
                    rep2 = mr.mm_time(lambda: fn(a, b, *extra, variant=v, rep=2 * mr.REP))
                    log(f"  {tag}: raw TF32 {3 * fl / ms / 1e9:.2f} TFLOP/s (three products a "
                        f"fp32 one; {3 * fl / ms / 1e9 / (TF32_PEAK / 1e12):.1%} of "
                        f"{TF32_PEAK / 1e12:.0f}); REP {2 * mr.REP} {rep2:.5f} ms, "
                        f"{rep2 / ms:.3f}x REP {mr.REP} | {card}")
                    if rep2 / ms < MM_REP_MIN:
                        raise SystemExit(f"{tag}: REP {2 * mr.REP} took {rep2 / ms:.3f}x REP "
                                         f"{mr.REP}: not every product ran")
                if i == 0 or (m, k, n) == MM_REP_CHECK_K512:
                    # every product runs: twice the products take (nearly) twice
                    # the time; one copy, each call less the same call at REP 0,
                    # best of 3 each
                    t0, t16, t32 = (mr.mm_time(lambda: fn(a, b, *extra, variant=v, rep=rep))
                                    for rep in (0, mr.REP, 2 * mr.REP))
                    ratio = (t32 - t0) / (t16 - t0)
                    log(f"  {tag}: REP 0 / {mr.REP} / {2 * mr.REP} {t0:.5f} / {t16:.5f} / "
                        f"{t32:.5f} ms: REP {2 * mr.REP}'s products {ratio:.3f}x REP {mr.REP}'s "
                        f"(the whole call {t32 / t16:.3f}x); plan "
                        f"{mr.mm_plan(m, k, n, chain, 1, n_sm, v)} | {card}")
                    if not ratio >= MM_REP_MIN:
                        raise SystemExit(f"{tag}: REP {2 * mr.REP}'s products took {ratio:.3f}x "
                                         f"REP {mr.REP}'s: not every product ran")
                key = ("mm_chain" if chain else "mm_rate", v)
                if i == 0:
                    bnd, by = max((fl / PEAK_OF[v] * 1e3, "operations"),
                                  (nbytes / HBM_BYTES_S * 1e3, "bytes"))
                    recs[key] = dict(ms=ms, plain_ms=plain, bound=(bnd, by), library_ms=lib,
                                     err=errs[(chain, v)], shape=(m, k, n))
                worst = recs[key].get("worst")
                if worst is None or ms / lib > worst["ms"] / worst["library_ms"]:
                    recs[key]["worst"] = dict(shape=(m, k, n), ms=ms, library_ms=lib)
    recs["batched"] = dict(bd_time(Ss, XWs, card), err=errs["batched"], shape=None)
    launches = {"mm_rate": mr.mm_rate.launches, "mm_chain": mr.mm_chain.launches,
                "batched": bd.batched_dot.launches}
    by_variant = {f"{fn.__name__} {v}": n for fn in (mr.mm_rate, mr.mm_chain)
                  for v, n in fn.by_variant.items()}
    if not (all(launches.values()) and all(by_variant.values())):
        raise SystemExit(f"a probe kernel was never launched on the probe path: {launches}, "
                         f"{by_variant}")
    del Ss, XWs
    torch.cuda.empty_cache()
    return recs, launches


def bd_check(Ss, XWs, tag: str, reps=(1, 4)) -> float:
    """The batched dot against torch.bmm (its plain version) within 1e-5 of
    max |plain| per group, at each ``rep`` (the output must not change);
    launches not counted. Returns the max abs error."""
    from sevennet_tpu_torch.probes import batched_dot as bd

    want = bd.batched_dot(Ss, XWs, plain=True)
    n0 = bd.batched_dot.launches
    err = max(check_close(f"{tag} rep {rep}", f"Y group {i} {tuple(w.shape)}", y, w, 1e-5)
              for rep in reps for i, (y, w) in enumerate(zip(bd.batched_dot(Ss, XWs, rep=rep),
                                                           want)))
    bd.batched_dot.launches = n0
    return err


def bd_ragged_check(dev, n_sm: int) -> None:
    """The batched dot against plain (``bd_check``, rep 1 and 3) at its
    ragged shapes: N below and just above the card's SM count (a CTA with
    no atom, CTAs with one more atom than others), d3 5 and 9, K d1 short of
    a chunk (8, 40) and past one (80, 152), mul 8 and 24."""
    import torch

    from sevennet_tpu_torch.probes import batched_dot as bd

    gen = torch.Generator(device="cpu").manual_seed(9)
    for n, groups in ((n_sm - 7, ((5, 8, 8), (5, 40, 24), (22, 152, 24))),
                      (n_sm + 1, ((9, 40, 8), (5, 8, 24), (20, 80, 64)))):
        Ss = [torch.randn(n, d3, kk, generator=gen).to(dev) for d3, kk, _ in groups]
        XWs = [torch.randn(n, kk, mul, generator=gen).to(dev) for _, kk, mul in groups]
        bd_check(Ss, XWs, f"probe batched_dot N {n} groups {groups}", reps=(1, 3))


def bd_time(Ss, XWs, card: str) -> dict:
    """The batched dot at its script's shape timed by ``batched_dot_time``
    at rep 1 and 4 (the product's time on staged tiles is their difference
    over 3) beside torch.bmm per group (the library call, also its plain
    version) and the bound. Returns a record for the kernels line."""
    from sevennet_tpu_torch.probes import batched_dot as bd

    fl, nbytes = bd.batched_dot_work(Ss, XWs)
    t = {rep: bd.batched_dot_time(lambda: bd.batched_dot(Ss, XWs, rep=rep)) for rep in (1, 4)}
    lib = bd.batched_dot_time(lambda: bd.batched_dot_plain(Ss, XWs))
    bnd = max((fl / TC_3XTF32_PEAK * 1e3, "operations"), (nbytes / HBM_BYTES_S * 1e3, "bytes"))
    staged = (t[4] - t[1]) / 3
    log(f"  probe batched_dot N={bd.N_ATOMS}: {t[1]:.4f} ms ({nbytes / t[1] / 1e6:.1f} GB/s, "
        f"{fl / t[1] / 1e9:.2f} TFLOP/s; {fl / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB), rep 4 "
        f"{t[4]:.4f} ms: {staged:.4f} ms per repeated product on staged tiles "
        f"({fl / staged / 1e9:.2f} TFLOP/s); bound {bnd[0]:.4f} ms by {bnd[1]} "
        f"({bnd[0] / t[1]:.1%} of it); torch.bmm {lib:.4f} ms | {card}")
    return dict(ms=t[1], ms_rep4=t[4], staged_ms=staged, plain_ms=lib, bound=bnd,
                library_ms=lib)


def bd_sass(so) -> None:
    """The batched dot's SASS counts (``sass_counts``): its product on wgmma
    (HGMMA > 0, no HMMA), its copies by TMA (UTMALDG > 0) and no
    local-memory traffic (STL, LDL 0: nothing spilled); the product's
    instruction mix and ptxas's advisories that it serialized wgmma
    printed. Raises SystemExit otherwise, or without cuobjdump."""
    counts = sass_counts(so)
    if counts is None:
        raise SystemExit("cuobjdump not found: the batched dot's SASS cannot be checked")
    bd = {fn: c for fn, c in counts.items() if "batched_dot_kernel" in fn}
    for fn, c in bd.items():
        log(f"  sass {fn}: {c}")
    for ln in open(str(so) + ".log"):
        if "serialized" in ln or "Performance" in ln:
            log(f"  ptxas: {ln.strip()}")
    if len(bd) != 1 or not all(c["HGMMA"] > 0 and c["HMMA"] == 0 and c["UTMALDG"] > 0
                               and c["STL"] == 0 and c["LDL"] == 0 for c in bd.values()):
        raise SystemExit(f"batched_dot_kernel's SASS: {bd}, expected one instance with HGMMA, "
                         "no HMMA, UTMALDG and no STL or LDL")


def bd_probe(dev, card: str, so) -> None:
    """``--bd-probe``: the batched dot alone (``probes/batched_dot.py``):
    its SASS (``bd_sass``), its check against torch.bmm at the script's
    shape (rep 1 and 4) and at its ragged shapes, then its times as the
    whole run takes them (``bd_time``)."""
    import torch

    from sevennet_tpu_torch.probes import batched_dot as bd

    bd_sass(so)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device="cpu").manual_seed(8)
    Ss = [(torch.randn(bd.N_ATOMS, d3, kk, generator=gen) * 0.1).to(dev) for d3, kk, _ in bd.GROUPS]
    XWs = [(torch.randn(bd.N_ATOMS, kk, mul, generator=gen) * 0.1).to(dev)
           for _, kk, mul in bd.GROUPS]
    bd_check(Ss, XWs, "probe batched_dot")
    bd_ragged_check(dev, n_sm)
    bd_time(Ss, XWs, card)


FILL_THREADS_PER_SM = 16 * 1024  # threads the FMA probes' fill copies give each SM


def sass_counts(so):
    """fp32 instructions (FFMA, FADD, FMUL), tensor-core ones (HMMA:
    mma.sync, HGMMA: wgmma), shared-memory stores and loads (STS, LDS, of
    any width), cp.async copies (LDGSTS), TMA loads (UTMALDG) and
    local-memory stores and loads (STL, LDL) of every kernel in library
    ``so``, and the FFMAs that read an
    operand from
    the reuse cache (a ``.reuse`` flag on the FFMA before: one register read
    fewer), from ``cuobjdump -sass``; None where the toolkit has no
    cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    counts, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = dict(FFMA=0, FADD=0, FMUL=0, HMMA=0, HGMMA=0, STS=0, LDS=0, LDGSTS=0,
                              UTMALDG=0, STL=0, LDL=0, reuse=0)
            reuse = False
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", ln)
        if m and fn is not None and m.group(1) in counts[fn] and m.group(1) != "reuse":
            counts[fn][m.group(1)] += 1
            counts[fn]["reuse"] += m.group(1) == "FFMA" and reuse
            reuse = m.group(1) == "FFMA" and ".reuse" in ln
    return counts


def reduce_sass(so):
    """The reduction kernels' SASS counts (``sass_counts``): the partial
    sums' products on the tensor cores (HGMMA, wgmma's instruction, nonzero)
    and no FFMA anywhere in that kernel, so none in its product loop.
    Raises SystemExit otherwise, or without cuobjdump."""
    counts = sass_counts(so)
    if counts is None:
        raise SystemExit("cuobjdump not found: the reduction's SASS cannot be checked")
    for fn, c in counts.items():
        log(f"  sass {fn}: {c}")
    part = [c for fn, c in counts.items() if "pg_partial_kernel" in fn]
    if len(part) != 1 or part[0]["HGMMA"] == 0 or part[0]["FFMA"] != 0:
        raise SystemExit(f"pg_partial_kernel's SASS: {part}, expected HGMMA > 0 and no FFMA")


def check_equal(tag: str, got, want) -> float:
    """A gather copies bits: ``got`` equals ``want`` exactly (NaN in neither);
    returns the max abs error, 0. Raises SystemExit otherwise."""
    import torch

    ok = got.shape == want.shape and bool(torch.equal(got, want))
    log(f"  {tag}: bitwise equal to plain: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{tag} differs from its plain version")
    return 0.0


# (rows, indices, copies) of the column gather's ragged checks: a short last
# row block, T not a multiple of 4 (4-byte accesses), copies (4 rows a thread)
GATHER_COLS_RAGGED = ((481, 1023, 1), (480, 1024, 3), (37, 1000, 1), (5, 6, 2))


def profiler_alive(dev, after: str) -> tuple:
    """Device kernels that torch.profiler records, logged with the phase
    ``after`` which it runs, in three sessions: one small kernel; 100 of
    them; one, with 50 ms before the session ends. (The profiler has
    recorded no device kernel of a short session late in this script, and
    now and then early; see g2_split.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device=dev)
    x.add_(1)
    torch.cuda.synchronize()
    counts = []
    for n, wait in ((1, 0.0), (100, 0.0), (1, 0.05)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                x.add_(1)
            torch.cuda.synchronize()
            time.sleep(wait)
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    log(f"  torch.profiler after {after}: device kernels recorded of 1 add_ {counts[0]}, of 100 "
        f"{counts[1]}, of 1 with 50 ms before the session ends {counts[2]}")
    return tuple(counts)


def g2_split(dev, card: str) -> None:
    """p1's one call alone (the column gather at r2_pallas_caps.py's shape)
    timed two ways: as fma_gather_phase times it (graph_ms(fn, 1,
    replays=20): one call in a CUDA graph, best of 20 replays, the host's
    latency to launch the replay inside the events) and queued behind a
    spin on the device (one_call_queued_ms: the launch on the device and the
    kernel alone); each split into the launch floor (probe_empty_kernel
    timed the same way), the kernel's own duration (torch.profiler) and the
    rest, beside index_select's. Runs right after the build: torch.profiler
    has been seen to record no device activity late in this script (logged
    by profiler_alive after each phase). Raises if the profiler records no
    kernel of a call."""
    import torch

    from probe_ab import device_us
    from sevennet_tpu_torch.probes import gather as ga
    from sevennet_tpu_torch.probes._lib import graph_ms, one_call_queued_ms

    dx, w, t = ga.TABLE_SHAPE
    gen = torch.Generator(device="cpu").manual_seed(9)
    tbl = torch.randn(dx, w, generator=gen).to(dev)
    idx = torch.randint(0, w, (1, t), generator=gen, dtype=torch.int32).to(dev)
    out = torch.empty(dx, t, device=dev)
    check_equal(f"probe gather_cols {dx}x{w} T {t} (launch split)",
                ga.gather_cols(tbl, idx, out=out), ga.gather_cols_plain(tbl, idx))
    empty = lambda: ga.empty_launch(dev)  # noqa: E731
    floor = graph_ms(empty, 1, replays=20)
    floor_q = one_call_queued_ms(empty)
    floor_dur = sum(device_us(empty).values()) / 1e3
    log(f"  probe cols_one launch floor (an empty kernel, one call): {floor * 1e3:.3f} us, "
        f"queued {floor_q * 1e3:.3f} us, of which {floor_dur * 1e3:.3f} us the empty kernel's "
        f"own duration | {card}")
    # (the wrapper's index check, idx.min() and idx.max(), runs kernels of its own)
    for name, fn, key in (("gather_cols", lambda: ga.gather_cols(tbl, idx, out=out),
                           "probe_gather_cols"),
                          ("index_select", lambda: torch.index_select(tbl, 1, idx[0], out=out),
                           "")):
        t_one, t_q = graph_ms(fn, 1, replays=20), one_call_queued_ms(fn)
        ks = device_us(fn)
        dur = sum(us for k, us in ks.items() if key in k) / 1e3
        if dur == 0:
            raise SystemExit(f"{name}: torch.profiler saw no kernel {key!r} in one call: {ks}")
        log(f"  probe cols_one {name}: one call {t_one * 1e3:.3f} us (host latency in), queued "
            f"{t_q * 1e3:.3f} us = launch {(floor_q - floor_dur) * 1e3:.3f} us (the queued "
            f"floor less the empty kernel's duration) + kernel {dur * 1e3:.3f} us + rest "
            f"{(t_q - floor_q + floor_dur - dur) * 1e3:.3f} us (device kernels of a call: "
            f"{', '.join(f'{k} {us:.3f}' for k, us in ks.items())}) | {card}")


def fma_gather_phase(dev, card: str):
    """The FMA-rate and gather probes. First each kernel against its plain
    version at every shape of its TPU script (chains within fma_rate.TOL of
    max |plain|: F1 at mul 128, 64 and 32, F2 and F3; gathers bitwise: G1 in
    both variants with and without streaming stores, G2, G3 in both
    variants; launches not counted), then the probe path with the counts
    from 0, each site timed on the device alone by its script's method
    (CUDA graphs): F1 250 against 50 calls, F2, G2′ and G3 240 against 40,
    G1 16 against 4, F3 one graph of 8 calls, G2 one call alone; one copy,
    the contract, and the copies that fill the card (FMA probes: 16 K
    threads an SM; small gathers: a CTA or more an SM), the SM clock read
    before and after the FMA probes; beside them the plain versions and,
    for the gathers, index_select (into a preallocated output). Returns
    (records by kernels-line key, launches by key)."""
    import math

    import torch

    from sevennet_tpu_torch.probes import fma_rate as fr
    from sevennet_tpu_torch.probes import gather as ga
    from sevennet_tpu_torch.probes._lib import graph_ms

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device="cpu").manual_seed(9)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).to(dev)

    fma_in = {(lay, mul): tuple(rnd(*sh) for sh in fr.fma_shapes(lay, mul))
              for lay in fr.LAYOUTS for mul in sorted({*fr.CHAIN_MULS, fr.PASS_MUL})}
    va, vb = rnd(*fr.VPU_SHAPE), rnd(*fr.VPU_SHAPE)
    n, d, t_rows = ga.ROWS_SHAPE
    x, idx = rnd(n, d), ints(n, t_rows)
    dx, w, t_tab = ga.TABLE_SHAPE
    tbl_c, idx_c = rnd(dx, w), ints(w, 1, t_tab)  # p1: (DX, W), idx (1, T)
    tbl_r, idx_r = rnd(w, dx), ints(w, t_tab, 1)  # p2: (W, DX), idx (T, 1)

    errs = {}
    for lay in fr.LAYOUTS:
        for mul in fr.CHAIN_MULS:
            xx, tt = fma_in[(lay, mul)]
            errs[("chain", lay, mul)] = check_close(
                f"probe fma_chain {lay} mul {mul}", "out", fr.fma_chain(xx, tt, lay),
                fr.fma_chain(xx, tt, lay, plain=True), fr.TOL)
        xx, tt = fma_in[(lay, fr.PASS_MUL)]
        errs[("pass", lay)] = check_close(f"probe fma_pass {lay} mul {fr.PASS_MUL}", "out",
                                          fr.fma_pass(xx, tt, lay),
                                          fr.fma_pass(xx, tt, lay, plain=True), fr.TOL)
    errs["vpu"] = check_close(f"probe vpu_chain {fr.VPU_SHAPE}", "out", fr.vpu_chain(va, vb),
                              fr.vpu_chain(va, vb, plain=True), fr.TOL)
    want = ga.gather_rows_plain(x, idx)
    out = torch.empty_like(want)
    for v in ga.VARIANTS:
        for st in (True, False):
            out.fill_(float("nan"))
            errs[("rows", v, st)] = check_equal(
                f"probe gather_rows {v}{' stcs' if st else ''} {n}x{d} T {t_rows}",
                ga.gather_rows(x, idx, v, st, out=out), want)
    del want
    errs["cols"] = check_equal(f"probe gather_cols {dx}x{w} T {t_tab}",
                               ga.gather_cols(tbl_c, idx_c), ga.gather_cols_plain(tbl_c, idx_c))
    for rd, rt, rc in GATHER_COLS_RAGGED:
        tb, ix = rnd(rd, w), ints(w, 1, rt)
        o = torch.full((rd, rt) if rc == 1 else (rc, rd, rt), float("nan"), device=dev)
        check_equal(f"probe gather_cols {rd}x{w} T {rt} copies {rc} (plan "
                    f"{ga.cols_plan(rd, rt, rc, n_sm)})",
                    ga.gather_cols(tb, ix, copies=rc, out=o), ga.gather_cols_plain(tb, ix, rc))
    for v in ga.VARIANTS:
        errs[("small_rows", v)] = check_equal(f"probe gather_rows {v} {w}x{dx} T {t_tab}",
                                              ga.gather_rows(tbl_r, idx_r, v),
                                              ga.gather_rows_plain(tbl_r, idx_r))

    # the probe path, counts from 0
    for fn in (fr.fma_chain, fr.fma_pass):
        fn.launches, fn.by_layout = 0, dict.fromkeys(fr.LAYOUTS, 0)
    fr.vpu_chain.launches = ga.gather_cols.launches = ga.gather_rows.launches = 0
    ga.gather_rows.by_variant = dict.fromkeys(ga.VARIANTS, 0)
    recs, launches = {}, {}
    log(f"  SM clock before the FMA probes (now, max): {nvidia_smi('clocks.sm,clocks.max.sm')}")

    def fma_rec(key, fn, timer, xx, tt, lay, fl_one, nbytes, mul, **kw):
        fill = max(1, math.ceil(FILL_THREADS_PER_SM * n_sm / (xx.numel() // fr.E)))
        ms = timer(lambda: fn(xx, tt, lay, **kw))
        ms_fill = timer(lambda: fn(xx, tt, lay, copies=fill, **kw))
        rate, rate_fill = fl_one / ms / 1e9, fl_one * fill / ms_fill / 1e9
        log(f"  probe {fn.__name__} {lay} mul {mul}: {ms:.5f} ms per call, {rate:.2f} TFLOP/s "
            f"(1 copy, {xx.numel() // fr.E} threads); {fill} copies: {ms_fill:.5f} ms, "
            f"{rate_fill:.2f} TFLOP/s per card = {rate_fill / FP32_PEAK * 1e12:.1%} of "
            f"{FP32_PEAK / 1e12:.0f}, {rate_fill / n_sm * 1e3:.1f} GFLOP/s card rate / {n_sm} "
            f"SMs (derived) | {card}")
        if key is not None:
            plain = cuda_time(lambda: fn(xx, tt, lay, plain=True, **kw), 2)
            bnd = max((fl_one / FP32_PEAK * 1e3, "operations"),
                      (nbytes / HBM_BYTES_S * 1e3, "bytes"))
            recs[key] = dict(ms=ms, plain_ms=plain, bound=bnd, library_ms=None, err=errs[key],
                             name=f"{fn.__name__} {lay}-major (mul {mul}, T {fr.T})")

    for lay in fr.LAYOUTS:
        for mul in fr.CHAIN_MULS:
            xx, tt = fma_in[(lay, mul)]
            fma_rec(("chain", lay, mul) if mul == fr.CHAIN_MULS[0] else None, fr.fma_chain,
                    fr.fma_time, xx, tt, lay, fr.fma_flops(mul, fr.REP), fr.fma_bytes(mul), mul)
        xx, tt = fma_in[(lay, fr.PASS_MUL)]
        fma_rec(("pass", lay), fr.fma_pass, fr.pass_time, xx, tt, lay, fr.fma_flops(fr.PASS_MUL),
                fr.fma_bytes(fr.PASS_MUL), fr.PASS_MUL)
    fl, nbytes = fr.vpu_work(va.numel())
    ms = fr.vpu_time(lambda: fr.vpu_chain(va, vb))
    plain = cuda_time(lambda: fr.vpu_chain(va, vb, plain=True), 2)
    t_ops, t_bytes = fl / FP32_PEAK * 1e3, nbytes / HBM_BYTES_S * 1e3
    log(f"  probe vpu_chain {fr.VPU_SHAPE}: {ms:.5f} ms per call; {fl / ms / 1e9:.2f} TFLOP/s "
        f"counting FFMA and FADD 2 each ({t_ops / ms:.1%} of the fp32 bound {t_ops:.5f} ms), "
        f"{nbytes / ms / 1e6:.1f} GB/s ({t_bytes / ms:.1%} of the HBM bound {t_bytes:.5f} ms); "
        f"plain {plain:.4f} ms | {card}")
    recs["vpu"] = dict(ms=ms, plain_ms=plain, bound=max((t_ops, "operations"), (t_bytes, "bytes")),
                       library_ms=None, err=errs["vpu"], name=f"vpu_chain {fr.VPU_SHAPE}")
    log(f"  SM clock after the FMA probes (now, max): {nvidia_smi('clocks.sm,clocks.max.sm')}")
    for key, fn in (("chain", fr.fma_chain), ("pass", fr.fma_pass)):
        for lay in fr.LAYOUTS:
            launches[(key, lay, fr.CHAIN_MULS[0]) if key == "chain" else (key, lay)] = \
                fn.by_layout[lay]
    launches["vpu"] = fr.vpu_chain.launches

    # G1: SevenNet-0's x[src] at 9,999 atoms, into one preallocated output
    nbytes = ga.gather_bytes(x, idx, 0)
    bnd = (nbytes / HBM_BYTES_S * 1e3, "bytes")
    lib = ga.gather_time(lambda: torch.index_select(x, 0, idx, out=out))
    plain = cuda_time(lambda: ga.gather_rows_plain(x, idx), 2)
    for v in ga.VARIANTS:
        t_st = {}
        for st in (True, False):
            t_st[st] = ga.gather_time(lambda: ga.gather_rows(x, idx, v, st, out=out))
        log(f"  probe gather_rows {v} {n}x{d} T {t_rows}: {t_st[True]:.5f} ms with streaming "
            f"stores ({nbytes / t_st[True] / 1e6:.1f} GB/s, {bnd[0] / t_st[True]:.1%} of HBM), "
            f"{t_st[False]:.5f} ms without ({nbytes / t_st[False] / 1e6:.1f} GB/s); "
            f"index_select {lib:.5f} ms ({nbytes / lib / 1e6:.1f} GB/s); plain {plain:.4f} ms; "
            f"bound {bnd[0]:.5f} ms | {card}")
        recs[("rows", v)] = dict(ms=t_st[True], plain_ms=plain, bound=bnd, library_ms=lib,
                                 err=errs[("rows", v, True)],
                                 name=f"gather_rows {v}, streaming stores ({n}x{d}, T {t_rows})")
        launches[("rows", v)] = ga.gather_rows.by_variant[v]
    del out
    torch.cuda.empty_cache()

    # G2, G2', G3: the resident-table gathers, 3 MB a call
    out_c, out_r = torch.empty(dx, t_tab, device=dev), torch.empty(t_tab, dx, device=dev)
    sites = (
        ("cols_one", lambda **kw: ga.gather_cols(tbl_c, idx_c, **kw), tbl_c, idx_c, 1, out_c,
         lambda: torch.index_select(tbl_c, 1, idx_c[0], out=out_c),
         lambda: ga.gather_cols_plain(tbl_c, idx_c)),
        ("cols", lambda **kw: ga.gather_cols(tbl_c, idx_c, **kw), tbl_c, idx_c, 1, out_c,
         lambda: torch.index_select(tbl_c, 1, idx_c[0], out=out_c),
         lambda: ga.gather_cols_plain(tbl_c, idx_c)),
        ("small_rows", lambda **kw: ga.gather_rows(tbl_r, idx_r, **kw), tbl_r, idx_r, 0, out_r,
         lambda: torch.index_select(tbl_r, 0, idx_r[:, 0], out=out_r),
         lambda: ga.gather_rows_plain(tbl_r, idx_r)),
    )
    for key, fn, table, ix, axis, o, lib_fn, plain_fn in sites:
        before = (ga.gather_cols.launches, ga.gather_rows.launches)
        nbytes = ga.gather_bytes(table, ix, axis)
        if key == "cols_one":  # p1's single call: one launch alone, best of 20
            ms = graph_ms(lambda: fn(out=o), 1, replays=20)
            lib = graph_ms(lib_fn, 1, replays=20)
            fill, ms_fill = 1, ms
        else:
            ms = ga.gather_time(lambda: fn(out=o), ga.TABLE_TIMING)
            lib = ga.gather_time(lib_fn, ga.TABLE_TIMING)
            per_copy = (ga.cols_plan(dx, t_tab, 1, n_sm).ctas if axis == 1
                        else math.ceil(t_tab / 8))  # CTAs of one copy
            fill = max(1, math.ceil(2 * n_sm / per_copy))
            o_fill = torch.empty((fill, *o.shape), device=dev)
            ms_fill = ga.gather_time(lambda: fn(copies=fill, out=o_fill), ga.TABLE_TIMING)
            del o_fill
        plain = cuda_time(plain_fn, 5)
        bnd = (nbytes / HBM_BYTES_S * 1e3, "bytes")
        fill_bytes = ga.gather_bytes(table, ix, axis, fill)
        log(f"  probe {key} {tuple(table.shape)} T {ix.numel()}: {ms * 1e3:.3f} us per call "
            f"({nbytes / ms / 1e6:.1f} GB/s, {bnd[0] / ms:.1%} of HBM); {fill} copies "
            f"{ms_fill * 1e3:.3f} us ({fill_bytes / ms_fill / 1e6:.1f} GB/s); library "
            f"{lib * 1e3:.3f} us; plain {plain * 1e3:.3f} us; bound {bnd[0] * 1e3:.3f} us | {card}")
        recs[key] = dict(ms=ms, plain_ms=plain, bound=bnd, library_ms=lib,
                         err=errs["cols" if key.startswith("cols") else ("small_rows", "ldg")],
                         name=f"gather_{'cols' if axis else 'rows ldg'} ({tuple(table.shape)}, "
                              f"T {ix.numel()}){', one call alone' if key == 'cols_one' else ''}")
        launches[key] = (ga.gather_cols.launches + ga.gather_rows.launches) - sum(before)
    if not all(launches.values()):
        raise SystemExit(f"an FMA or gather probe kernel was never launched on the probe path: "
                         f"{launches}")
    log(f"  FMA and gather probes: peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del x, idx, va, vb
    torch.cuda.empty_cache()
    return recs, launches


# (K, A, tiles of mul rows, blocks): DM 800, DX 100; the second and third
# maps read input columns in even-aligned pairs (the mxu kernel's 8-byte
# loads) and aligned runs of 4 (the roll kernel's 16-byte loads), the first
# neither
FOLD_RAGGED = ((9, 16, (100,) * 8, 3), (8, 32, (64,) * 12 + (32,), 3),
               (72, 32, (64,) * 12 + (32,), 6))


def fold_inputs(rnd, dev):
    """The fold's input at r3_fold_probe.py's shape, x (NB T, DM / 8), 1.154
    GB, the 0/1 fold matrix and an output buffer."""
    import torch

    from sevennet_tpu_torch.probes import fold as fo

    fx = rnd(fo.N // fo.A * fo.A * fo.K, fo.DM // 8, scale=0.5)
    return fx, fo.fold_matrix(fo.K, fo.A, dev), torch.empty(fo.N, fo.DM, device=dev)


def fold_check(fx, fm, out_f):
    """Every fold variant against its plain version (fold.TOL of max
    |plain|) at the script's shape, the mxu variants also printed against
    roll as the script prints them; launches not counted. Returns the
    errors by kernels-line key."""
    import torch

    from sevennet_tpu_torch.probes import fold as fo

    errs, roll = {}, None
    for v in fo.VARIANTS:
        want = fo.fold(fx, fm, variant=v, plain=True)
        errs[("fold", v)] = check_close(f"probe fold {v} {tuple(fx.shape)}", "out",
                                        fo.fold(fx, fm, variant=v, out=out_f), want, fo.TOL)
        if v == "roll":
            roll = out_f.clone()
        elif v != "bigroll":
            rel = float((out_f - roll).abs().max()) / float(roll.abs().max())
            log(f"  probe fold {v} max rel err vs roll: {rel:.2e}")
        del want
    del roll
    torch.cuda.empty_cache()
    return errs


def fold_ragged_check(dev):
    """Every fold variant against plain (fold.TOL of max |plain|) at
    FOLD_RAGGED: DM 800, DX 100, at A 16 and K 9, and at A 32 and K 8 and 72
    (192 receivers: more than the card's SMs, so that a CTA folds two). The
    mxu variants there run 13 m64 tiles, the last half empty, on a cluster
    of 2 CTAs (at A 16 the n32 product's upper columns zero), with a random
    fold matrix, not 0/1 (the kernel reads its argument; rounded to bf16 on
    both sides, as the kernel rounds it); roll and bigroll run 2 slices of
    fold.ROLL_SW columns, the last partial, with the first map's units a
    column each (its runs are not on the 4-column grid) and 4-column runs
    otherwise."""
    import torch

    from sevennet_tpu_torch.probes import fold as fo

    gen = torch.Generator(device="cpu").manual_seed(12)
    for k, a, muls, nb in FOLD_RAGGED:
        x = (torch.randn(nb * a * k, sum(muls) // 8, generator=gen) * 0.5).to(dev)
        fm = torch.randn(k * a, a, generator=gen).to(torch.bfloat16).float().to(dev)
        plan = fo.mma_plan(x.shape[1], sum(muls), a)
        for v in fo.VARIANTS:
            rp = fo.roll_plan(fo.column_map(v, muls), x.shape[1], k)
            desc = (f"plan {plan}" if fo.PIECES[v] else
                    f"{rp.nsl} slices of {rp.sw}, {'4-column runs' if rp.vec else 'columns'}")
            check_close(f"probe fold {v} K {k} A {a} DM {sum(muls)}, {desc}", "out",
                        fo.fold(x, fm, k, a, v, muls), fo.fold(x, fm, k, a, v, muls, plain=True),
                        fo.TOL)


def fold_cancel_check(out_f, dev):
    """mxu3 against plain (fold.TOL of max |plain|) on fold.cancelling_input
    with the 0/1 fold matrix, at the script's shape and at FOLD_RAGGED's:
    there the fold lives in x's lower bf16 pieces, and plain mxu2 (2
    pieces) misses it by more than 10 fold.TOL, which is checked too, so
    that a kernel without its third piece fails. Launches not counted."""
    import torch

    from sevennet_tpu_torch.probes import fold as fo

    shapes = ((fo.K, fo.A, fo.MULS, fo.N // fo.A),) + FOLD_RAGGED
    for k, a, muls, nb in shapes:
        dm = sum(muls)
        x = fo.cancelling_input(nb, k, a, dm // 8, 17, dev)
        fm = fo.fold_matrix(k, a, dev)
        out = out_f if dm == fo.DM and nb * a == fo.N else None
        want = fo.fold(x, fm, k, a, "mxu3", muls, plain=True)
        gap = float((fo.fold(x, fm, k, a, "mxu2", muls, plain=True) - want).abs().max())
        gap /= float(want.abs().max())
        tag = f"probe fold mxu3 K {k} A {a} DM {dm}, cancelling input"
        log(f"  {tag}: plain mxu2 off by {gap:.3e} of max |plain|")
        if not gap > 10 * fo.TOL:
            raise SystemExit(f"{tag}: plain mxu2 within {gap:.3e}: the input does not "
                             "hold the third piece to its share")
        check_close(tag, "out", fo.fold(x, fm, k, a, "mxu3", muls, out=out), want, fo.TOL)
        del x, want
    torch.cuda.empty_cache()


def fold_conv_order_check(dev, ws, w3j):
    """Each conv fold variant against its own variant's plain version
    (fold_conv.TOL of max |plain|) on fold_conv.cancelling_input at the
    script's layer and K (256 receivers), where the plain variants are more
    than 10 fold_conv.TOL from each other, which is checked too: a kernel
    that sums in another order than its variant's fails. Launches not
    counted."""
    import torch

    from sevennet_tpu_torch.probes import fold_conv as fcv

    conv, _ = fcv.sevennet0_conv()
    xg, emb, sh = fcv.cancelling_input(256, fcv.K, conv, 29, dev)
    plain = {v: fcv.fold_conv(conv, xg, emb, sh, ws, w3j, fcv.K, v, plain=True)
             for v in fcv.VARIANTS}
    tag = f"probe fold_conv K {fcv.K}, cancelling input"
    for i, a in enumerate(fcv.VARIANTS):
        for b in fcv.VARIANTS[i + 1:]:
            gap = float((plain[a] - plain[b]).abs().max()) / float(plain[a].abs().max())
            log(f"  {tag}: plain {a} and {b} {gap:.3e} of max |plain| apart")
            if not gap > 10 * fcv.TOL:
                raise SystemExit(f"{tag}: plain {a} and {b} within {gap:.3e}: the input does not "
                                 "tell the orders apart")
    for v in fcv.VARIANTS:
        check_close(f"{tag} {v}", "out", fcv.fold_conv(conv, xg, emb, sh, ws, w3j, fcv.K, v),
                    plain[v], fcv.TOL)
    del xg, emb, sh, plain


def fold_floor_ms(v: str, nb: int) -> float:
    """The mxu design's tensor-core floor: its dense bf16 product, 2 A T DM
    multiply-adds a block and piece (the TPU's MXU product, not the
    function's work), at BF16_PEAK; 0 for roll and bigroll."""
    from sevennet_tpu_torch.probes import fold as fo

    return 2 * fo.A * fo.K * fo.A * fo.DM * nb * fo.PIECES[v] / BF16_PEAK * 1e3


def fold_time(fx, fm, out_f, errs, card):
    """Each fold variant timed by the script's method (diff_ms at FOLD_TIME,
    CUDA graphs) beside the function in two PyTorch calls (torch.sum over K,
    then torch.index_select by the column map; the kernels line's
    library_ms) and torch.sum over K alone (the fold without its map),
    its plain version, the function's bound and the mxu design's
    tensor-core floor. Returns records by kernels-line key."""
    from sevennet_tpu_torch.probes import fold as fo
    from sevennet_tpu_torch.probes._lib import FOLD_TIME, diff_ms

    import torch

    nb = fo.N // fo.A
    lib_sum = diff_ms(lambda: fx.view(nb, fo.K, fo.A, -1).sum(1), *FOLD_TIME)
    fl, nbytes = fo.fold_work(nb)
    bnd = bound_ms(fl, nbytes)
    recs = {}
    for v in fo.VARIANTS:
        ms = diff_ms(lambda: fo.fold(fx, fm, variant=v, out=out_f), *FOLD_TIME)
        plain = cuda_time(lambda: fo.fold(fx, fm, variant=v, plain=True), 3)
        cmap = torch.as_tensor(fo.column_map(v), dtype=torch.long, device=fx.device)
        lib = diff_ms(lambda: torch.index_select(fx.view(nb, fo.K, fo.A, -1).sum(1), 2, cmap),
                      *FOLD_TIME)
        floor = (f"; tensor-core floor {fold_floor_ms(v, nb):.4f} ms (bf16 at 989 TFLOP/s)"
                 if fo.PIECES[v] else "")
        log(f"  probe fold {v} {tuple(fx.shape)} -> {tuple(out_f.shape)}: {ms:.4f} ms per call "
            f"({nbytes / ms / 1e6:.1f} GB/s, {bnd[0] / ms:.1%} of the bound); the function in "
            f"two calls (torch.sum over K, torch.index_select by the column map) {lib:.4f} ms "
            f"({ms / lib:.3f}x); torch.sum over K alone (no column map) {lib_sum:.4f} ms; "
            f"plain {plain:.4f} ms; bound {bnd[0]:.4f} ms by {bnd[1]}{floor} | {card}")
        recs[("fold", v)] = dict(ms=ms, plain_ms=plain, bound=bnd, library_ms=lib,
                                 library_sum_ms=lib_sum, err=errs[("fold", v)],
                                 name=f"fold {v} (N {fo.N}, K {fo.K}, DM {fo.DM})")
    return recs


# a round-trip thread's shared stores and loads at pad 0
# (csrc/probe_xpose.cu:probe_xpose_rt_kernel): the first transpose 4 float4
# stores by rows and 16 loads by columns, the second 16 stores and 16 loads
XPOSE_RT_SASS = dict(STS=4 + 16, LDS=16 + 16)


def xpose_sass(so):
    """The pad-0 round trip's SASS counts (``sass_counts``): both instances
    of probe_xpose_rt_kernel (16-byte and 4-byte global accesses) keep the
    shared-memory stores and loads of two transposes (at least
    XPOSE_RT_SASS), so that neither the compiler nor the design has made the
    round trip a copy. Raises SystemExit otherwise, or without cuobjdump."""
    counts = sass_counts(so)
    if counts is None:
        raise SystemExit("cuobjdump not found: the transpose kernels' SASS cannot be checked")
    rt = {fn: c for fn, c in counts.items() if "probe_xpose_rt_kernel" in fn}
    for fn, c in rt.items():
        log(f"  sass {fn}: STS {c['STS']}, LDS {c['LDS']} (two transposes: at least "
            f"{XPOSE_RT_SASS})")
    if len(rt) != 2 or not all(c[k] >= v for c in rt.values() for k, v in XPOSE_RT_SASS.items()):
        raise SystemExit(f"probe_xpose_rt_kernel's SASS: {rt}, expected two instances with at "
                         f"least {XPOSE_RT_SASS} shared stores and loads")


def mm_sass(so) -> dict:
    """The matmul kernels' SASS counts (``sass_counts``). The 3xTF32
    kernel's four instances (3xtf32 and 3xtf32_presplit, with and without
    the carry) run their products on wgmma (HGMMA > 0) and none on mma.sync
    (HMMA 0). The instances of probe_mm_ffma_kernel (with and without the
    carry, 64- and 32-row tiles) and probe_mm_tc_kernel (tf32, wgmma_tf32,
    bf16, with and without the carry) keep each variant's instruction: ffma
    FFMA and no tensor-core instruction, tf32 and bf16 HMMA and no HGMMA,
    wgmma_tf32 HGMMA and no HMMA, and ptxas may not report its wgmma
    serialized.
    Spills and ptxas's advisories are printed. Returns HGMMA by instance.
    Raises SystemExit otherwise, or without cuobjdump."""
    import re

    from sevennet_tpu_torch.probes import mm_rate as mr

    counts = sass_counts(so)
    if counts is None:
        raise SystemExit("cuobjdump not found: the matmul kernels' SASS cannot be checked")
    mma = {fn: c for fn, c in counts.items() if "probe_mm3x_kernel" in fn}
    one = []  # (variant, carry, function, counts)
    for fn, c in counts.items():
        m = re.search(r"probe_mm_tc_kernelILi(\d)ELb([01])ELi\d+E", fn)
        if m:
            one.append((mr.VARIANTS[int(m[1])], m[2] == "1", fn, c))
        m = re.search(r"probe_mm_ffma_kernelILb([01])ELi\d+E", fn)
        if m:
            one.append(("ffma", m[1] == "1", fn, c))
    for fn, c in [*mma.items(), *((fn, c) for _, _, fn, c in one)]:
        log(f"  sass {fn}: FFMA {c['FFMA']}, HGMMA {c['HGMMA']}, HMMA {c['HMMA']}, "
            f"LDS {c['LDS']}, STL {c['STL']}, LDL {c['LDL']}")
    serialized = []
    for ln in open(str(so) + ".log"):
        if "serialized" in ln or "Performance" in ln:
            log(f"  ptxas: {ln.strip()}")
            if "serialized" in ln:
                serialized.append(ln)
    if len(mma) != 4 or not all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in mma.values()):
        raise SystemExit(f"probe_mm3x_kernel's SASS: {mma}, expected four instances with "
                         "HGMMA > 0 and no HMMA")
    want = {"ffma": lambda c: c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0,
            "tf32": lambda c: c["HMMA"] > 0 and c["HGMMA"] == 0,
            "bf16": lambda c: c["HMMA"] > 0 and c["HGMMA"] == 0,
            "wgmma_tf32": lambda c: c["HGMMA"] > 0 and c["HMMA"] == 0}
    if ({(v, cr) for v, cr, _, _ in one} != {(v, cr) for v in want for cr in (False, True)}
            or not all(want[v](c) for v, _, _, c in one)):
        raise SystemExit(f"probe_mm's SASS: {[(v, cr, c) for v, cr, _, c in one]}, expected "
                         "every variant with and without the carry: ffma FFMA only, tf32 and "
                         "bf16 HMMA without HGMMA, wgmma_tf32 HGMMA without HMMA")
    for v, _, fn, _ in one:
        if v == "wgmma_tf32" and any(fn in ln for ln in serialized):
            raise SystemExit(f"ptxas serialized {fn}'s wgmma")
    return {fn: c["HGMMA"] for fn, c in [*mma.items(), *((fn, c) for _, _, fn, c in one)]}


def fold_sass(so):
    """The fold kernels' SASS counts (``sass_counts``): every instance of
    probe_fold_mma_kernel (2 and 3 pieces, with and without paired loads)
    runs its products on wgmma (HGMMA > 0) and none on mma.sync (HMMA 0);
    every instance of probe_fold_roll_kernel (K 8, 9, 72, by columns and by
    4-column runs) copies by TMA (UTMALDG > 0), adds (FADD > 0) and spills
    nothing (STL, LDL 0); ptxas's advisories that it serialized
    wgmma are printed. Raises SystemExit otherwise, or without
    cuobjdump."""
    counts = sass_counts(so)
    if counts is None:
        raise SystemExit("cuobjdump not found: the fold kernels' SASS cannot be checked")
    mma = {fn: c for fn, c in counts.items() if "probe_fold_mma_kernel" in fn}
    for fn, c in mma.items():
        log(f"  sass {fn}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}")
    for ln in open(str(so) + ".log"):
        if "serialized" in ln or "Performance" in ln:
            log(f"  ptxas: {ln.strip()}")
    ok = len(mma) >= 2 and all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in mma.values())
    if not ok:
        raise SystemExit(f"probe_fold_mma_kernel's SASS: {mma}, expected its instances with "
                         "HGMMA > 0 and no HMMA")
    roll = {fn: c for fn, c in counts.items() if "probe_fold_roll_kernel" in fn}
    for fn, c in roll.items():
        log(f"  sass {fn}: LDS {c['LDS']}, FADD {c['FADD']}, UTMALDG {c['UTMALDG']}, STL "
            f"{c['STL']}, LDL {c['LDL']}")
    if len(roll) != 6 or not all(c["UTMALDG"] > 0 and c["FADD"] > 0 and c["STL"] == 0
                                 and c["LDL"] == 0 for c in roll.values()):
        raise SystemExit(f"probe_fold_roll_kernel's SASS: {roll}, expected 6 instances with "
                         "UTMALDG and FADD and no STL or LDL")


def fold_probe(dev, card: str, so) -> None:
    """``--fold-probe``: the fold probe alone (``probes/fold.py``). Its
    SASS (``fold_sass``), the mxu plan and how many of its clusters the
    card holds at once, every variant against plain at the script's shape
    and at FOLD_RAGGED, then each variant timed as in the
    whole run (``fold_time``)."""
    import torch

    from sevennet_tpu_torch.ops import kernels
    from sevennet_tpu_torch.probes import fold as fo

    fold_sass(so)
    plan = fo.mma_plan(fo.DM // 8, fo.DM, fo.A)
    lib = kernels.library("probe_fold")
    held = {cl: lib.probe_fold_clusters(cl, plan.ns, plan.nbox, plan.W)
            for cl in range(1, fo.MMA_CLMAX + 1)}
    log(f"  mxu plan {plan}: clusters of 1-{fo.MMA_CLMAX} CTAs resident at once {held}")
    gen = torch.Generator(device="cpu").manual_seed(10)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    fx, fm, out_f = fold_inputs(rnd, dev)
    errs = fold_check(fx, fm, out_f)
    fold_ragged_check(dev)
    fold_cancel_check(out_f, dev)
    fold_time(fx, fm, out_f, errs, card)


# the transposes' ragged inputs (shape, offset in floats): a tile row and
# column cut short, the pad-0 round trip's 4-byte path (C % 4 != 0, and a
# pointer off the 16-byte grid) and its 16-byte path with a partial block
XPOSE_RAGGED = (((70, 45), 0), ((33, 132), 1), ((40, 132), 0))


def reduce_fold_xpose_phase(dev, card: str):
    """The K-reduction, transpose and fold probes (``probes/reduce.py``,
    ``probes/xpose.py``, ``probes/fold.py``, ``probes/fold_conv.py``). First
    each kernel and variant against its plain version at every shape of its
    TPU script (sums within 1e-5 of max |plain|, the conv fold 1e-4, the
    streamed transposes bitwise, the carried one 1e-6; the transposes also at
    XPOSE_RAGGED, every mode and variant; kreduce also on an
    input whose carry crosses CTAs; the fold's mxu variants printed against
    roll as the script prints them; the conv fold against B4 fwd on the same
    x[src], 1e-4 of max |B4|, and each variant on fold_conv.cancelling_input
    against its own variant's plain version (fold_conv_order_check);
    launches not counted), then the probe path
    with the counts from 0: each timed by its script's method on the device
    alone (CUDA graphs: the r2 sites 250 against 50 calls, the fold sites 9
    against 3, the streamed transposes 8 calls over 8), beside the plain
    versions and the library calls (16 torch.sum over the reshaped K axis in
    one graph; 16 x.t().contiguous(); x.t().contiguous(); x.clone();
    torch.sum over K then torch.index_select by the column map for the fold,
    and torch.sum over K alone beside it; every plain
    version warm, the mean of 3 or 5 calls after one). Bounds: each
    function's own work, whatever the method (the fold's K - 1 adds a
    column for every variant; the conv fold the work of B4 fwd's function,
    products at the 3xTF32 rate as B4's bound counts them). Returns (records
    by kernels-line key, launches by key)."""
    import torch

    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.probes import fold as fo
    from sevennet_tpu_torch.probes import fold_conv as fcv
    from sevennet_tpu_torch.probes import reduce as rd
    from sevennet_tpu_torch.probes import xpose as xp
    from sevennet_tpu_torch.probes._lib import FOLD_TIME, R2_TIME, diff_ms

    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device="cpu").manual_seed(10)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    s_chk = torch.full((1, 1), 1e-3, device=dev)  # checks: the (1 + s i) factor moves
    s = torch.zeros((1, 1), device=dev)  # timing: the TPU scripts' s (r2_pallas_mm.py:97)
    red_in = {("kreduce", m): rnd(rd.T, m) for m in rd.KREDUCE_MULS}
    red_in.update({("subreduce", m): rnd(rd.T, m) for m in rd.SUB_MULS})
    red_in.update({("lanereduce", r): rnd(r, rd.A * rd.LANE_K) for r in rd.LANE_ROWS})
    red_fn = {"kreduce": lambda x, ss, **kw: rd.kreduce(x, **kw),
              "subreduce": lambda x, ss, **kw: rd.subreduce(x, ss, **kw),
              "lanereduce": lambda x, ss, **kw: rd.lanereduce(x, ss, **kw)}
    errs = {}
    for (kind, n), x in red_in.items():
        err = check_close(f"probe {kind} {tuple(x.shape)}", "out", red_fn[kind](x, s_chk),
                          red_fn[kind](x, s_chk, plain=True), rd.TOL)
        errs[kind] = max(errs.get(kind, 0.0), err)
    xc = red_in[("kreduce", rd.KREDUCE_MULS[-1])].clone()
    xc[: rd.T // rd.A, 0] = 1e8  # acc[0, 0] grows by about K a rep; 98 CTAs recompute it
    got, want = rd.kreduce(xc), rd.kreduce(xc, plain=True)
    errs["kreduce"] = max(errs["kreduce"], check_close(
        f"probe kreduce carried across CTAs {tuple(xc.shape)}", "out", got, want, rd.TOL),
        check_close(f"probe kreduce carried across CTAs {tuple(xc.shape)}", "columns 1:",
                    got[:, 1:], want[:, 1:], rd.TOL))
    del xc, got, want
    car_in = {shape: rnd(*shape) for shape in xp.CARRY_SHAPES}
    for v in xp.VARIANTS:
        for shape, a in car_in.items():
            err = check_close(f"probe transpose {v} {shape}", "out",
                              xp.transpose_carry(a, s_chk, v),
                              xp.transpose_carry(a, s_chk, v, plain=True), xp.CARRY_TOL)
            errs[("transpose", v)] = max(errs.get(("transpose", v), 0.0), err)
    for shape, off in XPOSE_RAGGED:
        a = rnd(shape[0] * shape[1] + off)[off:].view(*shape)  # off: not 16-byte aligned
        for v in xp.VARIANTS:
            tag = f"probe transpose {v} {shape}{' at a 4-byte offset' if off else ''}"
            errs[("transpose", v)] = max(errs[("transpose", v)], check_close(
                tag, "out", xp.transpose_carry(a, s_chk, v),
                xp.transpose_carry(a, s_chk, v, plain=True), xp.CARRY_TOL))
            for key, fn in (("xpose", xp.xpose), ("xpose2", xp.xpose2)):
                o = torch.full(fn(a, v, plain=True).shape, float("nan"), device=dev)
                check_equal(f"probe {key} {v} {shape}{' at a 4-byte offset' if off else ''}",
                            fn(a, v, out=o), fn(a, v, plain=True))
    xs = rnd(*xp.STREAM_SHAPE, scale=0.3)
    out_t = torch.empty(xs.shape[1], xs.shape[0], device=dev)
    out_s = torch.empty_like(xs)
    for v in xp.VARIANTS:
        for key, fn, o in (("xpose", xp.xpose, out_t), ("xpose2", xp.xpose2, out_s)):
            o.fill_(float("nan"))
            errs[(key, v)] = check_equal(f"probe {key} {v} {xp.STREAM_SHAPE}", fn(xs, v, out=o),
                                         fn(xs, v, plain=True))
    torch.cuda.empty_cache()

    fx, fm, out_f = fold_inputs(rnd, dev)
    errs.update(fold_check(fx, fm, out_f))
    fold_ragged_check(dev)
    fold_cancel_check(out_f, dev)

    # the conv fold at r4_fold_probe.py's shape, and B4 fwd on the same x[src]
    conv, mlp = fcv.sevennet0_conv()
    n, k = fcv.N, fcv.K
    x = rnd(n, conv.irreps_x.dim, scale=0.5)
    src = torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32).to(dev)
    xg = x[src.reshape(-1).long()].contiguous()
    emb, sh = rnd(n * k, mlp.dims[0], scale=0.3), rnd(n * k, conv.irreps_filter.dim, scale=0.5)
    ws = [rnd(a, b) for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    w3j = torch.as_tensor(fcv._tables(conv)[1], device=dev)
    op = fc.conv_op(conv, mlp, None)
    b4 = fc.fused_conv_fwd_embsh(op, x, src, emb, sh, ws)
    for v in fcv.VARIANTS:
        got = fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v)
        want = fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v, plain=True)
        errs[("fold_conv", v)] = check_close(f"probe fold_conv {v} N {n} K {k}", "out", got,
                                             want, fcv.TOL)
        del want
        check_close(f"probe fold_conv {v} N {n} K {k}", "against B4 fwd", got, b4, fcv.TOL)
        del got
    fold_conv_order_check(dev, ws, w3j)
    torch.cuda.empty_cache()

    # the probe path, counts from 0
    for fn in (rd.kreduce, rd.subreduce, rd.lanereduce):
        fn.launches = 0
    for mod, fns in ((xp, (xp.transpose_carry, xp.xpose, xp.xpose2)), (fo, (fo.fold,)),
                     (fcv, (fcv.fold_conv,))):
        for fn in fns:
            fn.launches, fn.by_variant = 0, dict.fromkeys(mod.VARIANTS, 0)
    recs = {}
    first = {"kreduce": rd.KREDUCE_MULS[0], "subreduce": rd.SUB_MULS[0],
             "lanereduce": rd.LANE_ROWS[0]}  # the kernels line's shape: the script's first
    for (kind, n_), xr in red_in.items():
        k_ = (xr.shape[0] if kind != "lanereduce" else xr.shape[1]) // rd.A
        ms = diff_ms(lambda: red_fn[kind](xr, s), *R2_TIME)
        view = (xr.view(rd.A, k_, -1), 1) if kind != "lanereduce" else (xr.view(-1, rd.A, k_), 2)
        lib = diff_ms(lambda: [view[0].sum(view[1]) for _ in range(rd.REP)], *R2_TIME)
        plain = cuda_time(lambda: red_fn[kind](xr, s, plain=True), 5)
        n_out = rd.A * xr.shape[1] if kind != "lanereduce" else xr.shape[0] * rd.A
        fl, nbytes = rd.reduce_work(xr.numel(), n_out)
        bnd = bound_ms(fl, nbytes)
        log(f"  probe {kind} {tuple(xr.shape)} K {k_}: {ms * 1e3:.3f} us per call "
            f"({ms * 1e3 / rd.REP:.3f} us per reduce, {nbytes / ms / 1e6:.1f} GB/s); 16 torch.sum "
            f"{lib * 1e3:.3f} us; plain {plain:.4f} ms; bound {bnd[0] * 1e3:.3f} us by {bnd[1]} | "
            f"{card}")
        if n_ == first[kind]:
            recs[kind] = dict(ms=ms, plain_ms=plain, bound=bnd, library_ms=lib, err=errs[kind],
                              name=f"{kind} {tuple(xr.shape)}, K {k_}, REP {rd.REP}")
    for shape, a in car_in.items():
        lib = diff_ms(lambda: [a.t().contiguous() for _ in range(xp.REP)], *R2_TIME)
        plain = cuda_time(lambda: xp.transpose_carry(a, s, plain=True), 5)
        fl, nbytes = xp.xpose_work(a.numel(), carried=True)
        bnd = bound_ms(fl, nbytes)
        for v in xp.VARIANTS:
            ms = diff_ms(lambda: xp.transpose_carry(a, s, v), *R2_TIME)
            log(f"  probe transpose {v} {shape}: {ms * 1e3:.3f} us per call "
                f"({ms * 1e3 / xp.REP:.3f} us per transpose); 16 x.t().contiguous() "
                f"{lib * 1e3:.3f} us; plain {plain:.4f} ms; bound {bnd[0] * 1e3:.3f} us by "
                f"{bnd[1]} | {card}")
            if shape == xp.CARRY_SHAPES[0]:
                recs[("transpose", v)] = dict(
                    ms=ms, plain_ms=plain, bound=bnd, library_ms=lib, err=errs[("transpose", v)],
                    name=f"transpose {v} {shape}, REP {xp.REP}")
    nbytes = xp.xpose_work(xs.numel())[1]
    bnd = bound_ms(0, nbytes)
    for key, fn, o, lib_fn in (("xpose", xp.xpose, out_t, lambda: xs.t().contiguous()),
                               ("xpose2", xp.xpose2, out_s, lambda: xs.clone())):
        lib = xp.stream_time(lib_fn)
        plain = cuda_time(lambda: fn(xs, plain=True), 3)
        for v in xp.VARIANTS:
            ms = xp.stream_time(lambda: fn(xs, v, out=o))
            log(f"  probe {key} {v} {xp.STREAM_SHAPE}: {ms:.5f} ms per call "
                f"({nbytes / ms / 1e6:.1f} GB/s, {bnd[0] / ms:.1%} of HBM); library "
                f"{lib:.5f} ms; plain {plain:.4f} ms; bound {bnd[0]:.5f} ms | {card}")
            recs[(key, v)] = dict(ms=ms, plain_ms=plain, bound=bnd, library_ms=lib,
                                  err=errs[(key, v)], name=f"{key} {v} {xp.STREAM_SHAPE}")
    del xs, out_t, out_s
    torch.cuda.empty_cache()
    recs.update(fold_time(fx, fm, out_f, errs, card))
    del fx, out_f
    torch.cuda.empty_cache()
    fl, nbytes = fcv.fold_conv_work(conv, mlp.dims, n, k)
    bnd = bound_ms(fl, nbytes, fl)  # as work("fwd_embsh") bounds B4 fwd: products at 3xTF32
    for v in fcv.VARIANTS:
        occ = fcv.occupancy(conv, mlp.dims, k, v, dev)
        log(f"  probe fold_conv {v} K {k}: {occ['smem']} B of shared memory a CTA, "
            f"{occ['ctas_per_sm']} CTAs an SM, {occ['registers']} registers, "
            f"{occ['local_bytes']} B local a thread | {card}")
    b4_ms = cuda_time(lambda: fc.fused_conv_fwd_embsh(op, x, src, emb, sh, ws), 3)
    for v in fcv.VARIANTS:
        ms = diff_ms(lambda: fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v), *FOLD_TIME)
        plain = cuda_time(lambda: fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v, plain=True), 3)
        log(f"  probe fold_conv {v} N {n} K {k}: {ms:.4f} ms per call ({fl / ms / 1e9:.2f} "
            f"TFLOP/s, {bnd[0] / ms:.1%} of the bound {bnd[0]:.4f} ms by {bnd[1]}); B4 fwd on "
            f"x[src] {b4_ms:.4f} ms; plain {plain:.4f} ms | {card}")
        recs[("fold_conv", v)] = dict(ms=ms, plain_ms=plain, bound=bnd, library_ms=None,
                                      err=errs[("fold_conv", v)],
                                      name=f"fold_conv {v} (SevenNet-0 layer, N {n}, K {k})")
    launches = {"kreduce": rd.kreduce.launches, "subreduce": rd.subreduce.launches,
                "lanereduce": rd.lanereduce.launches}
    for key, fn in (("transpose", xp.transpose_carry), ("xpose", xp.xpose),
                    ("xpose2", xp.xpose2), ("fold", fo.fold), ("fold_conv", fcv.fold_conv)):
        launches.update({(key, v): c for v, c in fn.by_variant.items()})
    if not all(launches.values()):
        raise SystemExit(f"a reduction, transpose or fold probe kernel was never launched on the "
                         f"probe path: {launches}")
    log(f"  reduction, transpose and fold probes: peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del x, src, xg, emb, sh, ws, b4
    torch.cuda.empty_cache()
    return recs, launches


BD_LIBS = ("probe_breakdown", "probe_breakdown_k", "probe_breakdown_feat", "probe_knockout")
# the conv variant each breakdown variant's saving is taken against (else full)
BD_FULL = {"mlp_hi": "full_hi", "full_hi": "full_hi", "feat_full": "feat_full",
           "feat_transpose": "feat_full", "featroll_full": "featroll_full",
           "featroll_mlp": "featroll_full"}


def bd_bound(flops: float, nbytes: float, one_pass: float):
    """(ms, bound_by) of a breakdown variant: its products at 3xTF32 (165
    TFLOP/s) as B4 fwd's bound counts them, those it runs in one TF32 pass
    (``one_pass``) at 495, against its bytes at HBM rate."""
    t_ops = (one_pass / TF32_PEAK + (flops - one_pass) / TC_3XTF32_PEAK) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def edge_ffma_floor(paths) -> int:
    """The FFMAs of the per-edge product's terms (``paths``:
    ``fold_conv.path_list()``) in an instantiation that compiles every path
    at the three lane widths, a step forming 4 values of each p a lane
    (tpred, nofold): 4 a pair, a path and a width. Fewer in its SASS means
    ptxas dropped terms."""
    return 3 * 4 * sum(bin(mask).count("1") for _, _, mask in paths)


def edge_sts_floor(paths) -> int:
    """nofold's 16-byte staging stores a step, one a p, at every path and
    lane width."""
    return 3 * sum(d3 for _, d3, _ in paths)


def breakdown_sass(libs):
    """HMMA, FFMA, FADD and STS of every breakdown instantiation
    (``cuobjdump``), printed, and the checks that each knock-out removed its
    phase's tensor-core instructions and kept the rest: one TF32 pass is a
    third of 3xTF32's HMMAs (mlp against mlp_hi; full against the MLP, W3
    and tmp of notp at a third plus the uvu product's), nomlp is B4 (ko
    full) without the MLP and W3 (mlp_hi's), nothing is nomlp without the
    uvu product, transpose runs no arithmetic; and that the per-edge uvu
    product (``probe_breakdown.cuh:uvu_edges``) forms every edge's messages
    on the CUDA cores: no HMMA in tpred and nofold beyond their loop's (tmp's,
    notp's), the same FFMAs in both beyond the loop's, at least every
    path's terms at every lane width once (``edge_ffma_floor``: ptxas
    drops arithmetic whose result nothing reads, and nofold's messages are
    read by nothing but their stores), nofold's staging stores beyond
    notp's, at least one a p of every path and width; and the 0/1 sums' two
    TF32 passes (HMMA beyond tmp's, the same in tpredmm and fullmm, even;
    feat_full's beyond featroll_mlp's even, featroll_full's none). Returns
    the counts by variant name, None without cuobjdump."""
    import re

    from sevennet_tpu_torch.probes.fold_conv import path_list

    names = dict(INSTANCES)
    counts = {}
    for lib in BD_LIBS:
        per_fn = sass_counts(libs[lib])
        if per_fn is None:
            log("  breakdown sass: cuobjdump not found")
            return None
        for fn, c in per_fn.items():
            m = re.search(r"probe_breakdown_kernelILi(\d+)E", fn)
            if m:
                v = names[("probe_breakdown_kernel", m.group(1))].split("<")[1].split(">")[0]
                counts[v] = c
                log(f"  sass probe_breakdown<{v}>: HMMA {c['HMMA']}, FFMA {c['FFMA']}, FADD "
                    f"{c['FADD']}, STS {c['STS']}")
    h = {v: c["HMMA"] for v, c in counts.items()}
    f = {v: c["FFMA"] for v, c in counts.items()}
    sts = {v: c["STS"] for v, c in counts.items()}
    uvu = h["full_hi"] - h["ko notp"]
    msg_ffma = f["tpred"] - f["tmp"]
    mm = h["tpredmm"] - h["tmp"]
    floor_ffma, floor_sts = edge_ffma_floor(path_list()), edge_sts_floor(path_list())
    log(f"  breakdown sass: per-edge product FFMA tpred {msg_ffma}, nofold "
        f"{f['ko nofold'] - f['ko notp']} (floor {floor_ffma}); nofold staging STS "
        f"{sts['ko nofold'] - sts['ko notp']} (floor {floor_sts}); 0/1 sum HMMA tpredmm {mm}, "
        f"fullmm {h['fullmm'] - h['tmp']}, feat_full {h['feat_full'] - h['featroll_mlp']}")
    checks = {
        "one pass: 3 x mlp = mlp_hi": 3 * h["mlp"] == h["mlp_hi"],
        "one pass: full = notp / 3 + uvu": 3 * (h["full"] - uvu) == h["ko notp"] and uvu > 0,
        "nomlp = full - mlp_hi (MLP and W3 gone)": h["ko nomlp"] == h["ko full"] - h["mlp_hi"],
        "nothing = nomlp - uvu (uvu gone too)": h["ko nothing"] == h["ko nomlp"] - uvu,
        "full_hi and ko full = B4 fwd": h["full_hi"] == h["ko full"],
        "transpose: no arithmetic": sum(counts["feat_transpose"][i] for i in
                                        ("HMMA", "FFMA", "FADD")) == 0,
        "per-edge product on the CUDA cores: tpred = tmp and nofold = notp in HMMA":
            h["tpred"] == h["tmp"] and h["ko nofold"] == h["ko notp"],
        "per-edge messages: the same FFMAs in nofold and tpred, every path and width "
        "(none dropped)": f["ko nofold"] - f["ko notp"] == msg_ffma >= floor_ffma,
        "nofold stages its messages": sts["ko nofold"] - sts["ko notp"] >= floor_sts,
        "0/1 sums: two TF32 passes, tpredmm = fullmm":
            mm > 0 and mm % 2 == 0 and h["fullmm"] - h["tmp"] == mm,
        "feature-major sums: 0/1 product two passes, halving chain none":
            (h["feat_full"] - h["featroll_mlp"]) % 2 == 0
            and h["feat_full"] > h["featroll_mlp"] and h["featroll_full"] == h["featroll_mlp"],
    }
    for name, ok in checks.items():
        log(f"  breakdown sass check {name}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit(f"a breakdown instantiation's SASS does not match its phases: HMMA {h}, "
                         f"FFMA {f}, STS {sts}")
    return counts


def breakdown_phase(dev, card: str, libs, prof_build):
    """The fused-conv breakdown and knock-out probes (``probes/breakdown.py``,
    ``probes/knockout.py``: B4 fwd's kernel with compile-time phase
    parameters). After the SASS checks (``breakdown_sass``), at the TPU
    scripts' shapes (SevenNet-0's layer; breakdown N 3,072, K 96; knock-out
    N 10,016, K 72; xg, emb and sh from the seed, x = xg with the identity
    gather), each variant against its plain version (3xTF32 variants 1e-4
    of max |plain|, the one-pass ones 2^-8, transpose bitwise; launches not
    counted), ``full_hi`` and knock-out ``full`` bitwise against B4 fwd on
    the same inputs; then the probe path with the counts from 0: each
    variant timed by ``diff_ms`` at (3, 9, 3) (the knock-out script's
    method, on the device alone), beside its bound (``bd_bound``: its own
    work), its plain version (warm, mean of 3), its registers and the time
    it saves against its full; and for the knock-out, B4 fwd's section
    clocks at the same layer and inputs (``conv_breakdown.py``'s profile
    build, ``prof_build`` the thread building it). Returns (records by
    variant, launches by variant)."""
    import torch

    from conv_breakdown import SECTIONS, profile_call
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.probes import breakdown as bd
    from sevennet_tpu_torch.probes import fold_conv as fcv
    from sevennet_tpu_torch.probes import knockout as ko
    from sevennet_tpu_torch.probes._lib import diff_ms

    breakdown_sass(libs)
    ptx = {r["instance"]: r for r in ptxas_table({k: libs[k] for k in BD_LIBS})}
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device="cpu").manual_seed(12)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    conv, mlp = fcv.sevennet0_conv()
    op = fc.conv_op(conv, mlp)
    ws = [rnd(a, b) for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    recs, launches = {}, {}
    for key, mod, fn, n, k, work in (
            ("breakdown", bd, bd.breakdown, bd.N, bd.K, bd.breakdown_work),
            ("knockout", ko, ko.knockout, ko.N, ko.K, ko.knockout_work)):
        xg = rnd(n * k, op.dim_x, scale=0.5)
        emb, sh = rnd(n * k, op.n_basis, scale=0.3), rnd(n * k, op.dim_f, scale=0.5)
        src = torch.arange(n * k, dtype=torch.int32, device=dev).view(n, k)
        b4 = fc.fused_conv_fwd_embsh(op, xg, src, emb, sh, ws)
        errs = {}
        for v in mod.VARIANTS:
            tag = f"probe {key} {v} N {n} K {k}"
            got = fn(op, xg, emb, sh, ws, k, v)
            want = fn(op, xg, emb, sh, ws, k, v, plain=True)
            tol = bd.tol(v) if mod is bd else ko.TOL
            errs[v] = (check_equal(tag, got, want) if tol == 0 else
                       check_close(tag, "out", got, want, tol))
            if v == ("full_hi" if mod is bd else "full"):
                check_equal(f"{tag} against B4 fwd on the same inputs", got, b4)
            del got, want
        del b4
        torch.cuda.empty_cache()

        # the probe path, counts from 0
        fn.launches, fn.by_variant = 0, dict.fromkeys(mod.VARIANTS, 0)
        b4_ms = diff_ms(lambda: fc.fused_conv_fwd_embsh(op, xg, src, emb, sh, ws), *bd.KNOCK_TIME)
        times = {}
        for v in mod.VARIANTS:
            times[v] = diff_ms(lambda: fn(op, xg, emb, sh, ws, k, v), *bd.KNOCK_TIME)
        for v in mod.VARIANTS:
            ms = times[v]
            plain = cuda_time(lambda: fn(op, xg, emb, sh, ws, k, v, plain=True), 3)
            fl, nbytes, one = work(op, v, n, k)
            bnd = bd_bound(fl, nbytes, one)
            full = BD_FULL.get(v, "full") if mod is bd else "full"
            inst = f"probe_breakdown<{'ko ' if mod is ko else ''}{v.replace('_amaj', '')}> (probe)"
            r = ptx.get(inst, {})
            log(f"  probe {key} {v} N {n} K {k}: {ms:.4f} ms per call, saves "
                f"{times[full] - ms:+.4f} ms ({(times[full] - ms) / times[full]:+.1%}) against "
                f"{full}; bound {bnd[0]:.4f} ms by {bnd[1]} ({bnd[0] / ms:.1%}; {fl / 1e9:.2f} "
                f"GFLOP, {one / 1e9:.2f} of it one TF32 pass, {nbytes / 1e6:.1f} MB); plain "
                f"{plain:.3f} ms; ptxas {r.get('registers')} registers, {r.get('stack')} B stack, "
                f"{r.get('spill_stores')} B spill stores | {card}")
            recs[(key, v)] = dict(ms=ms, plain_ms=plain, bound=bnd, library_ms=None, err=errs[v],
                                  name=f"{key} {v} (SevenNet-0 layer, N {n}, K {k})")
        log(f"  probe {key}: B4 fwd on the same inputs {b4_ms:.4f} ms per call | {card}")
        launches.update({(key, v): c for v, c in fn.by_variant.items()})
        if key == "knockout":
            # what each knock-out saves, beside B4 fwd's section clocks here
            prof_build.join()
            lib, entry, args, _ = fc.fwd_launch_args(op, xg, src, emb, sh, ws)
            cycles = profile_call(lib, entry, args, n, dev).sum(0).tolist()
            share = {label: c / sum(cycles) for label, c in zip(SECTIONS, cycles) if c}
            for label, sh_ in share.items():
                log(f"  B4 fwd section {label:32s} {sh_:6.1%} ({sh_ * b4_ms:.4f} ms)")
            mlp_sec = sum(share.get(s_, 0.0) for s_ in ("(f) W3 forward product", "(e) MLP 2"))
            for v, sec, what in (("nomlp", mlp_sec, "W3 product and MLP layer 2 (layer 1 shares "
                                                    "section (b) with the gather and tmp)"),
                                 ("notp", share.get("uvu product (forward)", 0.0), "uvu product"),
                                 ("nofold", share.get("uvu product (forward)", 0.0),
                                  "uvu product (nofold runs the per-edge product on the CUDA "
                                  "cores and stages it, no K sum: it saves what B4's product and "
                                  "fold cost beyond that)"),
                                 ("nothing", mlp_sec + share.get("uvu product (forward)", 0.0),
                                  "W3, MLP 2 and uvu")):
                saved = times["full"] - times[v]
                log(f"  knock-out {v} saves {saved:.4f} ms = {saved / times['full']:.1%} of full; "
                    f"the clocked sections {what}: {sec:.1%} | {card}")
        del xg, emb, sh, src
        torch.cuda.empty_cache()
    if not all(launches.values()):
        raise SystemExit(f"a breakdown or knock-out probe kernel was never launched on the probe "
                         f"path: {launches}")
    log(f"  breakdown and knock-out probes: peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return recs, launches


FWD_CU = "sevennet_tpu_torch/csrc/fused_conv_fwd.cu"
PROBE_MM_CU = "sevennet_tpu_torch/csrc/probe_mm.cu"
PROBE_BD_CU = "sevennet_tpu_torch/csrc/probe_batched_dot.cu"
BWD_CU = "sevennet_tpu_torch/csrc/fused_conv_bwd.cu"
PG_CU = "sevennet_tpu_torch/csrc/pg_reduce.cu"
FMA_CU = "sevennet_tpu_torch/csrc/probe_fma.cu"
GATHER_CU = "sevennet_tpu_torch/csrc/probe_gather.cu"
REDUCE_CU = "sevennet_tpu_torch/csrc/probe_reduce.cu"
XPOSE_CU = "sevennet_tpu_torch/csrc/probe_xpose.cu"
FOLD_CU = "sevennet_tpu_torch/csrc/probe_fold.cu"
FOLD_CONV_CU = "sevennet_tpu_torch/csrc/probe_fold_conv.cu"
# breakdown_phase's variants -> (source, TPU kernel replaced)
BD_SITES = {
    **{v: ("sevennet_tpu_torch/csrc/probe_breakdown.cu", "scripts_dev/r2_fused_breakdown.py:170")
       for v in ("mlp", "mlp_hi", "tmp", "tp", "tpred", "full", "full_hi")},
    **{v: ("sevennet_tpu_torch/csrc/probe_breakdown_k.cu", "scripts_dev/r2_fused_breakdown.py:170")
       for v in ("tpredk", "storek", "fullk", "tpredmm", "tpredmm_amaj", "fullmm")},
    **{v: ("sevennet_tpu_torch/csrc/probe_breakdown_feat.cu",
           "scripts_dev/r2_fused_breakdown.py:262") for v in ("feat_full", "feat_transpose")},
    **{v: ("sevennet_tpu_torch/csrc/probe_breakdown_feat.cu",
           "scripts_dev/r2_fused_breakdown.py:343") for v in ("featroll_full", "featroll_mlp")},
}
KO_CU = "sevennet_tpu_torch/csrc/probe_knockout.cu"
# fma_gather_phase's record kinds -> (source, TPU kernel replaced)
FG_SITES = {
    "chain": (FMA_CU, "scripts_dev/r2_pallas_fma.py:72"),
    "pass": (FMA_CU, "scripts_dev/r2_pallas_caps.py:127"),
    "vpu": (FMA_CU, "scripts_dev/r4_vpu_roofline.py:28"),
    "rows": (GATHER_CU, "scripts_dev/r3_gather_probe.py:27"),
    "cols_one": (GATHER_CU, "scripts_dev/r2_pallas_caps.py:55"),
    "cols": (GATHER_CU, "scripts_dev/r2_pallas_caps.py:68"),
    "small_rows": (GATHER_CU, "scripts_dev/r2_pallas_caps.py:91"),
}
# reduce_fold_xpose_phase's record kinds -> (source, TPU kernel replaced)
RFX_SITES = {
    "kreduce": (REDUCE_CU, "scripts_dev/r2_pallas_fma.py:94"),
    "lanereduce": (REDUCE_CU, "scripts_dev/r2_pallas_mm.py:98"),
    "subreduce": (REDUCE_CU, "scripts_dev/r2_pallas_mm.py:120"),
    "transpose": (XPOSE_CU, "scripts_dev/r2_pallas_mm.py:76"),
    "xpose": (XPOSE_CU, "scripts_dev/r5_xpose_probe.py:96"),
    "xpose2": (XPOSE_CU, "scripts_dev/r5_xpose_probe.py:114"),
    "fold": (FOLD_CU, "scripts_dev/r3_fold_probe.py:85"),
    "fold_conv": (FOLD_CONV_CU, "scripts_dev/r4_fold_probe.py:153"),
}
# kernels line entry -> (name, source, TPU kernel replaced, record and launch key)
KERNEL_NAMES = {
    "fwd": ("fused_conv_fwd", FWD_CU, "sevennet_tpu/ops/fused_conv.py:678", "fwd"),
    "bwd": ("fused_conv_bwd", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222", "bwd"),
    "bwd_slot": ("fused_conv_bwd_slot", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1208",
                 "bwd_slot"),
    "bwd_pg": ("fused_conv_bwd_pg", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222", "bwd_pg"),
    "reduce": ("param_grad_reduce", PG_CU, "sevennet_tpu/ops/fused_conv.py:1064", "reduce"),
    "fwd_embsh": ("fused_conv_fwd_embsh", FWD_CU, "sevennet_tpu/ops/fused_conv.py:678",
                  "fwd_embsh"),
    "bwd_embsh": ("fused_conv_bwd_embsh", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222",
                  "bwd_embsh"),
    "bwd_embsh_pg": ("fused_conv_bwd_embsh_pg", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222",
                     "bwd_embsh_pg"),
    "bwd_embsh_slot": ("fused_conv_bwd_embsh_slot", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222",
                       "bwd_embsh_slot"),
    # B5 (make_fused_conv_bwd) computes B4 bwd's function: the same kernel serves it
    "b5": ("fused_conv_bwd_embsh (serves B5)", BWD_CU, "sevennet_tpu/ops/fused_conv.py:875",
           "bwd_embsh"),
    # B6 (dense_conv_pallas) computes B4 fwd's function: the same kernel serves it
    "b6": ("fused_conv_fwd_embsh (serves B6 through dense_conv_pallas)", FWD_CU,
           "sevennet_tpu/ops/pallas_conv.py:194", "b6"),
}


def batched_phase(spec, params, dev, card: str):
    """Batched inference (``BatchedCalculator``): BATCH_MOLECULES water boxes
    (66-384 atoms) in one ``calculate`` call, each structure's energy, forces
    and stress against ``SevenNetCalculator`` one by one (ENERGY_REL_TOL,
    FORCE_TOL and FORCE_REL_TOL, STRESS_TOL); the batched call's time
    against the sequential calls' (host clock; results are host arrays, so
    the work is done). 5 B1 + 5 B2 per call. Returns the timed batched
    call's launches."""
    import numpy as np

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.batched import BatchedCalculator
    from sevennet_tpu_torch.calculator import SevenNetCalculator

    ats = []
    for i, m in enumerate(BATCH_MOLECULES):
        pos, Z, cell = water_box(m, seed=20 + i)
        ats.append(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    batched = BatchedCalculator(spec, params, device=str(dev))
    single = SevenNetCalculator(spec, params, device=str(dev))
    batched.calculate(ats)  # warm-up
    for at in ats:
        single.calculate(at)
    t_b, t_s = [], []
    for _ in range(BATCH_REPS):
        reset_launches()
        t0 = time.perf_counter()
        res = batched.calculate(ats)
        t_b.append(time.perf_counter() - t0)
        counts = read_launches()
        t0 = time.perf_counter()
        want = [single.calculate(at) for at in ats]
        t_s.append(time.perf_counter() - t0)
    errs = []
    for r, w, at in zip(res, want, ats):
        de = abs(r["energy"] - w["energy"]) / abs(w["energy"])
        df = float(np.abs(r["forces"] - w["forces"]).max())
        ds = float(np.abs(r["stress"] - w["stress"]).max())
        fmax = float(np.abs(w["forces"]).max())
        errs.append((de, df, ds))
        if not (de <= ENERGY_REL_TOL and df <= FORCE_TOL and df <= FORCE_REL_TOL * fmax
                and ds <= STRESS_TOL):
            raise SystemExit(f"batched inference: structure of {len(at)} atoms: rel dE {de}, "
                             f"max|dF| {df} (max|F| {fmax}), max|dS| {ds}")
    n_layers = len(spec.layers)
    if counts != dict(dict.fromkeys(counts, 0), fwd=n_layers, bwd=n_layers):
        raise SystemExit(f"batched inference launched {counts} in one call")
    tb, ts = statistics.median(t_b) * 1e3, statistics.median(t_s) * 1e3
    log(f"batched inference: {len(ats)} water boxes ({sum(len(a) for a in ats)} atoms, "
        f"{min(len(a) for a in ats)}-{max(len(a) for a in ats)} each) in one call: "
        f"{tb:.1f} ms against {ts:.1f} ms for {len(ats)} single requests ({ts / tb:.2f}x; median "
        f"of {BATCH_REPS}, host clock); max rel dE {max(e[0] for e in errs):.3e}, max|dF| "
        f"{max(e[1] for e in errs):.3e} eV/A, max|dS| {max(e[2] for e in errs):.3e} eV/A^3 "
        f"against the single requests; launches {counts} | {card}")
    return counts


def _stdout_of(fn, *args):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    if rc != 0:
        raise SystemExit(f"the command {args} returned {rc}")
    return buf.getvalue()


def _close_rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def scripts_phase(spec, params, dev, seed: int, card: str):
    """The scripts, the CLI and profiling, in this process on the card.
    ``scripts.inference.inference`` over the training phase's 16
    teacher-labelled boxes (extxyz), its errors dict against an
    ``ErrorRecorder`` fed ``model_compute`` directly (bitwise, else 1e-6
    relative); ``run_md_from_config`` with a dict, 192 atoms, ``nvt``,
    SCRIPT_MD_STEPS steps with a trajectory and a thermo CSV, then with the
    ``d3:`` key, each thermo row against a direct ``MDEngine`` run from the
    same seed (bitwise, else 1e-6 relative); ``cli.main.main`` for ``preset
    base``, ``checkpoint``, ``get_model`` (its checkpoint's parameters
    bitwise the source's) and ``inference`` (the errors of the script);
    ``profiling.trace`` around one MD chunk: the trace names both conv
    kernels. Returns the launches of the scripts' and the CLI's work."""
    import glob
    import json as json_
    import os

    import numpy as np
    import torch

    from sevennet_tpu_torch import profiling
    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.cli.main import PRESETS
    from sevennet_tpu_torch.cli.main import main as cli_main
    from sevennet_tpu_torch.data.dataset import GraphDataset
    from sevennet_tpu_torch.data.extxyz import write_extxyz
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.io.native_checkpoint import load_checkpoint, save_checkpoint
    from sevennet_tpu_torch.md import MDEngine
    from sevennet_tpu_torch.model.model import model_compute
    from sevennet_tpu_torch.scripts.inference import METRICS, inference
    from sevennet_tpu_torch.scripts.md_run import run_md_from_config
    from sevennet_tpu_torch.train.error_recorder import ErrorRecorder, RecorderSpec
    from sevennet_tpu_torch.train.trainer import tree_leaves

    total = dict.fromkeys(counters(), 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_") as tmp:
        xyz = os.path.join(tmp, "water.extxyz")
        teacher = params_from_numpy(spec, random_params(spec, seed + 1))
        training_set(spec, teacher, dev, seed, xyz)
        ckpt = os.path.join(tmp, "model")
        save_checkpoint(ckpt, dict(SEVENNET0), params)

        reset_launches()
        t0 = time.perf_counter()
        errors = inference(ckpt, [xyz], os.path.join(tmp, "infer"), batch_size=TRAIN_BATCH,
                           device=str(dev))
        t_inf = time.perf_counter() - t0
        add(read_launches())
        ds = GraphDataset.from_files(xyz, spec.cutoff).build(spec.z_to_type)
        acc = ErrorRecorder(RecorderSpec.from_config(METRICS))
        for gb in ds.batches(TRAIN_BATCH):
            gb = gb.to(dev)
            acc.update(model_compute(spec, params, gb, device=str(dev)), gb)
        direct = acc.get_metric_dict(with_unit=True)
        worst = max(_close_rel(errors[k], direct[k]) for k in direct)
        if list(errors) != list(direct) or worst > 1e-6:
            raise SystemExit(f"inference: errors {errors} against model_compute's {direct}")
        log(f"scripts.inference: {len(ds)} structures in {t_inf:.2f} s, errors {errors}; "
            f"against an ErrorRecorder fed model_compute: bitwise "
            f"{all(errors[k] == direct[k] for k in direct)}, max rel {worst:.3e} | {card}")

        pos, Z, cell = water_box(64, seed=11)
        start = os.path.join(tmp, "start.extxyz")
        write_extxyz(start, [AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)])
        for label, d3 in (("nvt", None), ("nvt + D3", dict(D3))):
            cfg = {"checkpoint": ckpt, "structure": start, "ensemble": "nvt",
                   "steps": SCRIPT_MD_STEPS, "dt": MD_DT, "temperature": MD_T, "chunk": MD_CHUNK,
                   "seed": seed, "trajectory": os.path.join(tmp, "traj.extxyz"),
                   "traj_every": MD_CHUNK, "log": os.path.join(tmp, "thermo.csv")}
            if d3:
                cfg["d3"] = d3
            lines = []
            reset_launches()
            t0 = time.perf_counter()
            out = run_md_from_config({"md": cfg}, log=lines.append, device=str(dev))
            t_md = time.perf_counter() - t0
            add(read_launches())
            eng = MDEngine(spec, params, cell, skin=0.6, d3=d3, device=str(dev))
            st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
            st, (pe, ke) = eng.run(st, SCRIPT_MD_STEPS, dt=MD_DT, chunk=MD_CHUNK,
                                   integrator="nvt", temperature=MD_T)
            pe, ke = pe.cpu().numpy(), ke.cpu().numpy()
            rows = out["thermo"]
            want = [(float(pe[r["step"] - 1]), float(ke[r["step"] - 1])) for r in rows]
            got = [(r["pe"], r["ke"]) for r in rows]
            worst = max(max(_close_rel(g[0], w[0]), _close_rel(g[1], w[1]))
                        for g, w in zip(got, want))
            with open(cfg["log"]) as f:
                csv_rows = f.read().strip().split("\n")
            with open(cfg["trajectory"]) as f:
                n_frames = f.read().count("Lattice=")
            if (len(rows) != SCRIPT_MD_STEPS // MD_CHUNK or worst > 1e-6
                    or len(csv_rows) != len(rows) + 1 or n_frames != len(rows) + 1):
                raise SystemExit(f"run_md_from_config ({label}): rows {got} against the engine's "
                                 f"{want}, {len(csv_rows)} CSV lines, {n_frames} frames")
            log(f"run_md_from_config ({label}, 192 atoms, {SCRIPT_MD_STEPS} steps): {t_md:.2f} s, "
                f"{lines[0] if lines else ''}; thermo rows against a direct MDEngine run: "
                f"bitwise {got == want}, max rel {worst:.3e}; {len(csv_rows) - 1} CSV rows, "
                f"{n_frames} trajectory frames | {card}")

        if _stdout_of(cli_main, ["preset", "base"]) != PRESETS["base"] + "\n":
            raise SystemExit("cli preset base printed another text")
        info = json_.JSONDecoder().raw_decode(_stdout_of(cli_main, ["checkpoint", ckpt]))[0]
        if info["layers"] != len(spec.layers) or info["cutoff"] != spec.cutoff:
            raise SystemExit(f"cli checkpoint printed {info}")
        exported = os.path.join(tmp, "exported")
        _stdout_of(cli_main, ["get_model", ckpt, "--out", exported])
        a, b = (tree_leaves(load_checkpoint(p)[1]) for p in (ckpt, exported))
        if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise SystemExit("cli get_model changed the parameters")
        reset_launches()
        cli_errors = json_.loads(_stdout_of(cli_main, [
            "inference", ckpt, xyz, "--output", os.path.join(tmp, "cli_infer"), "--batch",
            str(TRAIN_BATCH), "--device", str(dev)]))
        add(read_launches())
        worst = max(_close_rel(cli_errors[k], errors[k]) for k in errors)
        if worst > 1e-6:
            raise SystemExit(f"cli inference: {cli_errors} against the script's {errors}")
        log(f"cli: preset base, checkpoint ({info['layers']} layers, format {info['format']}), "
            f"get_model ({len(b)} leaves bitwise), inference (max rel {worst:.3e} from the "
            f"script's errors) | {card}")

        eng = MDEngine(spec, params, cell, device=str(dev))
        st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
        logdir = os.path.join(tmp, "trace")
        with profiling.step_timer() as timer, profiling.trace(logdir) as prof:
            st, (pe, _) = eng.run(st, MD_CHUNK, dt=MD_DT, chunk=MD_CHUNK)
            timer.lap(pe)
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        text = open(files[0]).read() if files else ""
        names = ("fused_conv_fwd_kernel", "fused_conv_bwd_kernel")
        dev_us = {e.key: e.device_time_total for e in prof.key_averages()
                  if any(n in e.key for n in names)}
        if len(files) != 1 or not all(n in text for n in names):
            raise SystemExit(f"profiling.trace: files {files}, kernel names found "
                             f"{[n for n in names if n in text]}")
        log(f"profiling.trace around {MD_CHUNK} MD steps of 192 atoms: {len(text)} bytes of "
            f"Chrome trace naming {', '.join(names)}; device us {dev_us}; step_timer lap "
            f"{timer.laps[0] * 1e3:.1f} ms | {card}")
    return total


def dist_md_run(spec, params, dev, dims, pos, Z, cell, vel, warm: int, timed: int,
                stress: bool):
    """One rank's distributed NVE run on the card (the world-1 phase in this
    process, the two-rank phase in each spawned rank): ``make_state``,
    ``warm`` steps, ``timed`` timed steps (host clock around synchronized
    work), with ``stress`` one ``compute_stress``. Returns the first forces
    and energy, the PE and KE of every step, ms/step, peak memory, ghost
    rows, rebuilds, the migrated atoms of all ranks, the final positions in
    the input order and the launches after ``make_state``."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.model.model import conv_row_chunk
    from sevennet_tpu_torch.parallel import DistributedMDEngine

    eng = DistributedMDEngine(spec, params, cell, dims=dims, device=str(dev))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    st = eng.make_state(pos, Z, velocities=vel)
    t_setup = time.perf_counter() - t0
    out = dict(forces0=eng.gather(st, st.forces), pe0=float(st.potential_energy))
    reset_launches()
    st, (pe1, ke1) = eng.run(st, warm, dt=DIST_DT, chunk=warm)
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, (pe2, ke2) = eng.run(st, timed, dt=DIST_DT, chunk=timed)
    sync()
    ms = (time.perf_counter() - t0) / timed * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    evals = warm + timed
    if stress:
        e, s, _ = eng.compute_stress(st)
        out.update(stress_e=float(e), stress=s.cpu().numpy())
        evals += 1
    NL, K = st.edge_src.shape
    nb = sum(-(-NL // rc) if rc and rc < NL else 1
             for rc in (conv_row_chunk(eng.spec, NL, K, layer.conv.irreps_x.dim)
                        for layer in spec.layers))
    counts = read_launches()
    out.update(
        pe=torch.cat([pe1, pe2]).cpu().numpy(), ke=torch.cat([ke1, ke2]).cpu().numpy(),
        ms=ms, peak=peak, t_setup=t_setup, ghosts=int(st.ext_mask[NL:].sum()),
        owned=int(st.atom_mask.sum()), NL=NL, K=K, nb=nb, evals=evals,
        rebuilds=eng.n_rebuilds, swaps=eng.halo.n_swaps,
        migrated=int(eng.halo.all_reduce(torch.tensor(eng.n_migrated, device=dev))),
        n_atoms=int(eng.halo.all_reduce(st.atom_mask.sum())),
        positions=eng.gather(st, st.positions), launches=np.asarray(
            [counts[k] for k in sorted(counts)]))
    return out


def _dist_rank(rank: int, world: int, init: str, job: dict, out: str):
    """One rank of the two-rank phase, in its own spawned process: a
    ``gloo`` group from a ``file://`` store (two ranks share the card, which
    NCCL refuses; the halos stage through host memory), SevenNet-0 from the
    seed, :func:`dist_md_run`; writes ``{out}/rank{rank}.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.build import build_model_spec

    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        spec = build_model_spec(job["model"])
        params = params_from_numpy(spec, random_params(spec, job["seed"]))
        res = dist_md_run(spec, params, dev, job["dims"], job["pos"], job["Z"], job["cell"],
                          job["vel"], job["warm"], job["timed"], stress=True)
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _serial_run(spec, params, dev, pos, Z, cell, vel, steps: int):
    """The serial ``MDEngine`` (the kernels, its default slot margin) from
    the same positions and velocities: its first forces and energy (input
    order), PE and KE of every step, ms/step, final positions (input
    order), K and rebuilds."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine

    n = len(pos)
    eng = MDEngine(spec, params, cell, device=str(dev))
    st = eng.make_state(pos, Z)
    idx = st.atom_index.cpu().numpy()
    v = np.zeros((st.n_atoms_cap, 3), np.float32)
    v[:n] = vel[idx[:n]]
    st = st.replace(velocities=torch.as_tensor(v, device=dev))
    out = dict(forces0=unsorted(st, n, "forces")[:n], pe0=float(st.potential_energy))
    t0 = time.perf_counter()
    st, (pe, ke) = eng.run(st, steps, dt=DIST_DT, chunk=steps)
    float(pe[-1])  # waits for the card
    out.update(ms=(time.perf_counter() - t0) / steps * 1e3, pe=pe.cpu().numpy(),
               ke=ke.cpu().numpy(), positions=unsorted(st, n, "positions")[:n], K=eng.k_model,
               rebuilds=eng.n_rebuilds)
    return out


def _traj_err(got, want, rel: float = 5e-3) -> float:
    """Largest difference over the run, in units of rel x max(1, |E|)
    (5e-3: tests/test_parallel.py:180-184): at most 1 passes."""
    import numpy as np

    return float(np.abs(got - want).max() / (rel * max(1.0, float(np.abs(want).max()))))


def _dist_launch_check(label, res, n_layers, counts):
    want = dict.fromkeys(counts, 0)
    want.update(fwd=n_layers * res["evals"], bwd=res["nb"] * res["evals"])
    if counts != want:
        raise SystemExit(f"{label}: launches {counts}, expected {want} (5 B1 + 5 nb B2 a force "
                         "evaluation, no B3, no mirror reduction)")


def dist_world1_phase(spec, params, dev, seed: int, card: str):
    """Distributed MD on one rank: an ``nccl`` group of world 1 in this
    process, ``dims=(1,)``, 3,000 atoms of water, DIST1_WARM + DIST1_TIMED
    NVE steps of DIST_DT fs at MD_T, against the serial engine from the same
    positions and velocities: first forces within FORCE_TOL and
    FORCE_REL_TOL, energy within ENERGY_REL_TOL, PE and KE trajectories
    within 5e-3 x max(1, |E|); 5 B1 + 5 nb B2 per force evaluation.
    Returns the launches."""
    import numpy as np
    import torch.distributed as dist

    from sevennet_tpu_torch.md.state import ATOMIC_MASSES, thermal_velocities

    pos, Z, cell = water_box(DIST_MOLECULES)
    vel = thermal_velocities(ATOMIC_MASSES[Z], MD_T, seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist1_") as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            res = dist_md_run(spec, params, dev, (1,), pos, Z, cell, vel, DIST1_WARM,
                              DIST1_TIMED, stress=False)
        finally:
            dist.destroy_process_group()
    ser = _serial_run(spec, params, dev, pos, Z, cell, vel, DIST1_WARM + DIST1_TIMED)
    df = float(np.abs(res["forces0"] - ser["forces0"]).max())
    fmax = float(np.abs(ser["forces0"]).max())
    de = _close_rel(res["pe0"], ser["pe0"])
    e_pe, e_ke = _traj_err(res["pe"], ser["pe"]), _traj_err(res["ke"], ser["ke"])
    counts = dict(zip(sorted(counters()), res["launches"].tolist()))
    log(f"distributed MD, world 1 (nccl, dims (1,)), {len(pos)} atoms, "
        f"{DIST1_WARM + DIST1_TIMED} NVE steps of {DIST_DT} fs: make_state "
        f"{res['t_setup']:.1f} s; {res['ms']:.2f} ms/step over {DIST1_TIMED} timed steps "
        f"against the serial engine's {ser['ms']:.2f} (host clock, same call); peak "
        f"{res['peak']:.2f} GiB; NL {res['NL']}, K {res['K']}, ghosts {res['ghosts']}, rebuilds "
        f"{res['rebuilds']}; first forces max|dF| {df:.3e} eV/A (max|F| {fmax:.3e}), rel dE "
        f"{de:.3e}; PE, KE trajectories at {e_pe:.3e}, {e_ke:.3e} of 5e-3 x max(1, |E|) "
        f"(max|dPE| {float(np.abs(res['pe'] - ser['pe']).max()):.3e} eV); {res['evals']} "
        f"force evaluations, launches {counts} | {card}")
    checks = ((df <= FORCE_TOL and df <= FORCE_REL_TOL * fmax, f"forces {df} (max {fmax})"),
              (de <= ENERGY_REL_TOL, f"energy rel {de}"),
              (e_pe <= 1 and e_ke <= 1, f"trajectories {e_pe}, {e_ke}"),
              (res["n_atoms"] == len(pos), f"atoms {res['n_atoms']}"))
    for ok, why in checks:
        if not ok:
            raise SystemExit(f"distributed MD, world 1: {why}")
    _dist_launch_check("distributed MD, world 1", res, len(spec.layers), counts)
    return counts


def dist_two_rank_phase(spec, params, dev, seed: int, card: str):
    """Distributed MD on two ranks sharing the card: two processes started
    with ``spawn`` (torch and the port only), a ``gloo`` group from a
    ``file://`` store in a temporary directory, ``dims=(2,)``, each joined
    with a timeout of its own (DIST_JOIN_S). 3,000 atoms of water at
    DIST_HOT_T (atoms cross the slab faces), DIST2_WARM + DIST2_TIMED NVE
    steps, then ``compute_stress``; against the serial engine at its own
    default slot margin from the same positions and velocities (both
    engines cut slots, each at its own K, and keep every pair within the
    cutoff between rebuilds): first forces within FORCE_TOL and
    FORCE_REL_TOL and energy within
    ENERGY_REL_TOL (the cross-rank backward, ``HaloExchange.backward``),
    PE and KE within DIST2_TRAJ_REL x max(1, |E|), each atom within
    DIST2_POS_TOL of its serial twin (nearest image), atoms conserved; the
    stress within 1e-4 of max |stress| of ``SevenNetCalculator`` at the
    final positions; at least one rebuild with migration; 5 B1 + 5 nb B2
    per force evaluation on each rank. Returns both ranks' launches."""
    import multiprocessing as mp

    import numpy as np

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.md.state import ATOMIC_MASSES, thermal_velocities

    pos, Z, cell = water_box(DIST_MOLECULES)
    n = len(pos)
    vel = thermal_velocities(ATOMIC_MASSES[Z], DIST_HOT_T, seed)
    job = dict(seed=seed, dims=(2,), pos=pos, Z=Z, cell=cell, vel=vel, warm=DIST2_WARM,
               timed=DIST2_TIMED, device=str(dev), model=dict(SEVENNET0))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist2_") as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_dist_rank, args=(r, 2, f"file://{tmp}/store", job, tmp))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(DIST_JOIN_S)
            codes = [p.exitcode for p in procs]
            if codes != [0, 0]:
                raise SystemExit(f"distributed MD, two ranks: exit codes {codes} (None: still "
                                 f"running after its join of {DIST_JOIN_S} s)")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(2)]
    t_wall = time.perf_counter() - t0
    res = ranks[0]
    ser = _serial_run(spec, params, dev, pos, Z, cell, vel, DIST2_WARM + DIST2_TIMED)
    df = float(np.abs(res["forces0"] - ser["forces0"]).max())
    fmax = float(np.abs(ser["forces0"]).max())
    de = _close_rel(float(res["pe0"]), ser["pe0"])
    e_pe = _traj_err(res["pe"], ser["pe"], DIST2_TRAJ_REL)
    e_ke = _traj_err(res["ke"], ser["ke"], DIST2_TRAJ_REL)
    # atom by atom (the gather orders the rows by input index), to the
    # nearest image: an atom that crossed the box is wrapped on one side
    # only at a rebuild
    frac = (res["positions"] - ser["positions"]) @ np.linalg.inv(cell)
    dx = float(np.abs((frac - np.round(frac)) @ cell).max())
    ref = SevenNetCalculator(spec, params, device=str(dev)).calculate(
        AtomsLite(positions=res["positions"], numbers=Z, cell=cell, pbc=True))
    s_dist = -res["stress"][[0, 1, 2, 4, 5, 3]]  # model order -> ASE Voigt and sign
    ds = float(np.abs(s_dist - ref["stress"]).max())
    smax = float(np.abs(ref["stress"]).max())
    counts = {}
    for k_i, k in enumerate(sorted(counters())):
        counts[k] = int(sum(r["launches"][k_i] for r in ranks))
    per_rank = [dict(zip(sorted(counters()), r["launches"].tolist())) for r in ranks]
    log(f"distributed MD, two ranks on one card (gloo, dims (2,), halos staged through host "
        f"memory), {n} atoms at {DIST_HOT_T:g} K, {DIST2_WARM + DIST2_TIMED} NVE steps of "
        f"{DIST_DT} fs + compute_stress: {t_wall:.1f} s wall with the spawn; "
        + "; ".join(f"rank {i}: {float(r['ms']):.2f} ms/step over {DIST2_TIMED} timed steps, make_state "
                    f"{float(r['t_setup']):.1f} s, peak {float(r['peak']):.2f} GiB, owned "
                    f"{int(r['owned'])}, ghosts {int(r['ghosts'])}, NL {int(r['NL'])}, K "
                    f"{int(r['K'])}, swaps {int(r['swaps'])}" for i, r in enumerate(ranks))
        + f"; serial engine (default slot margin, K {ser['K']}, rebuilds {ser['rebuilds']}) "
        f"{ser['ms']:.2f} ms/step (this process, alone); rebuilds {int(res['rebuilds'])}, "
        f"atoms migrated {int(res['migrated'])}; "
        f"first forces max|dF| {df:.3e} eV/A (max|F| {fmax:.3e}), rel dE {de:.3e}; PE, KE "
        f"trajectories at {e_pe:.3e}, {e_ke:.3e} of {DIST2_TRAJ_REL:g} x max(1, |E|) (max|dPE| "
        f"{float(np.abs(res['pe'] - ser['pe']).max()):.3e} eV, max|dKE| "
        f"{float(np.abs(res['ke'] - ser['ke']).max()):.3e} eV); positions max|dx| {dx:.3e} A "
        f"(each atom to the nearest image); stress max|dS| {ds:.3e} of max {smax:.3e} "
        f"eV/A^3; atoms {int(res['n_atoms'])}; launches per rank {per_rank} | {card}")
    checks = ((df <= FORCE_TOL and df <= FORCE_REL_TOL * fmax, f"forces {df} (max {fmax})"),
              (de <= ENERGY_REL_TOL, f"energy rel {de}"),
              (e_pe <= 1 and e_ke <= 1, f"trajectories {e_pe}, {e_ke}"),
              (int(res["n_atoms"]) == n, f"atoms {int(res['n_atoms'])}"),
              (dx <= DIST2_POS_TOL, f"positions {dx}"),
              (ds <= 1e-4 * smax, f"stress {ds} of {smax}"),
              (int(res["migrated"]) > 0 and int(res["rebuilds"]) > 1,
               f"no rebuild with migration (rebuilds {int(res['rebuilds'])}, migrated "
               f"{int(res['migrated'])})"))
    for ok, why in checks:
        if not ok:
            raise SystemExit(f"distributed MD, two ranks: {why}")
    for i, r in enumerate(ranks):
        _dist_launch_check(f"distributed MD, rank {i}",
                           {k: int(r[k]) for k in ("evals", "nb")}, len(spec.layers),
                           per_rank[i])
    return counts, ranks, ser


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threshold-probe", action="store_true",
                    help="only measure the peaks chunk_threshold rests on (threshold_probe)")
    ap.add_argument("--fold-probe", action="store_true",
                    help="only build and check the fold probe and time it (fold_probe)")
    ap.add_argument("--bd-probe", action="store_true",
                    help="only build and check the batched-dot probe and time it (bd_probe)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from sevennet_tpu_torch.atoms import AtomsLite
        from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
        from sevennet_tpu_torch.model.build import build_model_spec
        from sevennet_tpu_torch.ops import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    t_start = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    if args.fold_probe or args.bd_probe:
        name = "probe_fold" if args.fold_probe else "probe_batched_dot"
        libs = kernels.build([name])
        log(f"built {name} in {time.perf_counter() - t0:.1f} s")
        for row in ptxas_table(libs):
            log("  ptxas {instance}: {registers} registers, {stack} B stack, {spill_stores} B "
                "spill stores, {spill_loads} B spill loads".format(**row))
        (fold_probe if args.fold_probe else bd_probe)(dev, card, libs[name])
        print(gpu_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    libs = kernels.build()
    log(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    # B4 fwd's profile build (breakdown_phase's section clocks), meanwhile
    prof_build = threading.Thread(target=kernels.build, args=(["fused_conv_fwd"], True))
    prof_build.start()
    for row in ptxas_table(libs):
        log("  ptxas {instance}: {registers} registers, {stack} B stack, {spill_stores} B spill "
            "stores, {spill_loads} B spill loads".format(**row))
    for lib_name in ("probe_fma", "probe_reduce", "probe_fold"):
        for fn, c in (sass_counts(libs[lib_name]) or {"cuobjdump": "not found"}).items():
            log(f"  sass {fn}: {c}")
    reduce_sass(libs["pg_reduce"])
    fold_sass(libs["probe_fold"])
    mm_sass(libs["probe_mm"])
    g2_split(dev, card)
    xpose_sass(libs["probe_xpose"])

    spec = sevennet0_spec()
    params = params_from_numpy(spec, random_params(spec, args.seed))
    spec_legacy = build_model_spec(dict(SEVENNET0, _normalize_sph=False))
    if args.threshold_probe:
        threshold_probe(params, dev, args.seed, card)
        print(gpu_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    t0 = time.perf_counter()
    pos, Z, cell = water_box(1000)
    atoms = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    records, (N, K, n_edges) = kernel_phase(spec, params, dev, atoms)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "kernel phase")
    b6 = b6_path(spec_legacy, params, dev, atoms)
    log(f"B6 path (dense_conv_pallas over 5 layers): launches {b6}")
    t0 = time.perf_counter()
    ext_conv_check(spec, spec_legacy, params, dev, atoms, card)
    log(f"ext conv check: {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "ext conv check")
    t0 = time.perf_counter()
    served = request_phase(spec, params, dev, "vec", "fwd", "bwd")
    log(f"request phase (main path: serving): launches {served}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "request phase")
    t0 = time.perf_counter()
    served_legacy = request_phase(spec_legacy, params, dev, "legacy", "fwd_embsh", "bwd_embsh",
                                  graph_times=False)
    log(f"legacy request phase (main path: serving a pre-0.10 config): launches "
        f"{served_legacy}, {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "legacy request phase")
    t0 = time.perf_counter()
    trained, trained_legacy = training_phase(dev, args.seed, card)
    log(f"training phase (main path: training; legacy steps): launches {trained}, "
        f"{trained_legacy}, {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "training phase")
    t0 = time.perf_counter()
    md_small = md_compare_phase(spec, params, dev, args.seed, card)
    log(f"MD phase, 3,000 atoms (main path: MD, against the plain conv): "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "MD phase, 3,000 atoms")
    t0 = time.perf_counter()
    md_mid = md_timed_phase(spec, params, dev, args.seed, card)
    log(f"MD phase, 9,999 atoms (main path: MD, unchunked): {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "MD phase, 9,999 atoms")
    t0 = time.perf_counter()
    md_ring, records["bwd_slot"] = md_ring_phase(params, dev, args.seed, card)
    log(f"MD phase, 99,999 atoms (main path: MD, ring backward): "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "MD phase, 99,999 atoms")
    t0 = time.perf_counter()
    md_scatter, md_ring_legacy, records["bwd_embsh_slot"] = md_legacy_phase(params, dev, args.seed,
                                                                            card)
    log(f"MD phase, 99,999 atoms, legacy config (main path: MD of a pre-0.10 model, chunked "
        f"scatter and ring backward): {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "MD phase, 99,999 atoms, legacy config")
    t0 = time.perf_counter()
    ensembles = ensemble_phase(spec, params, dev, args.seed, card)
    log(f"ensemble phase, 3,000 atoms (main path: MD, NVT and NPT): launches {ensembles}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "ensemble phase, 3,000 atoms")
    t0 = time.perf_counter()
    d3_launches = d3_phase(spec, params, dev, args.seed, card)
    log(f"D3 phase (main paths: serving and MD with D3): launches {d3_launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "D3 phase")
    t0 = time.perf_counter()
    resolved = resolution_phase(spec, params, dev, card)
    log(f"resolution phase (main path: serving by checkpoint name): launches {resolved}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "resolution phase")
    t0 = time.perf_counter()
    deployed = deployed_phase(spec, params, dev, card)
    log(f"deployed phase (main paths: serving a frozen deployment, serving a downloaded "
        f"checkpoint): launches {deployed}, {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "deployed phase")
    t0 = time.perf_counter()
    batched = batched_phase(spec, params, dev, card)
    log(f"batched phase (main path: batched inference): launches {batched}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "batched phase")
    t0 = time.perf_counter()
    scripted = scripts_phase(spec, params, dev, args.seed, card)
    log(f"scripts phase (main paths: the inference and MD scripts, the CLI, profiling): "
        f"launches {scripted}, {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "scripts phase")
    t0 = time.perf_counter()
    dist1 = dist_world1_phase(spec, params, dev, args.seed, card)
    log(f"distributed MD phase, world 1 (main path: distributed MD): launches {dist1}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "distributed MD phase, world 1")
    t0 = time.perf_counter()
    dist2, _, _ = dist_two_rank_phase(spec, params, dev, args.seed, card)
    log(f"distributed MD phase, two ranks (main path: distributed MD): launches {dist2}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "distributed MD phase, two ranks")
    t0 = time.perf_counter()
    spec_l3 = build_model_spec(L3I5)
    params_l3 = params_from_numpy(spec_l3, random_params(spec_l3, args.seed))
    l3_records = l3i5_kernel_phase(spec_l3, params_l3, dev, atoms)
    mlp_depth_phase(dev, atoms, args.seed)
    log(f"l3i5 kernel and MLP-depth phases: {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "l3i5 kernel and MLP-depth phases")
    t0 = time.perf_counter()
    served_l3 = request_phase(spec_l3, params_l3, dev, "l3i5", "fwd", "bwd", sizes=L3I5_SIZES)
    log(f"l3i5 request phase (main path: serving SevenNet-l3i5): launches {served_l3}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "l3i5 request phase")
    t0 = time.perf_counter()
    mf_records, served_mf = mf_ompa_phase(dev, args.seed)
    log(f"mf-ompa phase (main path: serving SevenNet-MF-ompa, both modalities): launches "
        f"{served_mf}, {time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "mf-ompa phase")
    t0 = time.perf_counter()
    trained_mf = mf_train_phase(dev, args.seed, card)
    log(f"mf-ompa training phase (main path: multi-fidelity training): launches {trained_mf}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "mf-ompa training phase")
    t0 = time.perf_counter()
    probe_records, probe_launches = probe_phase(dev, card)
    log(f"probe phase (the probe path): launches {probe_launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "probe phase")
    t0 = time.perf_counter()
    fg_records, fg_launches = fma_gather_phase(dev, card)
    log(f"FMA and gather probe phase (the probe path): launches {fg_launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "FMA and gather probe phase")
    t0 = time.perf_counter()
    rfx_records, rfx_launches = reduce_fold_xpose_phase(dev, card)
    log(f"reduction, transpose and fold probe phase (the probe path): launches {rfx_launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "reduction, transpose and fold probe phase")
    t0 = time.perf_counter()
    bd_records, bd_launches = breakdown_phase(dev, card, libs, prof_build)
    log(f"breakdown and knock-out probe phase (the probe path): launches {bd_launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_alive(dev, "breakdown and knock-out probe phase")
    launches = {k: b6[k] + served[k] + served_legacy[k] + trained[k] + trained_legacy[k]
                + md_small[k] + md_mid[k] + md_ring[k] + md_scatter[k] + md_ring_legacy[k]
                + ensembles[k] + d3_launches[k] + resolved[k] + deployed[k] + batched[k]
                + scripted[k]
                + dist1[k] + dist2[k]
                for k in counters()}
    if not all(launches[key] for *_, key in KERNEL_NAMES.values()):
        raise SystemExit(f"a kernel was never launched on the main paths: {launches}")
    mf_launches = {k: served_mf[k] + trained_mf[k] for k in counters()}
    if not all(mf_launches[k] for k in ("fwd", "bwd", "bwd_pg", "reduce")):
        raise SystemExit(f"a kernel was never launched on SevenNet-MF-ompa's paths: "
                         f"{mf_launches}")

    kernels_line = []
    for name, source, replaces, key in KERNEL_NAMES.values():
        r = records[key]
        bnd, by = bound_ms(r["flops"], r["bytes"], r["tc_flops"])
        log(f"  bounds {name}: {bnd:.4f} ms ({r['tc_flops'] / max(r['flops'], 1):.1%} of the "
            f"operations as 3xTF32; fp32 {bound_ms(r['flops'], r['bytes'])[0]:.4f} ms), kernel "
            f"{r['ms']:.4f} ms | {card}")
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bnd, "bound_by": by,
            "library_ms": r.get("library_ms"),
        })
    for key, name in (("fwd", "fused_conv_fwd (SevenNet-l3i5)"),
                      ("bwd", "fused_conv_bwd (SevenNet-l3i5)")):
        r = l3_records[key]
        bnd, by = bound_ms(r["flops"], r["bytes"], r["tc_flops"])
        source, replaces = KERNEL_NAMES[key][1:3]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": served_l3[key], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bnd, "bound_by": by, "library_ms": None,
        })
    for key in ("fwd", "bwd", "bwd_pg", "reduce"):
        r = mf_records[key]
        bnd, by = bound_ms(r["flops"], r["bytes"], r["tc_flops"])
        name, source, replaces = KERNEL_NAMES[key][:3]
        kernels_line.append({
            "name": f"{name} (SevenNet-MF-ompa)", "route": "cuda", "source": source,
            "replaces": replaces, "launches": mf_launches[key], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bnd, "bound_by": by,
            "library_ms": r["library_ms"] if key == "reduce" else None,
        })
    from sevennet_tpu_torch.probes import mm_rate as mr

    for key, r in probe_records.items():
        if key == "batched":
            name, source, replaces = ("batched_dot (probe)", PROBE_BD_CU,
                                      "scripts_dev/r4_batched_dot_probe.py:95")
            launches = probe_launches["batched"]
        else:
            contract, v = key
            name = f"probe_mm {contract} {v} ({'x'.join(map(str, r['shape']))})"
            source = PROBE_MM_CU
            replaces = ("scripts_dev/r2_pallas_mm.py:54" if contract == "mm_rate"
                        else "scripts_dev/r2_pallas_fma.py:115")
            launches = (mr.mm_rate if contract == "mm_rate" else mr.mm_chain).by_variant[v]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        }
        if "worst" in r:  # the shape where the variant is slowest against its library call
            entry.update(worst_shape="x".join(map(str, r["worst"]["shape"])),
                         worst_ms=r["worst"]["ms"], worst_library_ms=r["worst"]["library_ms"])
        kernels_line.append(entry)
    for key, r in fg_records.items():
        kind = key[0] if isinstance(key, tuple) else key
        source, replaces = FG_SITES[kind]
        kernels_line.append({
            "name": f"{r['name']} (probe)", "route": "cuda", "source": source,
            "replaces": replaces, "launches": fg_launches[key], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    for key, r in rfx_records.items():
        source, replaces = RFX_SITES[key[0] if isinstance(key, tuple) else key]
        kernels_line.append({
            "name": f"{r['name']} (probe)", "route": "cuda", "source": source,
            "replaces": replaces, "launches": rfx_launches[key], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    for (key, v), r in bd_records.items():
        source, replaces = BD_SITES[v] if key == "breakdown" else (
            KO_CU, "scripts_dev/r3_fwd_knockout.py:128")
        kernels_line.append({
            "name": f"{r['name']} (probe)", "route": "cuda", "source": source,
            "replaces": replaces, "launches": bd_launches[(key, v)], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    log(f"kernel times are per pass of {N} atoms (K={K}, {n_edges} edges): "
        "layer 0 + 3 x layers 1-3 + layer 4 (fused_conv_bwd_slot and "
        "fused_conv_bwd_embsh_slot: per force evaluation of the 99,999-atom rings, vec and "
        "legacy, over their nb chunks); fused_conv_bwd_pg and fused_conv_bwd_embsh_pg include their "
        "param_grad_reduce; launches: the B6 path, serving (both configs), train_run, the "
        "legacy config's compared train steps, MD (3,000 and 9,999 atoms, and the timed "
        "ring steps at 99,999; the legacy config's timed chunked-scatter and ring steps at "
        "99,999), the ensembles at 3,000 atoms, the D3 phase (a 192-atom "
        "request and MD at 3,000 atoms with D3), the request by checkpoint name, the deployed "
        "phase's two requests (a frozen deployment's and a downloaded checkpoint's), the batched "
        "call, the scripts' and the CLI's work, and distributed MD (world 1, and both ranks "
        "of the two-rank run); the "
        "SevenNet-l3i5 rows per pass of its layer shapes on the "
        "same box, launches from its requests; the SevenNet-MF-ompa rows per pass of its "
        "five layer shapes on the 192-atom box, launches from its requests (both "
        "modalities), its train_run and the requests from its checkpoint; the probe rows per "
        "call at their first shape, "
        "launches from the probe path, library_ms the same work as torch.matmul (16 products; "
        "TF32 on for the tf32 and wgmma rows) or torch.bmm; the FMA and gather probe rows per "
        "call at their TPU script's first shape and method, library_ms torch.index_select into "
        "a preallocated output, none for the FMA chains; the reduction, transpose and fold "
        "probe rows per call at their script's first shape and method, library_ms 16 torch.sum "
        "or x.t().contiguous() in one graph (REP-16 sites), x.t().contiguous(), x.clone(), "
        "torch.sum over K then torch.index_select by the column map (the fold, two calls), "
        "none for the conv fold; the "
        "breakdown and knock-out rows per call at their script's shape (diff_ms at 3, 9, 3), "
        "none for the library; param_grad_reduce's library_ms one torch.mm per weight matrix "
        "over the valid workspace rows")
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s from the build to the kernels line")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
