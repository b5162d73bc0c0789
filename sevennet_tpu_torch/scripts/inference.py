"""Batch inference: checkpoint + structures -> per-graph and per-atom CSV
files and an error summary (the port of ``sevennet_tpu/scripts/
inference.py``; the reference ``sevenn/scripts/inference.py:141-255``).

The targets are read by :meth:`~sevennet_tpu_torch.data.dataset.
GraphDataset.from_files` (extxyz, OUTCAR, POSCAR, structure_list) and
evaluated in dense batches on ``device`` (``cuda`` unless ``"cpu"``).
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..data.dataset import GraphDataset
from ..device import resolve_device
from ..train.error_recorder import ErrorRecorder, RecorderSpec

__all__ = ["inference"]

# the reference's inference metric table (scripts/inference.py:141-255 via
# util.get_error_recorder): RMSE and MAE per channel, plus the
# per-component force RMSE
METRICS = [
    ("Energy", "RMSE"), ("Energy", "MAE"),
    ("Force", "RMSE"), ("Force", "ComponentRMSE"), ("Force", "MAE"),
    ("Stress", "RMSE"), ("Stress", "MAE"),
]


def inference(
    checkpoint: str,
    targets: List[str],
    output_dir: str = "sevennet_tpu_infer_result",
    batch_size: int = 4,
    save_graph: bool = False,
    device: Optional[str] = None,
):
    """Evaluates every structure of ``targets`` with the model
    ``checkpoint`` (a pretrained name, ``.pth`` or checkpoint directory);
    writes ``per_graph.csv``, ``per_atom.csv`` and ``errors.txt`` into
    ``output_dir`` and returns the errors dict. ``save_graph`` is accepted
    for the JAX package's signature and, as there, unused."""
    from ..io.registry import load_model
    from ..model.model import model_compute, params_to

    dev = resolve_device(device)
    spec, params = load_model(checkpoint)
    params = params_to(params, dev)
    ds = GraphDataset.from_files(targets, spec.cutoff)
    ds.build(spec.z_to_type)
    acc = ErrorRecorder(RecorderSpec.from_config(METRICS))

    per_graph_rows = []
    per_atom_rows = []
    gi = 0
    for gb in ds.batches(batch_size):
        gb = gb.to(dev)
        out = model_compute(spec, params, gb, device=dev)
        acc.update(out, gb)
        e = out["energy"].cpu().numpy()
        s = out["stress"].cpu().numpy()
        fpred = out["forces"].cpu().numpy()
        batch_of = gb.batch.cpu().numpy()
        mask = gb.atom_mask.cpu().numpy()
        gmask = gb.graph_mask.cpu().numpy()
        e_ref = gb.energy.cpu().numpy()
        f_ref = gb.forces.cpu().numpy()
        natoms = gb.num_atoms.cpu().numpy()
        for b in range(gb.n_graphs_cap):
            if not gmask[b]:
                continue
            per_graph_rows.append(
                dict(
                    idx=gi,
                    natoms=int(natoms[b]),
                    energy=float(e[b]),
                    ref_energy=float(e_ref[b]),
                    stress_xx=float(s[b, 0]),
                )
            )
            gi += 1
        for a in range(gb.n_atoms_cap):
            if not mask[a]:
                continue
            per_atom_rows.append(
                dict(
                    graph=int(batch_of[a]),
                    fx=float(fpred[a, 0]), fy=float(fpred[a, 1]), fz=float(fpred[a, 2]),
                    ref_fx=float(f_ref[a, 0]), ref_fy=float(f_ref[a, 1]),
                    ref_fz=float(f_ref[a, 2]),
                )
            )

    os.makedirs(output_dir, exist_ok=True)
    _write_csv(os.path.join(output_dir, "per_graph.csv"), per_graph_rows)
    _write_csv(os.path.join(output_dir, "per_atom.csv"), per_atom_rows)
    errors = acc.get_metric_dict(with_unit=True)
    with open(os.path.join(output_dir, "errors.txt"), "w") as f_:
        for k, v in errors.items():
            f_.write(f"{k}: {v}\n")
    return errors


def _write_csv(path: str, rows):
    if not rows:
        return
    cols = list(rows[0].keys())
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(r[c]) for c in cols) + "\n")
