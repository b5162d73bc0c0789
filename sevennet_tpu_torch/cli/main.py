"""``sevennet-tpu-torch`` CLI (the port of ``sevennet_tpu/cli/main.py``): one
entry with subcommands, mirroring the reference ``sevenn`` binary
(``sevenn/main/sevenn.py:244-279``):

  train        train from input.yaml
  inference    batch evaluation -> CSVs + error summary
  graph_build  preprocess dataset -> statistics json
  preset       print a preset input.yaml
  checkpoint   inspect a checkpoint / regenerate input yaml
  get_model    export a checkpoint of the port's format from any source
  md           run molecular dynamics from a yaml input (the role LAMMPS
               input scripts play for the reference's pair styles)

The commands that compute (``train``, ``inference``, ``md``) take
``--device`` (default ``cuda``). PyYAML is imported only where a command
reads or writes YAML. The presets are the JAX package's, verbatim.
"""

from __future__ import annotations

import argparse
import json
import sys

PRESETS = {
    "base": """# SevenNet-TPU base preset
model:
    chemical_species: 'auto'
    cutoff: 5.0
    channel: 32
    is_parity: False
    lmax: 2
    num_convolution_layer: 3
    weight_nn_hidden_neurons: [64, 64]
    radial_basis:
        radial_basis_name: 'bessel'
        bessel_basis_num: 8
    cutoff_function:
        cutoff_function_name: 'XPLOR'
        cutoff_on: 4.5
    act_gate: {'e': 'silu', 'o': 'tanh'}
    act_scalar: {'e': 'silu', 'o': 'tanh'}
    conv_denominator: 'avg_num_neigh'
    self_connection_type: 'linear'
train:
    random_seed: 1
    is_train_stress: True
    epoch: 100
    loss: 'Huber'
    loss_param:
        delta: 0.01
    optimizer: 'adam'
    optim_param:
        lr: 0.01
    scheduler: 'linearlr'
    scheduler_param:
        start_factor: 1.0
        total_iters: 100
        end_factor: 0.0001
    force_loss_weight: 1.0
    stress_loss_weight: 0.01
data:
    batch_size: 8
    shift: 'elemwise_reference_energies'
    scale: 'force_rms'
    load_trainset_path: ['./train.extxyz']
""",
    "fine_tune": """# fine-tune from an existing checkpoint
model: {}
train:
    epoch: 50
    optimizer: 'adam'
    optim_param:
        lr: 0.0001
    continue:
        checkpoint: './checkpoint_best'
data:
    batch_size: 8
    load_trainset_path: ['./train.extxyz']
""",
    "sevennet-0": """# SevenNet-0 architecture (reference presets/sevennet-0.yaml)
model:
    chemical_species: 'auto'
    cutoff: 5.0
    channel: 128
    is_parity: False
    lmax: 2
    num_convolution_layer: 5
    irreps_manual:
        - "128x0e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e"
    weight_nn_hidden_neurons: [64, 64]
    radial_basis:
        radial_basis_name: 'bessel'
        bessel_basis_num: 8
    cutoff_function:
        cutoff_function_name: 'XPLOR'
        cutoff_on: 4.5
    act_gate: {'e': 'silu', 'o': 'tanh'}
    act_scalar: {'e': 'silu', 'o': 'tanh'}
    conv_denominator: 'avg_num_neigh'
    train_shift_scale: False
    train_denominator: False
    self_connection_type: 'linear'
train:
    random_seed: 1
    is_train_stress: True
    epoch: 600
    loss: 'Huber'
    loss_param:
        delta: 0.01
    optimizer: 'adam'
    optim_param:
        lr: 0.01
    scheduler: 'linearlr'
    scheduler_param:
        start_factor: 1.0
        total_iters: 600
        end_factor: 0.0001
    force_loss_weight: 1.0
    stress_loss_weight: 0.01
data:
    batch_size: 16
    scale: 'per_atom_energy_std'
    shift: 'elemwise_reference_energies'
    load_trainset_path: ['./train.extxyz']
""",
    "sevennet-l3i5": """# SevenNet-l3i5 architecture (lmax 3)
model:
    chemical_species: 'auto'
    cutoff: 5.0
    channel: 128
    is_parity: False
    lmax: 3
    num_convolution_layer: 5
    weight_nn_hidden_neurons: [64, 64]
    radial_basis:
        radial_basis_name: 'bessel'
        bessel_basis_num: 8
    cutoff_function:
        cutoff_function_name: 'XPLOR'
        cutoff_on: 4.5
    conv_denominator: 'avg_num_neigh'
    self_connection_type: 'linear'
train:
    epoch: 600
    loss: 'Huber'
    loss_param:
        delta: 0.01
    optimizer: 'adam'
    optim_param:
        lr: 0.01
    scheduler: 'linearlr'
    scheduler_param:
        start_factor: 1.0
        total_iters: 600
        end_factor: 0.0001
    force_loss_weight: 1.0
    stress_loss_weight: 0.01
data:
    batch_size: 16
    scale: 'per_atom_energy_std'
    shift: 'elemwise_reference_energies'
    load_trainset_path: ['./train.extxyz']
""",
    "multi_modal": """# multi-fidelity (modality) training
model:
    chemical_species: 'auto'
    cutoff: 5.0
    channel: 64
    is_parity: False
    lmax: 2
    num_convolution_layer: 4
    self_connection_type: 'linear'
    conv_denominator: 'avg_num_neigh'
    use_modality: True
    num_modalities: 2
    modal_map: {'pbe': 0, 'scan': 1}
    use_modal_node_embedding: False
    use_modal_self_inter_intro: True
    use_modal_self_inter_outro: True
    use_modal_output_block: True
    use_modal_wise_shift: True
    use_modal_wise_scale: False
train:
    epoch: 200
    loss: 'Huber'
    loss_param:
        delta: 0.01
    optimizer: 'adam'
    optim_param:
        lr: 0.004
data:
    batch_size: 8
    shift: 'elemwise_reference_energies'
    scale: 'force_rms'
    load_trainset_path: ['./train_pbe.extxyz']
""",
    "mf_0": """# SevenNet-MF-0: multi-fidelity SevenNet-0 architecture
# (reference presets/MF_0.yaml; arXiv:2409.07947)
model:
    chemical_species: 'auto'
    cutoff: 5.0
    channel: 128
    is_parity: False
    lmax: 2
    num_convolution_layer: 5
    irreps_manual:
        - "128x0e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e"
    weight_nn_hidden_neurons: [64, 64]
    radial_basis:
        radial_basis_name: 'bessel'
        bessel_basis_num: 8
    cutoff_function:
        cutoff_function_name: 'XPLOR'
        cutoff_on: 4.5
    conv_denominator: 'avg_num_neigh'
    train_shift_scale: False
    train_denominator: False
    self_connection_type: 'linear'
    use_modality: True
    use_modal_node_embedding: False
    use_modal_self_inter_intro: True
    use_modal_self_inter_outro: True
    use_modal_output_block: True
    use_modal_wise_shift: True
    use_modal_wise_scale: False
train:
    random_seed: 777
    is_train_stress: True
    epoch: 200
    loss: 'Huber'
    loss_param:
        delta: 0.01
    optimizer: 'adam'
    optim_param:
        lr: 0.01
    scheduler: 'linearlr'
    scheduler_param:
        start_factor: 1.0
        total_iters: 200
        end_factor: 0.0001
    force_loss_weight: 1.00
    stress_loss_weight: 0.01
data:
    batch_size: 4
    shift: 'elemwise_reference_energies'
    scale: 'force_rms'
    data_divide_ratio: 0.1
""",
    "mf_ompa_fine_tune": """# fine-tune SevenNet-MF-ompa
# (reference presets/mf_ompa_fine_tune.yaml; architecture is fixed)
model:
    cutoff: 6.0
    channel: 128
    irreps_manual:
        - "128x0e"
        - "128x0e+64x1o+32x2e+32x3o"
        - "128x0e+64x1o+64x1e+32x2o+32x2e+32x3o+32x3e"
        - "128x0o+128x0e+64x1o+64x1e+32x2o+32x2e+32x3o+32x3e"
        - "128x0e+64x1o+32x2e+32x3o"
        - "128x0e"
    lmax: 3
    is_parity: True
    num_convolution_layer: 5
    radial_basis:
        radial_basis_name: 'bessel'
        bessel_basis_num: 8
    cutoff_function:
        cutoff_function_name: 'XPLOR'
        cutoff_on: 5.5
    weight_nn_hidden_neurons: [64, 64]
    train_denominator: False
    train_shift_scale: False
    use_modality: True
    use_modal_node_embedding: False
    use_modal_self_inter_intro: True
    use_modal_self_inter_outro: True
    use_modal_output_block: True
    use_modal_wise_shift: True
    self_connection_type: 'linear'
train:
    random_seed: 777
    is_train_stress: True
    epoch: 100
    loss: 'Huber'
    loss_param:
        delta: 0.01
    optimizer: 'adam'
    optim_param:
        lr: 0.0002
    scheduler: 'linearlr'
    scheduler_param:
        start_factor: 1.0
        total_iters: 100
        end_factor: 0.01
    force_loss_weight: 1.00
    stress_loss_weight: 0.01
    continue:
        checkpoint: '7net-mf-ompa'
        use_statistic_values_of_checkpoint: True
data:
    batch_size: 4
""",
    "fine_tune_le": """# 7net-0 fine-tuning for liquid electrolytes
# (reference presets/fine_tune_le.yaml; arXiv:2501.05211)
model:
    chemical_species: 'auto'
    cutoff: 5.0
    channel: 128
    is_parity: False
    lmax: 2
    num_convolution_layer: 5
    irreps_manual:
        - "128x0e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e+64x1e+32x2e"
        - "128x0e"
    weight_nn_hidden_neurons: [64, 64]
    radial_basis:
        radial_basis_name: 'bessel'
        bessel_basis_num: 8
    cutoff_function:
        cutoff_function_name: 'XPLOR'
        cutoff_on: 4.5
    self_connection_type: 'linear'
train:
    random_seed: 777
    is_train_stress: False
    epoch: 100
    loss: 'Huber'
    loss_param:
        delta: 0.01
    optimizer: 'adam'
    optim_param:
        lr: 0.0001
    force_loss_weight: 1.00
    continue:
        checkpoint: '7net-0'
        use_statistic_values_of_checkpoint: True
data:
    batch_size: 4
""",
}


def _reconstructed_config(spec):
    """A minimal model config of a spec (a stock ``.pth`` carries none of
    the port's format), as the JAX package rebuilds it."""
    return {
        "cutoff": spec.cutoff,
        "_type_map": dict(spec.type_map),
        "num_convolution_layer": len(spec.layers),
        "irreps_manual": [repr(spec.layers[0].irreps_x)]
        + [repr(l.irreps_out) for l in spec.layers],
        "lmax": spec.lmax_edge,
        "is_parity": spec.parity,
        "radial_basis": {"bessel_basis_num": spec.radial_basis_num},
        "cutoff_function": (
            {"cutoff_function_name": "poly_cut", "poly_cut_p_value": spec.cutoff_fn[1]}
            if spec.cutoff_fn[0] == "poly_cut"
            else {"cutoff_function_name": "XPLOR", "cutoff_on": spec.cutoff_fn[1]}
        ),
        "self_connection_type": spec.layers[0].sc_type,
        "conv_denominator": [l.denominator_init for l in spec.layers],
        "shift": list(spec.shift_init),
        "scale": list(spec.scale_init),
        "train_shift_scale": spec.train_shift_scale,
        "train_denominator": spec.train_denominator,
        "use_bias_in_linear": spec.use_bias,
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="sevennet-tpu-torch",
                                description="SevenNet on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    pt = sub.add_parser("train", help="train from input.yaml")
    pt.add_argument("input", help="input.yaml")
    pt.add_argument("--working_dir", default=".")
    pt.add_argument("--epochs", type=int, default=None)
    device_arg(pt)

    pi = sub.add_parser("inference", help="batch inference")
    pi.add_argument("checkpoint")
    pi.add_argument("targets", nargs="+")
    pi.add_argument("--output", default="sevennet_tpu_infer_result")
    pi.add_argument("--batch", type=int, default=4)
    device_arg(pi)

    pg = sub.add_parser("graph_build", help="preprocess dataset, print statistics")
    pg.add_argument("source", nargs="+")
    pg.add_argument("--cutoff", type=float, required=True)
    pg.add_argument("--out", default="graph_stats.json")

    pp = sub.add_parser("preset", help="print preset yaml")
    pp.add_argument("name", choices=sorted(PRESETS.keys()))

    pc = sub.add_parser("checkpoint", help="inspect checkpoint")
    pc.add_argument("path")
    pc.add_argument("--get_yaml", action="store_true")

    pm = sub.add_parser("get_model", help="convert any checkpoint to the port's format")
    pm.add_argument("source")
    pm.add_argument("--out", default="deployed_model")

    pd = sub.add_parser("md", help="run molecular dynamics from a yaml input")
    pd.add_argument("input", help="md yaml (see sevennet_tpu_torch/scripts/md_run.py)")
    device_arg(pd)

    args = p.parse_args(argv)

    if args.cmd == "md":
        import yaml

        from ..scripts.md_run import run_md_from_config

        with open(args.input) as f:
            cfg = yaml.safe_load(f)
        run_md_from_config(cfg, device=args.device)
        return 0

    if args.cmd == "preset":
        print(PRESETS[args.name])
        return 0

    if args.cmd == "train":
        from ..scripts.train import train_from_yaml

        train_from_yaml(args.input, args.working_dir, args.epochs, device=args.device)
        return 0

    if args.cmd == "inference":
        from ..scripts.inference import inference

        errors = inference(args.checkpoint, args.targets, args.output, args.batch,
                           device=args.device)
        print(json.dumps(errors, indent=1))
        return 0

    if args.cmd == "graph_build":
        from ..data.dataset import GraphDataset

        ds = GraphDataset.from_files(args.source, args.cutoff)
        stats = ds.statistics
        with open(args.out, "w") as f:
            json.dump(stats, f, indent=1)
        print(json.dumps({k: v for k, v in stats.items()
                          if k != "elemwise_reference_energies"}, indent=1))
        return 0

    if args.cmd == "checkpoint":
        from ..io.native_checkpoint import FORMAT, load_checkpoint

        spec, params, meta = load_checkpoint(args.path)
        info = {
            "format": meta.get("format", FORMAT),
            "cutoff": spec.cutoff,
            "num_species": spec.num_species,
            "type_map": dict(spec.type_map),
            "layers": len(spec.layers),
            "irreps": [repr(l.irreps_out) for l in spec.layers],
            "epoch": meta.get("epoch"),
        }
        print(json.dumps(info, indent=1))
        if args.get_yaml:
            cfg = meta.get("model_config")
            if cfg:
                import yaml

                print(yaml.dump({"model": cfg}, default_flow_style=False))
        return 0

    if args.cmd == "get_model":
        import os.path as osp

        from ..io.native_checkpoint import load_checkpoint, save_checkpoint
        from ..io.registry import resolve_checkpoint

        source = resolve_checkpoint(args.source)  # name / .pth / checkpoint dir
        if source.endswith(".msgpack"):
            source = osp.dirname(source) or "."
        if osp.isdir(source):
            spec, params, meta = load_checkpoint(source)
        else:
            from ..io.torch_checkpoint import load_sevennet_checkpoint

            spec, params = load_sevennet_checkpoint(source)
            meta = {}
        cfg = meta.get("model_config") or _reconstructed_config(spec)
        save_checkpoint(args.out, cfg, params)
        print(f"saved the port's checkpoint to {args.out}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
