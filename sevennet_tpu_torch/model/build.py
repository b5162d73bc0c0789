"""Config -> static model spec (the port's copy of
``sevennet_tpu/model/build.py``; reference ``build_E3_equivariant_model``,
``sevenn/model_build.py:448-636``).

The spec is a frozen tree of Python values describing every layer: irreps
schedules, tensor-product instructions, normalization constants, activation
names. Parameters live in a separate dictionary keyed by the same layer names
the reference uses in its checkpoints (``0_self_interaction_1`` etc.), so
weights carry across from the JAX package one to one
(:mod:`sevennet_tpu_torch.io.convert`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

from ..irreps import Irreps, infer_irreps_out
from ..ops.gate import GateSpec
from ..ops.linear import LinearSpec
from ..ops.mlp import ScalarMLPSpec
from ..ops.tensor_product import ConvTPSpec, FCTPSpec

__all__ = ["DEFAULT_MODEL_CONFIG", "InteractionLayerSpec", "ModelSpec", "build_model_spec"]


# mirrors reference _const.py DEFAULT_E3_EQUIVARIANT_MODEL_CONFIG (:95-135)
DEFAULT_MODEL_CONFIG: Dict[str, Any] = {
    "cutoff": 4.5,
    "channel": 32,
    "irreps_manual": False,
    "lmax": 1,
    "lmax_edge": -1,
    "lmax_node": -1,
    "is_parity": True,
    "num_convolution_layer": 3,
    "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": 8},
    "cutoff_function": {"cutoff_function_name": "poly_cut", "poly_cut_p_value": 6},
    "act_radial": "silu",
    "act_scalar": {"e": "silu", "o": "tanh"},
    "act_gate": {"e": "silu", "o": "tanh"},
    "weight_nn_hidden_neurons": [64, 64],
    "conv_denominator": 1.0,
    "train_denominator": False,
    "train_shift_scale": False,
    "use_bias_in_linear": False,
    "readout_as_fcn": False,
    "readout_fcn_hidden_neurons": [30, 30],
    "readout_fcn_activation": "relu",
    "self_connection_type": "nequip",
    "interaction_type": "nequip",
    "_normalize_sph": True,
    "shift": 0.0,
    "scale": 1.0,
}

# atomic symbols, index = atomic number (index 0 unused)
CHEMICAL_SYMBOLS = (
    "X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn "
    "Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W "
    "Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf "
    "Es Fm Md No Lr Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts Og"
).split()
ATOMIC_NUMBERS = {s: i for i, s in enumerate(CHEMICAL_SYMBOLS)}
NUM_UNIV_ELEMENT = 119  # reference _const.NUM_UNIV_ELEMENT


def symbols_to_type_map(species) -> Dict[int, int]:
    """['Hf','O'] -> {72: 0, 8: 1} (sorted by symbol, reference
    ``get_type_mapper_from_specie``, ``sevenn/nn/node_embedding.py:56-70``)."""
    type_map: Dict[int, int] = {}
    for s in sorted(species):
        z = ATOMIC_NUMBERS[s] if isinstance(s, str) else int(s)
        if z not in type_map:
            type_map[z] = len(type_map)
    return type_map


@dataclass(frozen=True)
class InteractionLayerSpec:
    t: int
    irreps_x: Irreps
    irreps_out: Irreps
    sc_type: str  # 'nequip' | 'linear' | 'none'
    sc_fctp: Optional[FCTPSpec]
    sc_linear: Optional[LinearSpec]
    si1: LinearSpec
    radial_mlp: ScalarMLPSpec
    conv: ConvTPSpec
    denominator_init: float
    si2: LinearSpec
    gate: GateSpec


@dataclass(frozen=True)
class ModelSpec:
    cutoff: float
    type_map: Tuple[Tuple[int, int], ...]  # ((z, type_index), ...)
    num_species: int
    radial_basis_num: int
    cutoff_fn: Tuple  # ('poly_cut', p) | ('XPLOR', r_on)
    lmax_edge: int
    parity: bool
    normalize_sph: bool
    irreps_filter: Irreps
    embed_linear: LinearSpec
    layers: Tuple[InteractionLayerSpec, ...]
    readout_as_fcn: bool
    readout1: Optional[LinearSpec]
    readout2: Optional[LinearSpec]
    readout_fcn: Optional[ScalarMLPSpec]
    readout_fcn_act: str
    rescale_mode: str  # 'scalar' | 'species' | 'modal'
    shift_init: Tuple  # floats, or tuples-of-floats for modal-wise
    scale_init: Tuple
    use_modal_wise_shift: bool = False
    use_modal_wise_scale: bool = False
    # names of linear layers that receive the modality one-hot appended to
    # their input (reference patch_modality, model_build.py:185-230)
    modal_linears: Tuple[str, ...] = ()
    train_denominator: bool = False
    train_shift_scale: bool = False
    use_bias: bool = False
    # multi-fidelity (appended 0e one-hot into selected linears)
    num_modalities: int = 0
    modal_map: Tuple[Tuple[str, int], ...] = ()
    # deploy-time modality pin (select_modality): overrides graph.modal
    pinned_modal: int = -1  # -1 = not pinned
    # The JAX package's execution policy (remat, edge chunks, dense K, fused
    # and ring conv paths, conv dtype). Kept so the two specs compare field
    # by field. The port always runs the dense fused conv (vec or emb/sh
    # mode, model/model.py:_vec_mode) with the K of each graph; of these it
    # reads only edge_chunk and conv_ring (model/model.py:conv_row_chunk:
    # the chunked and ring backward of large systems), which the MD engine
    # sets.
    remat_layers: bool = True
    edge_chunk: int = 0
    edge_dense_k: int = 0
    conv_custom_vjp: bool = False
    conv_fused: bool = False
    conv_param_grads: bool = True
    conv_ring: int = 0
    conv_dtype: str = "float32"

    @property
    def z_to_type(self):
        import numpy as np

        arr = -np.ones(120, dtype=np.int32)
        for z, t in self.type_map:
            arr[z] = t
        return arr


def build_model_spec(config: Dict[str, Any]) -> ModelSpec:
    cfg = copy.deepcopy(DEFAULT_MODEL_CONFIG)
    cfg.update(config or {})

    cutoff = float(cfg["cutoff"])
    num_conv = int(cfg["num_convolution_layer"])
    channel = int(cfg["channel"])
    parity = bool(cfg["is_parity"])
    use_bias = bool(cfg["use_bias_in_linear"])

    # species / type map
    if "_type_map" in cfg and cfg["_type_map"]:
        type_map = {int(k): int(v) for k, v in dict(cfg["_type_map"]).items()}
    else:
        species = cfg.get("chemical_species")
        if not species or species == "auto":
            raise ValueError("chemical_species (or _type_map) must be given")
        type_map = symbols_to_type_map(species)
    num_species = len(type_map)

    lmax = int(cfg["lmax"])
    lmax_edge = int(cfg["lmax_edge"]) if int(cfg.get("lmax_edge", -1)) > 0 else lmax
    lmax_node = int(cfg["lmax_node"]) if int(cfg.get("lmax_node", -1)) > 0 else lmax

    sph_p = -1 if parity else 1
    irreps_filter = Irreps.spherical_harmonics(lmax_edge, sph_p)

    rb = dict(cfg["radial_basis"])
    assert rb.get("radial_basis_name", "bessel") == "bessel"
    radial_basis_num = int(rb.get("bessel_basis_num", 8))

    cf = dict(cfg["cutoff_function"])
    cf_name = cf.get("cutoff_function_name", "poly_cut")
    if cf_name == "poly_cut":
        cutoff_fn = ("poly_cut", float(cf.get("poly_cut_p_value", 6)))
    elif cf_name == "XPLOR":
        cutoff_fn = ("XPLOR", float(cf["cutoff_on"]))
    else:
        raise ValueError(f"unknown cutoff function {cf_name}")

    # irreps schedule
    irreps_manual = cfg.get("irreps_manual") or False
    if irreps_manual is not False:
        irreps_manual = [Irreps(s) for s in irreps_manual]
        assert len(irreps_manual) == num_conv + 1

    # multi-fidelity modality (reference patch_modality, model_build.py:185-230)
    use_modality = bool(cfg.get("use_modality", False))
    num_modalities = int(cfg.get("num_modalities", 0)) if use_modality else 0
    modal_map = cfg.get("modal_map") or {}
    modal_irreps = (
        Irreps([(num_modalities, (0, 1))]) if num_modalities > 1 else Irreps()
    )
    modal_linears = []

    def _with_modal(irreps_in: Irreps, enabled: bool, name: str) -> Irreps:
        if num_modalities > 1 and enabled:
            modal_linears.append(name)
            return irreps_in + modal_irreps
        return irreps_in

    m_embed = bool(cfg.get("use_modal_node_embedding", False))
    m_intro = bool(cfg.get("use_modal_self_inter_intro", False))
    m_outro = bool(cfg.get("use_modal_self_inter_outro", False))
    m_out = bool(cfg.get("use_modal_output_block", False))

    one_hot_irreps = Irreps([(num_species, (0, 1))])
    irreps_x = (
        Irreps([(channel, (0, 1))]) if irreps_manual is False else irreps_manual[0]
    )
    embed_linear = LinearSpec(
        _with_modal(one_hot_irreps, m_embed, "onehot_to_feature_x"),
        irreps_x,
        biases=use_bias,
    )

    conv_denominator = cfg["conv_denominator"]
    if not isinstance(conv_denominator, (list, tuple)):
        conv_denominator = [float(conv_denominator)] * num_conv

    weight_nn_hidden = [int(h) for h in cfg["weight_nn_hidden_neurons"]]
    act_radial = str(cfg["act_radial"])
    act_scalar = tuple(sorted(dict(cfg["act_scalar"]).items()))
    act_gate = tuple(sorted(dict(cfg["act_gate"]).items()))

    sc_type_list = cfg["self_connection_type"]
    if isinstance(sc_type_list, str):
        sc_type_list = [sc_type_list] * num_conv

    # pre-v0.9 reference builders kept the last interaction layer full
    # (no lmax-0/even override); the readout linear drops non-scalars.
    # Needed to rebuild old deployed artifacts (io/torchscript_import.py).
    full_last_layer = bool(cfg.get("_full_last_layer", False))

    layers = []
    for t in range(num_conv):
        parity_mode = "full"
        cur_lmax = lmax_node
        if t == num_conv - 1 and not full_last_layer:
            cur_lmax = 0
            parity_mode = "even"
        irreps_out = (
            infer_irreps_out(
                irreps_x, irreps_filter, cur_lmax, parity_mode,
                fix_multiplicity=channel,
            )
            if irreps_manual is False
            else irreps_manual[t + 1]
        )
        irreps_out_tp = infer_irreps_out(
            irreps_x, irreps_filter, irreps_out.lmax, parity_mode, False
        )

        gate = GateSpec(irreps_out, act_scalar, act_gate)
        gate_in = gate.irreps_in

        sc_type = sc_type_list[t]
        sc_fctp = sc_linear = None
        if sc_type == "nequip":
            sc_fctp = FCTPSpec(irreps_x, one_hot_irreps, gate_in)
        elif sc_type == "linear":
            sc_linear = LinearSpec(irreps_x, gate_in)
        elif sc_type != "none":
            raise ValueError(f"unknown self_connection_type {sc_type}")

        si1 = LinearSpec(
            _with_modal(irreps_x, m_intro, f"{t}_self_interaction_1"),
            irreps_x,
            biases=use_bias,
        )
        conv = ConvTPSpec(irreps_x, irreps_filter, irreps_out_tp)
        radial_mlp = ScalarMLPSpec(
            tuple([radial_basis_num] + weight_nn_hidden + [conv.weight_numel]),
            act=act_radial,
        )
        # simplified mid irreps = Linear input (sorted blocks are contiguous)
        si2 = LinearSpec(
            _with_modal(conv.irreps_mid.simplify(), m_outro, f"{t}_self_interaction_2"),
            gate_in,
            biases=use_bias,
        )

        layers.append(
            InteractionLayerSpec(
                t=t,
                irreps_x=irreps_x,
                irreps_out=irreps_out,
                sc_type=sc_type,
                sc_fctp=sc_fctp,
                sc_linear=sc_linear,
                si1=si1,
                radial_mlp=radial_mlp,
                conv=conv,
                denominator_init=float(conv_denominator[t]),
                si2=si2,
                gate=gate,
            )
        )
        irreps_x = irreps_out

    # readout
    readout_as_fcn = bool(cfg["readout_as_fcn"])
    readout1 = readout2 = readout_fcn = None
    if readout_as_fcn:
        readout_fcn = ScalarMLPSpec(
            tuple(
                [irreps_x.dim]
                + [int(h) for h in cfg["readout_fcn_hidden_neurons"]]
                + [1]
            ),
            act=str(cfg["readout_fcn_activation"]),
        )
    else:
        hidden_mul = int(cfg.get("_readout_hidden_mul", 0)) or irreps_x.dim // 2
        hidden = Irreps([(hidden_mul, (0, 1))])
        readout1 = LinearSpec(
            _with_modal(irreps_x, m_out, "reduce_input_to_hidden"),
            hidden,
            biases=use_bias,
        )
        readout2 = LinearSpec(hidden, Irreps([(1, (0, 1))]), biases=use_bias)

    # shift / scale
    shift, scale = cfg["shift"], cfg["scale"]
    use_mw_shift = bool(cfg.get("use_modal_wise_shift", False))
    use_mw_scale = bool(cfg.get("use_modal_wise_scale", False))
    if num_modalities > 1 and (use_mw_shift or use_mw_scale):
        rescale_mode = "modal"
        shift = _resolve_modal(shift, type_map, num_modalities, use_mw_shift)
        scale = _resolve_modal(scale, type_map, num_modalities, use_mw_scale)
    elif isinstance(shift, (list, tuple)) or isinstance(scale, (list, tuple)):
        rescale_mode = "species"
        shift = _resolve_per_species(shift, type_map)
        scale = _resolve_per_species(scale, type_map)
    else:
        rescale_mode = "scalar"
        shift = (float(shift),)
        scale = (float(scale),)

    return ModelSpec(
        cutoff=cutoff,
        type_map=tuple(sorted(type_map.items(), key=lambda kv: kv[1])),
        num_species=num_species,
        radial_basis_num=radial_basis_num,
        cutoff_fn=cutoff_fn,
        lmax_edge=lmax_edge,
        parity=parity,
        normalize_sph=bool(cfg["_normalize_sph"]),
        irreps_filter=irreps_filter,
        embed_linear=embed_linear,
        layers=tuple(layers),
        readout_as_fcn=readout_as_fcn,
        readout1=readout1,
        readout2=readout2,
        readout_fcn=readout_fcn,
        readout_fcn_act=str(cfg["readout_fcn_activation"]),
        rescale_mode=rescale_mode,
        shift_init=tuple(shift),
        scale_init=tuple(scale),
        train_denominator=bool(cfg["train_denominator"]),
        train_shift_scale=bool(cfg["train_shift_scale"]),
        use_bias=use_bias,
        num_modalities=num_modalities,
        modal_map=tuple(sorted(dict(modal_map).items(), key=lambda kv: kv[1])),
        pinned_modal=int(cfg.get("_pinned_modal", -1)),
        use_modal_wise_shift=bool(cfg.get("use_modal_wise_shift", False)),
        use_modal_wise_scale=bool(cfg.get("use_modal_wise_scale", False)),
        modal_linears=tuple(modal_linears),
        remat_layers=bool(cfg.get("_remat", True)),
        edge_chunk=int(cfg.get("_edge_chunk", 0)),
        edge_dense_k=int(cfg.get("_edge_dense_k", 0)),
        conv_custom_vjp=bool(cfg.get("_conv_custom_vjp", False)),
        conv_ring=int(cfg.get("_conv_ring", 0) or 0),
        conv_dtype=str(cfg.get("_conv_dtype", "float32")),
    )


def _resolve_modal(v, type_map, num_modalities: int, modal_wise: bool):
    """Resolve shift/scale into a (num_modalities, num_species) nested tuple
    (or per-species when not modal-wise) — reference ModalWiseRescale
    semantics (``sevenn/nn/scale.py:469-569``)."""
    n = len(type_map)
    if not modal_wise:
        return tuple(_resolve_per_species(v, type_map))
    if isinstance(v, (int, float)):
        return tuple(tuple([float(v)] * n) for _ in range(num_modalities))
    v = list(v)
    if v and isinstance(v[0], (list, tuple)):
        assert len(v) == num_modalities
        return tuple(tuple(_resolve_per_species(list(row), type_map)) for row in v)
    if len(v) == num_modalities:
        return tuple(tuple([float(x)] * n) for x in v)
    # per-species list shared across modalities
    row = _resolve_per_species(v, type_map)
    return tuple(tuple(row) for _ in range(num_modalities))


def _resolve_per_species(v: Union[float, list, tuple], type_map: Dict[int, int]):
    n = len(type_map)
    if isinstance(v, (int, float)):
        return [float(v)] * n
    v = list(v)
    if len(v) == n:
        return [float(x) for x in v]
    if len(v) == NUM_UNIV_ELEMENT:
        # per-atomic-number list -> per-type
        out = [0.0] * n
        for z, t in type_map.items():
            out[t] = float(v[z])
        return out
    if len(v) == 1:
        return [float(v[0])] * n
    raise ValueError(f"cannot resolve shift/scale of length {len(v)} for {n} species")
