"""Model architectures of the stock checkpoints, as config dicts for
:func:`~sevennet_tpu_torch.model.build.build_model_spec` (the port's copy of
what it needs of ``sevennet_tpu/cli/main.py``'s presets).

``MF_OMPA`` is SevenNet-MF-ompa, the architecture of the ``7net-mf-ompa``
checkpoint (the ``mf_ompa_fine_tune`` preset): five parity layers up to
``lmax`` 3, 6 Å cutoff with an XPLOR envelope from 5.5 Å, and two
modalities, ``mpa`` and ``omat24``, appended as a one-hot to the self
interactions and the readout, with a modal-wise energy shift. Give it
``chemical_species``; its weights come from a checkpoint or from
:func:`~sevennet_tpu_torch.io.convert.random_params`.

``WIDE4_LAYER`` is no published model but a layer shape for the fused-conv
kernels: mf-ompa's widest parity irreps at twice their channels (x of
2,560 columns) into ``128x0e``, its second conv layer the narrowest shape
seen to need a thread-block cluster of 4 CTAs a receiver row (mf-ompa's
layers 2-3 take 2). The tests and ``chip_smoke.py`` hold the 4-CTA
kernels against plain at it.
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["MF_OMPA", "WIDE4_LAYER"]

MF_OMPA: Dict[str, Any] = {
    "cutoff": 6.0,
    "channel": 128,
    "irreps_manual": [
        "128x0e",
        "128x0e+64x1o+32x2e+32x3o",
        "128x0e+64x1o+64x1e+32x2o+32x2e+32x3o+32x3e",
        "128x0o+128x0e+64x1o+64x1e+32x2o+32x2e+32x3o+32x3e",
        "128x0e+64x1o+32x2e+32x3o",
        "128x0e",
    ],
    "lmax": 3,
    "is_parity": True,
    "num_convolution_layer": 5,
    "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": 8},
    "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 5.5},
    "weight_nn_hidden_neurons": [64, 64],
    "train_denominator": False,
    "train_shift_scale": False,
    "use_modality": True,
    "use_modal_node_embedding": False,
    "use_modal_self_inter_intro": True,
    "use_modal_self_inter_outro": True,
    "use_modal_output_block": True,
    "use_modal_wise_shift": True,
    "self_connection_type": "linear",
    "num_modalities": 2,
    "modal_map": {"mpa": 0, "omat24": 1},
}

WIDE4_LAYER: Dict[str, Any] = dict(
    MF_OMPA,
    irreps_manual=["128x0e", "256x0e+128x1o+128x1e+64x2o+64x2e+64x3o+64x3e", "128x0e"],
    num_convolution_layer=2,
)
