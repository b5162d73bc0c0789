"""Carry weights across from the JAX package.

The JAX package keeps its parameters in a tree keyed by the reference's
layer names (``sevennet_tpu/model/model.py:32-67``). A caller that has
turned that tree into numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) hands it to :func:`params_from_numpy`, which checks every shape
against the port's spec and returns the same tree of fp32 tensors. The port
itself never sees a JAX object.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..model.build import ModelSpec
from ..ops.radial import bessel_coeffs_init

__all__ = ["params_from_numpy", "params_to_numpy", "expected_shapes", "random_params"]


def _linear_shapes(spec) -> Dict[str, Any]:
    out: Dict[str, Any] = {"w": [tuple(s) for s in spec.weight_shapes]}
    if spec.biases:
        out["b"] = (spec.bias_numel,)
    return out


def expected_shapes(spec: ModelSpec) -> Dict[str, Any]:
    """The parameter tree of ``spec`` with a shape in place of every array."""
    shapes: Dict[str, Any] = {
        "edge_embedding": {"bessel_coeffs": (spec.radial_basis_num,)},
        "onehot_to_feature_x": _linear_shapes(spec.embed_linear),
    }
    for layer in spec.layers:
        t = layer.t
        if layer.sc_type == "nequip":
            shapes[f"{t}_self_connection_intro"] = {
                "w": [tuple(s) for s in layer.sc_fctp.weight_shapes]
            }
        elif layer.sc_type == "linear":
            shapes[f"{t}_self_connection_intro"] = _linear_shapes(layer.sc_linear)
        shapes[f"{t}_self_interaction_1"] = _linear_shapes(layer.si1)
        dims = layer.radial_mlp.dims
        shapes[f"{t}_convolution"] = {
            "weight_nn": {"w": [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]},
            "denominator": (1,),
        }
        shapes[f"{t}_self_interaction_2"] = _linear_shapes(layer.si2)
    if spec.readout_as_fcn:
        dims = spec.readout_fcn.dims
        shapes["readout_FCN"] = {"w": [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]}
    else:
        shapes["reduce_input_to_hidden"] = _linear_shapes(spec.readout1)
        shapes["reduce_hidden_to_energy"] = _linear_shapes(spec.readout2)
    rescale = np.asarray(spec.shift_init).shape
    shapes["rescale_atomic_energy"] = {
        "shift": rescale,
        "scale": np.asarray(spec.scale_init).shape,
    }
    return shapes


def _convert(shape, value, path: str):
    if isinstance(shape, dict):
        if not isinstance(value, dict) or set(value) != set(shape):
            got = sorted(value) if isinstance(value, dict) else type(value).__name__
            raise ValueError(f"{path or 'params'}: expected keys {sorted(shape)}, got {got}")
        return {k: _convert(shape[k], value[k], f"{path}/{k}") for k in shape}
    if isinstance(shape, list):
        if not isinstance(value, (list, tuple)) or len(value) != len(shape):
            raise ValueError(f"{path}: expected a list of {len(shape)} arrays")
        return [_convert(s, v, f"{path}[{i}]") for i, (s, v) in enumerate(zip(shape, value))]
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{path}: expected shape {tuple(shape)}, got {arr.shape}")
    return torch.as_tensor(np.array(arr, np.float32))


def params_from_numpy(spec: ModelSpec, tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> the port's tree of CPU fp32
    tensors, after checking every key and shape against ``spec``."""
    return _convert(expected_shapes(spec), tree, "")


def random_params(spec: ModelSpec, seed: int = 0) -> Dict[str, Any]:
    """A numpy parameter tree for ``spec`` drawn from ``seed``: standard
    normal weights (the JAX package's ``model_init`` draws the same
    distribution), Bessel coefficients ``n*pi/rc``, the spec's denominators,
    shift and scale. For runs that need realistic widths, not trained
    weights."""
    rng = np.random.default_rng(seed)
    shapes = expected_shapes(spec)

    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        if isinstance(shape, list):
            return [draw(s) for s in shape]
        return rng.standard_normal(shape).astype(np.float32)

    tree = draw(shapes)
    tree["edge_embedding"]["bessel_coeffs"] = bessel_coeffs_init(spec.cutoff, spec.radial_basis_num)
    for layer in spec.layers:
        conv = tree[f"{layer.t}_convolution"]
        conv["denominator"] = np.asarray([layer.denominator_init], np.float32)
        for name in ("self_interaction_1", "self_interaction_2", "self_connection_intro"):
            p = tree.get(f"{layer.t}_{name}")
            if p is not None and "b" in p:
                p["b"] = np.zeros_like(p["b"])
    tree["rescale_atomic_energy"] = {
        "shift": np.asarray(spec.shift_init, np.float32),
        "scale": np.asarray(spec.scale_init, np.float32),
    }
    return tree


def params_to_numpy(params: Any) -> Any:
    """Inverse of :func:`params_from_numpy`: the same tree with numpy leaves."""
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params
