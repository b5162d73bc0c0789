"""Weights and checkpoints: the JAX package's parameter trees
(:mod:`.convert`), the port's and the JAX package's checkpoint directories
(:mod:`.native_checkpoint`, through :mod:`.msgpack`), stock SevenNet
``.pth`` files (:mod:`.torch_checkpoint`) and pretrained names
(:mod:`.registry`)."""

from .convert import params_from_numpy, params_to_numpy
from .native_checkpoint import load_checkpoint, load_native_checkpoint, save_checkpoint
from .registry import get_available_pretrained_models, load_model, resolve_checkpoint

__all__ = [
    "params_from_numpy",
    "params_to_numpy",
    "save_checkpoint",
    "load_native_checkpoint",
    "load_checkpoint",
    "resolve_checkpoint",
    "get_available_pretrained_models",
    "load_model",
]
