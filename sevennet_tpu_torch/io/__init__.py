"""Weights and checkpoints: the JAX package's parameter trees
(:mod:`.convert`), the port's and the JAX package's checkpoint directories
(:mod:`.native_checkpoint`, through :mod:`.msgpack`), stock SevenNet
``.pth`` files (:mod:`.torch_checkpoint`), the reference's frozen
TorchScript deployments (:mod:`.torchscript_import`) and pretrained names,
found locally or downloaded against pinned digests (:mod:`.registry`)."""

from .convert import params_from_numpy, params_to_numpy
from .native_checkpoint import load_checkpoint, load_native_checkpoint, save_checkpoint
from .registry import (
    download_checkpoint,
    get_available_pretrained_models,
    load_model,
    resolve_checkpoint,
)
from .torchscript_import import deployed_metadata, load_deployed_model

__all__ = [
    "params_from_numpy",
    "params_to_numpy",
    "save_checkpoint",
    "load_native_checkpoint",
    "load_checkpoint",
    "resolve_checkpoint",
    "download_checkpoint",
    "load_deployed_model",
    "deployed_metadata",
    "get_available_pretrained_models",
    "load_model",
]
