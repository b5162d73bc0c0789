from .build import DEFAULT_MODEL_CONFIG, ModelSpec, build_model_spec
from .model import model_compute, model_energy

__all__ = [
    "DEFAULT_MODEL_CONFIG",
    "ModelSpec",
    "build_model_spec",
    "model_compute",
    "model_energy",
]
