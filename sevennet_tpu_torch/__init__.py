"""SevenNet on PyTorch and CUDA: the port of the JAX package ``sevennet_tpu``
to one NVIDIA H100, slice by slice. It imports ``torch``, numpy and scipy,
never JAX or the JAX package.

Ported so far: single-point serving of energy, forces and stress,
training, and NVE molecular dynamics (with the ring-chunked backward of
100k-atom systems), through the dense fused convolution, whose forward and
backward are hand-written CUDA kernels (``csrc/``)::

    from sevennet_tpu_torch import MDEngine, SevenNetCalculator, build_model_spec, train_run
    calc = SevenNetCalculator(spec, params)          # runs on cuda
    calc = SevenNetCalculator(spec, params, device="cpu")
    trainer = train_run(model_cfg, train_cfg, data_cfg, working_dir="wd")
    engine = MDEngine(spec, params, cell)            # runs on cuda
    state, (pe, ke) = engine.run(engine.make_state(pos, Z, temperature=300.0), 100, dt=0.5)
"""

__version__ = "0.1.0"

_LAZY = {
    "SevenNetCalculator": ("sevennet_tpu_torch.calculator", "SevenNetCalculator"),
    "build_model_spec": ("sevennet_tpu_torch.model.build", "build_model_spec"),
    "model_compute": ("sevennet_tpu_torch.model.model", "model_compute"),
    "params_from_numpy": ("sevennet_tpu_torch.io.convert", "params_from_numpy"),
    "Trainer": ("sevennet_tpu_torch.train.trainer", "Trainer"),
    "train_run": ("sevennet_tpu_torch.scripts.train", "train_run"),
    "MDEngine": ("sevennet_tpu_torch.md.engine", "MDEngine"),
}

__all__ = list(_LAZY) + ["__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'sevennet_tpu_torch' has no attribute {name!r}")
