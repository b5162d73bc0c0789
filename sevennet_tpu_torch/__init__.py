"""SevenNet on PyTorch and CUDA: the port of the JAX package ``sevennet_tpu``
to one NVIDIA H100, slice by slice. It imports ``torch``, numpy and scipy,
never JAX or the JAX package.

Ported: single-point and batched serving of energy, forces and stress
(from a spec with parameters, a checkpoint or a pretrained name), training
(also multi-fidelity), molecular dynamics in NVE, NVT and NPT (with the
ring-chunked backward of 100k-atom systems) on one card or decomposed over
``torch.distributed`` ranks, each with Grimme D3 dispersion on request, the
``sevennet-tpu-torch`` command line and its scripts, all through the dense
fused convolution, whose forward and backward are hand-written CUDA
kernels (``csrc/``)::

    from sevennet_tpu_torch import MDEngine, SevenNetCalculator, build_model_spec, train_run
    calc = SevenNetCalculator(spec, params)          # runs on cuda
    calc = SevenNetCalculator("7net-0", device="cpu")  # a name, .pth or checkpoint dir
    calc_d3 = calc.with_d3("pbe", "damp_bj")         # + D3 dispersion
    trainer = train_run(model_cfg, train_cfg, data_cfg, working_dir="wd")
    engine = MDEngine(spec, params, cell)            # runs on cuda
    engine = MDEngine(spec, params, cell, d3={"functional": "pbe", "damping": "damp_bj"})
    state, (pe, ke) = engine.run(engine.make_state(pos, Z, temperature=300.0), 100, dt=0.5,
                                 integrator="npt", temperature=300.0, pressure=0.0)
"""

__version__ = "0.1.0"

_LAZY = {
    "SevenNetCalculator": ("sevennet_tpu_torch.calculator", "SevenNetCalculator"),
    "SevenNetD3Calculator": ("sevennet_tpu_torch.calculator", "SevenNetD3Calculator"),
    "D3Calculator": ("sevennet_tpu_torch.d3", "D3Calculator"),
    "build_model_spec": ("sevennet_tpu_torch.model.build", "build_model_spec"),
    "model_compute": ("sevennet_tpu_torch.model.model", "model_compute"),
    "params_from_numpy": ("sevennet_tpu_torch.io.convert", "params_from_numpy"),
    "load_model": ("sevennet_tpu_torch.io.registry", "load_model"),
    "MultiModalDataset": ("sevennet_tpu_torch.data.modal_dataset", "MultiModalDataset"),
    "Trainer": ("sevennet_tpu_torch.train.trainer", "Trainer"),
    "train_run": ("sevennet_tpu_torch.scripts.train", "train_run"),
    "MDEngine": ("sevennet_tpu_torch.md.engine", "MDEngine"),
    "BatchedCalculator": ("sevennet_tpu_torch.batched", "BatchedCalculator"),
    "DistributedMDEngine": ("sevennet_tpu_torch.parallel.md", "DistributedMDEngine"),
}

__all__ = list(_LAZY) + ["__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'sevennet_tpu_torch' has no attribute {name!r}")
