"""The port stands alone: nothing under ``sevennet_tpu_torch/``, nor
``chip_smoke.py``, ``conv_breakdown.py`` or ``ab_compare.py``, imports JAX, flax, optax or the
JAX package, and its entry points never drift to the CPU when no card is
present."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sevennet_tpu"}


def _port_files():
    return sorted((ROOT / "sevennet_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "conv_breakdown.py", ROOT / "ab_compare.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


def test_port_modules_load_without_jax():
    code = (
        "import sys, importlib, pkgutil, sevennet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'sevennet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'optax', 'sevennet_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def _tiny_spec_params():
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.build import build_model_spec

    spec = build_model_spec({"channel": 4, "lmax": 1, "num_convolution_layer": 1,
                             "chemical_species": ["O"]})
    return spec, params_from_numpy(spec, random_params(spec, 0))


def test_entry_points_refuse_the_cpu_without_asking(monkeypatch):
    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.model.model import model_compute

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, params = _tiny_spec_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SevenNetCalculator(spec, params)
    calc = SevenNetCalculator(spec, params, device="cpu")
    at = AtomsLite(positions=np.array([[0.0, 0, 0], [1.2, 0, 0]]), numbers=[8, 8])
    assert np.isfinite(calc.calculate(at)["energy"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_compute(spec, calc.params, calc.graph(at))
