"""The port's checkpoint format: numpy arrays plus JSON meta in one directory
(the counterpart of ``sevennet_tpu/io/native_checkpoint.py``, which writes
msgpack through flax).

A checkpoint directory holds

- ``config.json``: format tag, uuid, epoch, the full model config (so the
  model rebuilds exactly) and any extra trainer state;
- ``params.npz``: every parameter leaf, keyed by its path in the tree
  (``"0_convolution/weight_nn/w/2"``);
- ``opt_state.npz`` and ``opt_state.json``: the optimizer state
  (:meth:`sevennet_tpu_torch.train.Trainer.opt_state`), when saved.

:func:`load_native_checkpoint` also reads the JAX package's checkpoint
directories (format ``sevennet_tpu.v1``: ``config.json``,
``params.msgpack`` and ``opt_state.msgpack`` from
``flax.serialization.to_bytes``) through the port's own msgpack decoder
(:mod:`.msgpack`), so a model the JAX package trained serves here. Stock
SevenNet ``.pth`` files are read by
:mod:`sevennet_tpu_torch.io.torch_checkpoint` (and through
:func:`load_checkpoint`).
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["FORMAT", "JAX_FORMAT", "save_checkpoint", "load_native_checkpoint",
           "load_checkpoint"]

FORMAT = "sevennet_tpu_torch.v1"
JAX_FORMAT = "sevennet_tpu.v1"  # the JAX package's (sevennet_tpu/io/native_checkpoint.py)


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(
            tree.detach().cpu().numpy() if hasattr(tree, "detach") else tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        node = root
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def save_checkpoint(
    path: str,
    model_config: Dict[str, Any],
    params,
    opt_state: Optional[Dict[str, Any]] = None,
    epoch: int = 0,
    extra: Optional[Dict[str, Any]] = None,
):
    """Writes the checkpoint directory ``path``; ``params`` is the port's
    tree of tensors (or numpy arrays)."""
    os.makedirs(path, exist_ok=True)
    meta = {
        "format": FORMAT,
        "uuid": str(uuid.uuid4()),
        "epoch": int(epoch),
        "model_config": _jsonable(model_config),
    }
    if extra:
        meta["extra"] = _jsonable(extra)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params, "", {}))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_state.npz"), **opt_state["arrays"])
        with open(os.path.join(path, "opt_state.json"), "w") as f:
            json.dump(_jsonable(opt_state["meta"]), f)


def _rebuild_params_lists(params):
    """A msgpack state dict keeps lists as dicts of ``"0"``, ``"1"``, ...
    keys; turn them back into lists ordered by index."""
    if isinstance(params, dict):
        if params and all(isinstance(k, str) and k.isdigit() for k in params):
            return [_rebuild_params_lists(params[str(i)]) for i in range(len(params))]
        return {k: _rebuild_params_lists(v) for k, v in params.items()}
    return params


def _load_jax_checkpoint(path: str, meta: Dict[str, Any]):
    from .msgpack import msgpack_restore

    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        params = _rebuild_params_lists(msgpack_restore(f.read()))
    opt_state = None
    op = os.path.join(path, "opt_state.msgpack")
    if os.path.exists(op):
        with open(op, "rb") as f:
            opt_state = msgpack_restore(f.read())
    return meta["model_config"], params, opt_state, meta


def load_native_checkpoint(path: str) -> Tuple[Dict[str, Any], Any, Any, Dict[str, Any]]:
    """Returns ``(model_config, params as a numpy tree, opt_state or None,
    meta)``. ``path`` is a checkpoint directory of the port's format or of
    the JAX package's (``meta["format"]`` says which); the JAX one's
    ``opt_state`` is its optax state dict as it was saved."""
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    if meta.get("format") == JAX_FORMAT:
        return _load_jax_checkpoint(path, meta)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} or {JAX_FORMAT} checkpoint (format "
                         f"{meta.get('format')!r})")
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten({k: z[k] for k in z.files})
    opt_state = None
    if os.path.exists(os.path.join(path, "opt_state.npz")):
        with np.load(os.path.join(path, "opt_state.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(path, "opt_state.json")) as f:
            opt_state = {"arrays": arrays, "meta": json.load(f)}
    return meta["model_config"], params, opt_state, meta


def load_checkpoint(path: str):
    """A checkpoint directory (the port's format or the JAX package's), or a
    stock SevenNet ``.pth`` file -> ``(spec, params, meta)``, the parameters
    as the port's tensor tree (checked against the spec)."""
    from ..model.build import build_model_spec
    from .convert import params_from_numpy

    if not os.path.isdir(path):
        from .torch_checkpoint import load_sevennet_checkpoint

        spec, params = load_sevennet_checkpoint(path)
        return spec, params, {"format": "sevenn_torch"}
    cfg, params, _, meta = load_native_checkpoint(path)
    spec = build_model_spec(cfg)
    return spec, params_from_numpy(spec, params), meta
