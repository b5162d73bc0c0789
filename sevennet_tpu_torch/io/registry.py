"""Pretrained checkpoint names -> local paths, and a universal loader (the
port's copy of ``sevennet_tpu/io/registry.py``; reference
``sevenn/util.py:264-359``, ``sevenn/_const.py:50-68``).

A pretrained name ("7net-0", "SevenNet-MF-ompa", ...) resolves through a
search path of local directories: ``$SEVENN_TPU_CHECKPOINT_DIR``, then
``~/.cache/sevennet_tpu`` and ``~/.cache/sevennet``, each flat and one
subdirectory deep (the reference's layout). A name's file is its stock
``.pth``, or a checkpoint directory (the port's or the JAX package's) under
the same base name, with or without the ``.pth`` suffix. The port never
downloads: a name not found raises ``FileNotFoundError`` listing the paths
it searched (and the release URL where one exists).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["resolve_checkpoint", "get_available_pretrained_models", "load_model"]

_GIT = "https://github.com/MDIL-SNU/SevenNet/releases/download"


class _Entry(NamedTuple):
    basename: str
    url: Optional[str] = None  # the official release asset, where one exists


# canonical name -> entry; names and files of the reference's table
# (``_const.py:50-68``). 7net-0, l3i5 and mf-0 ship inside the reference's
# pip sdist, not as release assets.
_REGISTRY: Dict[str, _Entry] = {
    "sevennet-0": _Entry("checkpoint_sevennet_0.pth"),
    "sevennet-0_11jul2024": _Entry("checkpoint_sevennet_0.pth"),
    "sevennet-0_22may2024": _Entry("checkpoint_sevennet_0_22May2024.pth"),
    "sevennet-l3i5": _Entry("checkpoint_l3i5.pth"),
    "sevennet-mf-0": _Entry("checkpoint_sevennet_mf_0.pth"),
    "sevennet-mf-ompa": _Entry("checkpoint_sevennet_mf_ompa.pth",
                               f"{_GIT}/v0.11.0.cp/checkpoint_sevennet_mf_ompa.pth"),
    "sevennet-omat": _Entry("checkpoint_sevennet_omat.pth",
                            f"{_GIT}/v0.11.0.cp/checkpoint_sevennet_omat.pth"),
    "sevennet-omni": _Entry("checkpoint_sevennet_omni.pth",
                            f"{_GIT}/v0.12.0.cp/checkpoint_sevennet_omni.pth"),
    "sevennet-omni-i8": _Entry("checkpoint_sevennet_omni_i8.pth",
                               f"{_GIT}/v0.12.1.cp/checkpoint_sevennet_omni_i8.pth"),
    "sevennet-omni-i12": _Entry("checkpoint_sevennet_omni_i12.pth",
                                f"{_GIT}/v0.12.1.cp/checkpoint_sevennet_omni_i12.pth"),
}


def _normalize(name: str) -> Optional[str]:
    n = name.lower().replace("7net", "sevennet")
    return n if n in _REGISTRY else None


def _search_dirs() -> List[str]:
    dirs = []
    env = os.environ.get("SEVENN_TPU_CHECKPOINT_DIR")
    if env:
        dirs.append(env)
    dirs.append(osp.expanduser("~/.cache/sevennet_tpu"))
    dirs.append(osp.expanduser("~/.cache/sevennet"))
    return dirs


def get_available_pretrained_models() -> List[str]:
    return sorted(_REGISTRY)


def resolve_checkpoint(name_or_path: str) -> str:
    """An existing path as it is; a pretrained name to the first match of
    its file in the search directories (flat, ``<dir>/<name>/``, then any
    subdirectory). Raises ``FileNotFoundError`` otherwise."""
    if osp.exists(name_or_path):
        return name_or_path
    key = _normalize(name_or_path)
    if key is None:
        raise FileNotFoundError(
            f"'{name_or_path}' is neither an existing path nor a known pretrained name; "
            f"known: {', '.join(get_available_pretrained_models())}")
    base, url = _REGISTRY[key]
    names = (base, base[: -len(".pth")]) if base.endswith(".pth") else (base,)
    tried = []
    for d in _search_dirs():
        subdirs = sorted(os.listdir(d)) if osp.isdir(d) else []
        for sub in ("", key, *subdirs):
            for name in names:
                cand = osp.join(d, sub, name)
                if sub in ("", key):
                    tried.append(cand)
                if osp.exists(cand):
                    return cand
    where = (f"; a release exists at {url}" if url else
             "; it ships inside the reference's pip package")
    raise FileNotFoundError(
        f"pretrained checkpoint '{key}' not found locally (the port does not download{where}); "
        f"searched {', '.join(tried)} and their subdirectories: place the file or checkpoint "
        "directory in $SEVENN_TPU_CHECKPOINT_DIR or ~/.cache/sevennet_tpu")


def load_model(name_or_path) -> Tuple[Any, Dict[str, Any]]:
    """A pretrained name, a stock SevenNet ``.pth``, a checkpoint directory
    (the port's or the JAX package's) or its ``params.msgpack`` ->
    ``(spec, params)``, the parameters as the port's CPU tensor tree
    (reference ``util.model_from_checkpoint``, ``util.py:119-131``)."""
    path = resolve_checkpoint(str(name_or_path))
    if osp.isfile(path) and path.endswith(".msgpack"):
        path = osp.dirname(path) or "."
    if osp.isdir(path):
        from .native_checkpoint import load_checkpoint

        spec, params, _ = load_checkpoint(path)
        return spec, params
    from .torch_checkpoint import load_sevennet_checkpoint

    return load_sevennet_checkpoint(path)
