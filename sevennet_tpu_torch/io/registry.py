"""Pretrained checkpoint names -> local paths, the release download, and a
universal loader (the port's copy of ``sevennet_tpu/io/registry.py``;
reference ``sevenn/util.py:224-359``, ``sevenn/_const.py:50-68``).

A pretrained name ("7net-0", "SevenNet-MF-ompa", ...) resolves through a
search path of local directories: ``$SEVENN_TPU_CHECKPOINT_DIR``, then
``~/.cache/sevennet_tpu`` and ``~/.cache/sevennet``, each flat and one
subdirectory deep (the reference's layout). A name's file is its stock
``.pth``, or a checkpoint directory (the port's or the JAX package's) under
the same base name, with or without the ``.pth`` suffix. When nothing local
matches and the name has a release URL, the asset is downloaded into the
first search directory (:func:`download_checkpoint`: through a ``.partial``
file, removed on any failure; the length and a pinned sha256 checked). The
digests are looked up in ``$SEVENN_TPU_CHECKSUMS``, then each search
directory's ``checksums.json``, then the one beside this module; a download
with no pin records its digest in its directory's ``checksums.json``
(trust on first use). A name not found and not downloaded raises
``FileNotFoundError`` naming the paths searched and the URL with the
failure.
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = [
    "resolve_checkpoint",
    "download_checkpoint",
    "get_available_pretrained_models",
    "load_model",
]

_GIT = "https://github.com/MDIL-SNU/SevenNet/releases/download"


class _Entry(NamedTuple):
    basename: str
    url: Optional[str] = None  # the official release asset, where one exists
    sha256: Optional[str] = None  # checked after a download, where known


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


def download_checkpoint(path: str, url: str, sha256: Optional[str] = None,
                        timeout: float = 30.0) -> str:
    """Download ``url`` to ``path`` through ``path + '.partial'`` (removed on
    any failure), check the ``Content-Length`` and, when given, the sha256;
    with no digest given, record the file's in ``checksums.json`` beside it.
    Returns ``path`` (reference ``sevenn/util.py:224-261``)."""
    import urllib.request

    tmp = path + ".partial"
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    try:
        req = urllib.request.Request(url, headers={"User-Agent": "sevennet-tpu"})
        with urllib.request.urlopen(req, timeout=timeout) as resp, open(tmp, "wb") as out:
            total = int(resp.headers.get("Content-Length") or 0)
            got = 0
            while True:
                block = resp.read(1 << 20)
                if not block:
                    break
                out.write(block)
                got += len(block)
            if total and got != total:
                raise IOError(f"truncated download: {got} of {total} bytes")
        digest = _file_sha256(tmp)
        if sha256 is not None and digest != sha256:
            raise IOError(f"sha256 mismatch for {url}: got {digest}, expected {sha256}")
        os.replace(tmp, path)
        if sha256 is None:
            _record_sha256(osp.dirname(path) or ".", osp.basename(path), digest)
        return path
    except Exception:
        if osp.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise


def _checksum_files() -> List[str]:
    """The tables of pinned digests, first match wins: ``$SEVENN_TPU_CHECKSUMS``,
    each search directory's ``checksums.json`` (trust-on-first-use records),
    then the table beside this module."""
    files = []
    env = os.environ.get("SEVENN_TPU_CHECKSUMS")
    if env:
        files.append(env)
    for d in _search_dirs():
        files.append(osp.join(d, "checksums.json"))
    files.append(osp.join(osp.dirname(__file__), "checksums.json"))
    return files


def _pinned_sha256(basename: str) -> Optional[str]:
    for f in _checksum_files():
        if not osp.exists(f):
            continue
        try:
            with open(f) as fh:
                table = json.load(fh)
        except (OSError, ValueError):
            continue
        if basename in table:
            return str(table[basename])
    return None


def _record_sha256(cache_dir: str, basename: str, digest: str) -> None:
    """Trust on first use: keep the digest of a download that had no pin in
    ``<cache_dir>/checksums.json``, so that a later download of the same
    asset must match it. The true digests of the release assets are not
    vendored (``checksums.json`` beside this module holds none); a site
    pins them there or in ``$SEVENN_TPU_CHECKSUMS``."""
    f = osp.join(cache_dir, "checksums.json")
    table = {}
    if osp.exists(f):
        try:
            with open(f) as fh:
                table = json.load(fh)
        except (OSError, ValueError):
            table = {}
    table[basename] = digest
    tmp = f + ".tmp"
    os.makedirs(cache_dir, exist_ok=True)
    with open(tmp, "w") as fh:
        json.dump(table, fh, indent=1, sort_keys=True)
    os.replace(tmp, f)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


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
    subdirectory), else to its release asset downloaded into the first
    search directory. Raises ``FileNotFoundError`` otherwise."""
    if osp.exists(name_or_path):
        return name_or_path
    key = _normalize(name_or_path)
    if key is None:
        raise FileNotFoundError(
            f"'{name_or_path}' is neither an existing path nor a known pretrained name; "
            f"known: {', '.join(get_available_pretrained_models())}")
    base, url, sha = _REGISTRY[key]
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
    if url is not None:
        dest = osp.join(_search_dirs()[0], base)
        try:
            return download_checkpoint(dest, url, sha256=sha if sha is not None
                                       else _pinned_sha256(base))
        except Exception as e:  # no network, a bad link or a wrong digest
            why = f"download from {url} failed: {e}"
    else:
        why = "no release URL exists for this name; it ships inside the reference's pip package"
    raise FileNotFoundError(
        f"pretrained checkpoint '{key}' not found locally ({why}); searched "
        f"{', '.join(tried)} and their subdirectories: place the file or checkpoint directory "
        "in $SEVENN_TPU_CHECKPOINT_DIR or ~/.cache/sevennet_tpu")


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
