"""Knock-out probe of the emb/sh fused conv forward (``csrc/probe_knockout.cu``;
the kernel template in ``csrc/probe_breakdown.cuh``), the counterpart of the
TPU probe ``scripts_dev/r3_fwd_knockout.py:make`` (pallas_call at ``:128``,
kernel ``:50-116``).

Each variant (:data:`VARIANTS`) takes one phase out of B4 fwd's function
(the script's results are then wrong on purpose; only the time tells):
``full`` (the conv; the script sums K by its roll halving chain, ``:55-68``);
``nomlp`` (no radial MLP: ``w[e, c] = 0.1 emb[e, 0]`` in every column,
``:85``); ``notp`` (no uvu product: every output column ``w[0, 0] + tmp[0,
0]``, ``:87-90``); ``nofold`` (the messages with no K sum: slot 0's,
``:111``); ``nothing`` (``nomlp`` and ``notp``). The script's dots run at
``Precision.HIGHEST`` (``_DOT``): fp32 accuracy, 3xTF32 here.

As :mod:`.breakdown`: the TPU kernel's function at A = 1 receiver per grid
step on receiver-major rows (``xg (N K, dim_x)``, ``emb (N K, n_basis)``,
``sh (N K, dim_f)``; out ``(N, dim_mid)``); the wrapper launches the
variant's instantiation of B4 fwd's kernel on CUDA tensors (``x = xg``, the
identity gather, so ``full`` is B4 fwd itself) and raises on CPU tensors
unless ``plain=True`` (the script's operations in torch, its order); it
counts ``.launches`` and ``.by_variant``. Kernel against plain: :data:`TOL`
of max |plain|. Timing: ``diff_ms(fn, *KNOCK_TIME)``, the script's
differential of 9 and 3 calls, best of 3 (``:142-162``)."""

from __future__ import annotations

import torch

from ..ops import fused_conv as fc
from ._lib import check_device
from .breakdown import (KNOCK_TIME, TOL, check_inputs, conv_work, ksum_plain, launch, mlp_plain,
                        phase_work, terms_plain)

__all__ = ["VARIANTS", "N", "K", "TOL", "KNOCK_TIME", "EDGE_VW", "knockout_plain", "knockout",
           "knockout_work"]

VARIANTS = ("full", "nomlp", "notp", "nofold", "nothing")
N, K = 10016, 72   # r3_fwd_knockout.py:24 (A 32 there: the TPU's block)
_CODE = {v: 16 + i for i, v in enumerate(VARIANTS)}  # csrc/probe_breakdown.cuh PB_KO_*
# nofold's per-edge product: channels a lane (breakdown.EDGE_VW; one
# measured 1.5 % faster than 4 on an H100, PERF.md)
EDGE_VW = {"nofold": 1}


def knockout_plain(op, xg, emb, sh, ws, k: int, variant: str):
    """The variant's function (``:78-116`` in torch, its order),
    receiver-major, ``(N, dim_mid)``."""
    instr, w3j_pack, dim_mid, numel = fc._instr_tables(op.conv)
    n = xg.shape[0] // k
    if variant in ("nomlp", "nothing"):
        h = (emb[:, :1] * 0.1).expand(-1, numel)
    else:
        h = mlp_plain(emb, ws)
    tmp = sh @ torch.as_tensor(w3j_pack, device=xg.device).t()
    if variant in ("notp", "nothing"):
        v = h.view(n, k, -1)[:, 0, :1] + tmp.view(n, k, -1)[:, 0, :1]
        return v.expand(-1, dim_mid).contiguous()
    out = torch.zeros(n, dim_mid, dtype=torch.float32, device=xg.device)
    for ins in instr:
        for p, acc in terms_plain(ins, xg, h, tmp).items():
            start = ins["g_start"] + p * ins["u_tot"] + ins["u_off"]
            red = acc.view(n, k, -1)[:, 0] if variant == "nofold" else ksum_plain(acc, k, "kred")
            out[:, start:start + ins["mul"]] = red
    return out


def knockout(op, xg, emb, sh, ws, k: int = K, variant: str = "full", plain: bool = False):
    """``r3_fwd_knockout.py:make(variant)``'s function, receiver-major,
    ``(N, dim_mid)``. CUDA tensors: its instantiation of B4 fwd's kernel;
    ``plain=True``: :func:`knockout_plain`."""
    ws = list(ws)
    check_inputs(op, xg, emb, sh, ws, k, variant, VARIANTS)
    if check_device(plain, xg, emb, sh, *ws):
        return knockout_plain(op, xg, emb, sh, ws, k, variant)
    out = launch(op, xg, emb, sh, ws, k, "probe_knockout", _CODE[variant],
                 vw=EDGE_VW.get(variant))
    knockout.launches += 1
    knockout.by_variant[variant] += 1
    return out


knockout.launches = 0
knockout.by_variant = dict.fromkeys(VARIANTS, 0)


def knockout_work(op, variant: str, n: int, k: int):
    """(flops, bytes, one-pass flops) of the variant's call: its phases'
    own work (:func:`.breakdown.phase_work`); ``full`` that of B4 fwd's
    function."""
    if variant == "full":
        return conv_work(op, n, k)
    mlp = "knock" if variant in ("nomlp", "nothing") else "full"
    if variant in ("notp", "nothing"):
        return phase_work(op, n, k, mlp=mlp, tmp=True, msg=False, ksum=False, lanes="",
                          reads_x=False, one_pass=False)
    return phase_work(op, n, k, mlp=mlp, tmp=True, msg=True, ksum=variant == "nomlp", lanes="",
                      reads_x=True, one_pass=False)
