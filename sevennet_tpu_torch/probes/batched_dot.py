"""Batched small products probe (``csrc/probe_batched_dot.cu``), the
counterpart of ``scripts_dev/r4_batched_dot_probe.py:make_pallas``
(pallas_call at ``:95``): per atom i and path group g, ``Y_g[i] = S_g[i]
(d3, K d1) @ XW_g[i] (K d1, mul)``, float32 at fp32 accuracy, the MXU form
of SevenNet-0's forward uvu product at K 72 (:data:`GROUPS`, N = 10,016
atoms).

:func:`batched_dot` launches the kernel on CUDA tensors and raises on CPU
tensors unless ``plain=True`` (:func:`batched_dot_plain`, ``torch.bmm`` per
group, on any device); ``rep > 1`` repeats the product on each staged
chunk, which times the product apart from the stream (the output does not
change). The kernel streams each item in chunks of contraction rows by TMA
through a ring of shared-memory stages, four warpgroups each with its own
items and stages, and multiplies on 3xTF32 ``wgmma``; :func:`bd_plan` is
the host's plan of chunks and ring. It takes d3 up to 24 and mul up to 128
(the script's groups: 22 and 128). :func:`batched_dot_time` times a call the
TPU script's way (``r4_batched_dot_probe.py:timed``): best of 3 runs of 10
back-to-back calls, per call, each run captured in a CUDA graph whose
replay CUDA events time (the device alone)."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..ops.kernels import call
from ._lib import check_device, graph_ms, stream

__all__ = ["GROUPS", "N_ATOMS", "batched_dot_plain", "batched_dot", "batched_dot_time",
           "batched_dot_work", "BdPlan", "bd_plan", "SMEM_LIMIT"]

GROUPS = ((9, 72, 128), (20, 216, 64), (22, 360, 32))  # (d3, K d1, mul)
N_ATOMS = 10016
# the kernel's layout (csrc/probe_batched_dot.cu; batched_dot_layout returns
# the same): consumer warpgroups, stages at most, n8 tiles of d3 and m64
# tiles of mul at most, k8 steps a chunk, XW columns a TMA box (the 128-byte
# swizzle's span), a stage's alignment in bytes (the swizzle's atom)
BD_CWG, BD_NSMAX, BD_NT8, BD_MT, BD_KS, BD_CB, BD_ALIGN = 4, 8, 3, 2, 5, 32, 1024
BD_CH = 8 * BD_KS  # contraction rows a chunk
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may have on sm_90


@dataclass(frozen=True)
class BdPlan:
    """How the kernel stages the three groups (``csrc/probe_batched_dot.cu``):
    chunks of ``ch`` contraction rows (the last of an item shorter), a ring
    of ``ns`` stages, an equal share for each warpgroup, of ``stage`` floats (a chunk
    of XW as TMA boxes of
    :data:`BD_CB` columns x ch rows, then the chunk of S, d3 rows of ch
    floats; whole swizzle atoms of :data:`BD_ALIGN` bytes), ``bbuf`` floats
    for each warpgroup's split B tiles, ``smem`` bytes in all (an mbarrier a
    stage and the alignment's slack included)."""

    ch: int
    ns: int
    stage: int
    bbuf: int
    smem: int


def bd_plan(groups: Sequence[Tuple[int, int, int]]) -> BdPlan:
    """The kernel's plan for ``groups`` ((d3, K d1, mul) each): chunks of
    :data:`BD_CH` rows, the deepest ring of their stages, up to
    :data:`BD_NSMAX` and a multiple of :data:`BD_CWG` (an equal share for
    each warpgroup), that fits :data:`SMEM_LIMIT` beside the B tiles (at d3
    24 and mul 128, the widest the kernel takes, 8 stages; fewer than 2 a
    warpgroup: the kernel refuses)."""
    stage = max(BD_CH * (-(-mul // BD_CB) * BD_CB + d3) for d3, _, mul in groups)
    stage += (-stage) % (BD_ALIGN // 4)
    bbuf = BD_KS * 128 * max(-(-d3 // 8) for d3, _, _ in groups)
    fixed = 4 * BD_CWG * bbuf + BD_ALIGN
    ns = min(BD_NSMAX, (SMEM_LIMIT - fixed) // (4 * stage + 8))
    ns = max(0, ns - ns % BD_CWG)
    return BdPlan(BD_CH, ns, stage, bbuf, fixed + (4 * stage + 8) * ns)


class _BdGroup(ctypes.Structure):
    _fields_ = [("S", ctypes.c_void_p), ("XW", ctypes.c_void_p), ("Y", ctypes.c_void_p),
                ("d3", ctypes.c_int), ("kk", ctypes.c_int), ("mul", ctypes.c_int)]


class _BdArgs(ctypes.Structure):
    """ctypes mirror of ``struct BdArgs`` (csrc/probe_batched_dot.cu)."""

    _fields_ = [("g", _BdGroup * 3)] + [(f, ctypes.c_int) for f in ("N", "rep", "ch", "ns",
                                                                      "stage", "bbuf")]


def batched_dot_plain(Ss, XWs):
    """``[S @ XW]`` per group, ``torch.bmm`` (float32; on the card with TF32
    off it is the fp32 product)."""
    return [torch.bmm(S, XW) for S, XW in zip(Ss, XWs)]


def _check(Ss, XWs):
    if len(Ss) != 3 or len(XWs) != 3:
        raise ValueError("three path groups: S and XW for each")
    N = Ss[0].shape[0]
    for S, XW in zip(Ss, XWs):
        ok = (S.dim() == 3 and XW.dim() == 3 and S.shape[0] == XW.shape[0] == N
              and S.shape[2] == XW.shape[1] and S.shape[2] % 8 == 0 and XW.shape[2] % 8 == 0)
        if not ok:
            raise ValueError(f"S (N, d3, K d1) and XW (N, K d1, mul), K d1 and mul multiples of 8; "
                             f"got {tuple(S.shape)} and {tuple(XW.shape)}")
        for t in (S, XW):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"contiguous float32 inputs, got {t.dtype}")


def _check_kernel(groups, rep, tensors) -> BdPlan:
    if rep < 1:
        raise ValueError(f"rep: at least one product a staged chunk, got {rep}")
    for d3, _, mul in groups:
        if d3 > 8 * BD_NT8 or mul > 64 * BD_MT:
            raise ValueError(f"the batched-dot kernel takes d3 up to {8 * BD_NT8} and mul up to "
                             f"{64 * BD_MT}, got d3 {d3}, mul {mul}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the batched-dot kernel takes S, XW and Y 16-byte aligned")
    plan = bd_plan(groups)
    if plan.ns < 2 * BD_CWG:
        raise ValueError(f"the batched-dot kernel's {2 * BD_CWG} stages of groups {groups} need "
                         f"more than {SMEM_LIMIT} bytes of shared memory")
    return plan


def _check_layout(lib):
    want = (BD_CWG, BD_NSMAX, BD_NT8, BD_MT, BD_KS, BD_CB, BD_ALIGN)
    got = (ctypes.c_int * len(want))()
    lib.batched_dot_layout(got)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/probe_batched_dot.cu's layout {tuple(got)} is not "
                           f"probes/batched_dot.py's {want}")


def batched_dot(Ss, XWs, rep: int = 1, plain: bool = False):
    """The three groups' ``Y (N, d3, mul)``. CUDA tensors: the
    ``batched_dot`` kernel (``rep`` products per staged chunk); ``plain=True``:
    :func:`batched_dot_plain`."""
    _check(Ss, XWs)
    if check_device(plain, *Ss, *XWs):
        return batched_dot_plain(Ss, XWs)
    N = Ss[0].shape[0]
    Ys = [torch.empty((N, S.shape[1], XW.shape[2]), dtype=torch.float32, device=S.device)
          for S, XW in zip(Ss, XWs)]
    shapes = tuple((S.shape[1], S.shape[2], XW.shape[2]) for S, XW in zip(Ss, XWs))
    plan = _check_kernel(shapes, rep, (*Ss, *XWs, *Ys))
    groups = (_BdGroup * 3)(*[
        _BdGroup(S.data_ptr(), XW.data_ptr(), Y.data_ptr(), d3, kk, mul)
        for S, XW, Y, (d3, kk, mul) in zip(Ss, XWs, Ys, shapes)])
    call("probe_batched_dot", "batched_dot_launch",
         _BdArgs(groups, N, rep, plan.ch, plan.ns, plan.stage, plan.bbuf),
         stream(Ss[0].device),
         on_load=_check_layout)
    batched_dot.launches += 1
    return Ys


batched_dot.launches = 0


def batched_dot_work(Ss, XWs):
    """(operations, bytes) of the function: ``2 d3 K d1 mul`` per atom and
    group; each input read once, each output written once."""
    flops = sum(2 * S.shape[0] * S.shape[1] * S.shape[2] * XW.shape[2] for S, XW in zip(Ss, XWs))
    nbytes = sum(4 * (S.numel() + XW.numel() + S.shape[0] * S.shape[1] * XW.shape[2])
                 for S, XW in zip(Ss, XWs))
    return flops, nbytes


def batched_dot_time(fn, reps: int = 10, tries: int = 3) -> float:
    """Device ms per call of ``fn``: best of ``tries`` runs of ``reps``
    back-to-back calls, after one call as warm-up; each run is one CUDA
    graph (``_lib.graph_ms``)."""
    fn()
    torch.cuda.synchronize()
    return min(graph_ms(fn, reps) / reps for _ in range(tries))
