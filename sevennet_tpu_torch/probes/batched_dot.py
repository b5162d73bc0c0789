"""Batched small products probe (``csrc/probe_batched_dot.cu``), the
counterpart of ``scripts_dev/r4_batched_dot_probe.py:make_pallas``
(pallas_call at ``:95``): per atom i and path group g, ``Y_g[i] = S_g[i]
(d3, K d1) @ XW_g[i] (K d1, mul)``, float32 at fp32 accuracy, the MXU form
of SevenNet-0's forward uvu product at K 72 (:data:`GROUPS`, N = 10,016
atoms).

:func:`batched_dot` launches the kernel on CUDA tensors and raises on CPU
tensors unless ``plain=True`` (:func:`batched_dot_plain`, ``torch.bmm`` per
group, on any device); ``rep > 1`` repeats the product on each staged item,
which times the tensor-core step apart from the stream (the output does not
change). :func:`batched_dot_time` times a call the TPU script's way
(``r4_batched_dot_probe.py:timed``): best of 3 runs of 10 back-to-back
calls, per call, each run captured in a CUDA graph whose replay CUDA events
time (the device alone)."""

from __future__ import annotations

import ctypes

import torch

from ..ops.kernels import call
from ._lib import check_device, graph_ms, stream

__all__ = ["GROUPS", "N_ATOMS", "batched_dot_plain", "batched_dot", "batched_dot_time",
           "batched_dot_work"]

GROUPS = ((9, 72, 128), (20, 216, 64), (22, 360, 32))  # (d3, K d1, mul)
N_ATOMS = 10016


class _BdGroup(ctypes.Structure):
    _fields_ = [("S", ctypes.c_void_p), ("XW", ctypes.c_void_p), ("Y", ctypes.c_void_p),
                ("d3", ctypes.c_int), ("kk", ctypes.c_int), ("mul", ctypes.c_int)]


class _BdArgs(ctypes.Structure):
    """ctypes mirror of ``struct BdArgs`` (csrc/probe_batched_dot.cu)."""

    _fields_ = [("g", _BdGroup * 3), ("N", ctypes.c_int), ("rep", ctypes.c_int)]


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


def batched_dot(Ss, XWs, rep: int = 1, plain: bool = False):
    """The three groups' ``Y (N, d3, mul)``. CUDA tensors: the
    ``batched_dot`` kernel (``rep`` products per staged item); ``plain=True``:
    :func:`batched_dot_plain`."""
    _check(Ss, XWs)
    if check_device(plain, *Ss, *XWs):
        return batched_dot_plain(Ss, XWs)
    N = Ss[0].shape[0]
    Ys = [torch.empty((N, S.shape[1], XW.shape[2]), dtype=torch.float32, device=S.device)
          for S, XW in zip(Ss, XWs)]
    groups = (_BdGroup * 3)(*[
        _BdGroup(S.data_ptr(), XW.data_ptr(), Y.data_ptr(), S.shape[1], S.shape[2], XW.shape[2])
        for S, XW, Y in zip(Ss, XWs, Ys)])
    call("probe_batched_dot", "batched_dot_launch", _BdArgs(groups, N, rep), stream(Ss[0].device))
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
