"""Halo transport of distributed MD on ``torch.distributed``.

One process per domain (a brick of a 1-3 axis grid of ``dims``), each
holding only its own domain's state, as the reference's LAMMPS pair style
runs one MPI rank per domain (``pair_e3gnn_parallel.cpp:194-506``). The
JAX package runs one SPMD program over a device mesh instead
(``sevennet_tpu/parallel/md.py``); its ``ppermute`` pairs become the swaps
here and its ``psum`` the all-reduces.

- :meth:`Halo.swap` ships one tensor to the lower and one to the upper
  neighbour along a grid axis and receives theirs (``dist.batch_isend_irecv``);
  along an axis of extent 1 it swaps locally, with no communication.
- :class:`HaloExchange` is the differentiable exchange of one stage: the
  forward extends a per-atom array by the rows its neighbours send; the
  backward is the reference's ``reverse_comm``
  (``pair_e3gnn_parallel.cpp:404-441``), written by hand (the JAX package
  gets it from the transpose of ``ppermute``): the ghost rows' cotangents
  go back the way they came and are added into the rows that were sent.
  Chained stage by stage, autograd runs the backward stages in reverse
  order, the same order on every rank.
- The transport follows the group's backend, chosen once: ``nccl`` moves
  device tensors; ``gloo`` moves host tensors only, so with CUDA tensors
  every send buffer is staged to host memory and every received one back
  (which lets two ranks share one card: NCCL refuses two ranks on one
  device). The all-reduces of a few scalars a step are staged alike.
- Without an initialized process group, a grid of one domain runs with no
  communication at all.
"""

from __future__ import annotations

import logging
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["Halo", "HaloExchange", "grid_coords"]

_log = logging.getLogger(__name__)


def grid_coords(rank: int, dims: Sequence[int]) -> Tuple[int, ...]:
    """Grid coordinates of ``rank`` in C order over ``dims`` (the JAX
    engine's ``_linear_device``, inverted)."""
    out = []
    for d in reversed(dims):
        out.append(rank % d)
        rank //= d
    return tuple(reversed(out))


def _linear(coords: Sequence[int], dims: Sequence[int]) -> int:
    lin = 0
    for c, d in zip(coords, dims):
        lin = lin * d + c
    return lin


class Halo:
    """The grid, this rank's place in it, and its transport.

    ``dims``: 1-3 extents whose product is the group's size; ``group``: the
    caller's process group (default: the default group). The engine never
    starts a group itself."""

    def __init__(self, dims: Sequence[int], device: torch.device, group=None):
        import torch.distributed as dist

        self.dims = tuple(int(d) for d in dims)
        if not 1 <= len(self.dims) <= 3 or min(self.dims) < 1:
            raise ValueError(f"dims must be 1-3 positive extents, not {dims}")
        self.size = int(np.prod(self.dims))
        self.device = device
        self.active = dist.is_available() and dist.is_initialized()
        if not self.active:
            if self.size != 1:
                raise RuntimeError(
                    f"dims {self.dims} need {self.size} ranks: start torch.distributed "
                    "(init_process_group) in each rank's process first")
            self.group, self.rank, self.backend, self.stage_host = None, 0, None, False
        else:
            self.group = group
            world = dist.get_world_size(group)
            if world != self.size:
                raise ValueError(f"dims {self.dims} hold {self.size} domains, the group "
                                 f"{world} ranks")
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))
            # gloo's send/recv move host memory only
            self.stage_host = self.backend == "gloo" and device.type == "cuda"
            if self.rank == 0:
                _log.info("distributed MD: backend %s, %s", self.backend,
                          "halos staged through host memory" if self.stage_host
                          else "halos in place")
        self.coords = grid_coords(self.rank, self.dims)
        self.n_swaps = 0  # swaps with communication so far (counts on every rank)

    def _peer(self, axis: int, step: int) -> int:
        c = list(self.coords)
        c[axis] = (c[axis] + step) % self.dims[axis]
        lin = _linear(c, self.dims)
        if self.group is None:
            return lin
        import torch.distributed as dist

        return dist.get_global_rank(self.group, lin)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.stage_host else t

    def swap(self, axis: int, to_lo: torch.Tensor, to_hi: torch.Tensor):
        """Sends ``to_lo`` to the lower neighbour along ``axis`` and
        ``to_hi`` to the upper one; returns ``(from_lo, from_hi)``, what the
        lower neighbour sent up and the upper one sent down. Both tensors
        have the same shape and dtype on every rank."""
        if self.dims[axis] == 1:
            return to_hi, to_lo
        import torch.distributed as dist

        self.n_swaps += 1
        lo, hi = self._peer(axis, -1), self._peer(axis, 1)
        send_lo, send_hi = self._out(to_lo), self._out(to_hi)
        from_lo, from_hi = torch.empty_like(send_hi), torch.empty_like(send_lo)
        # tag 1 travels down, tag 0 up; the receives are posted in the order
        # of the sends, so an extent of 2 (lo == hi) matches them in order too
        ops = [dist.P2POp(dist.isend, send_lo, lo, self.group, 1),
               dist.P2POp(dist.isend, send_hi, hi, self.group, 0),
               dist.P2POp(dist.irecv, from_hi, hi, self.group, 1),
               dist.P2POp(dist.irecv, from_lo, lo, self.group, 0)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if self.stage_host:
            return from_lo.to(self.device), from_hi.to(self.device)
        return from_lo, from_hi

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="sum"``), maximum (``"max"``) or minimum (``"min"``)
        of ``t`` over the ranks, as a new tensor on ``t``'s device."""
        if not self.active:
            return t.clone()
        import torch.distributed as dist

        buf = t.detach().clone().contiguous()
        buf = buf.cpu() if self.stage_host else buf
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
        dist.all_reduce(buf, op=ops[op], group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor):
        """``t`` of every rank, in rank order (host tensors)."""
        if not self.active:
            return [t.detach().cpu()]
        import torch.distributed as dist

        buf = t.detach().contiguous()
        buf = buf.cpu() if self.stage_host else buf
        out = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(out, buf, group=self.group)
        return [o.cpu() for o in out]

    def extend(self, axis: int, arr: torch.Tensor, send_lo, mlo, send_hi, mhi):
        """``arr`` with the rows of one stage's exchange appended, not
        differentiated: ``[arr | from_lo | from_hi]``."""
        from_lo, from_hi = self.swap(axis, _rows(arr, send_lo, mlo), _rows(arr, send_hi, mhi))
        return torch.cat([arr, from_lo, from_hi], 0)


def _masked(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return rows * mask.reshape(mask.shape + (1,) * (rows.dim() - 1)).to(rows.dtype)


def _rows(arr: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` of ``arr``, zero where ``mask`` is off."""
    return _masked(arr[idx], mask)


class HaloExchange(torch.autograd.Function):
    """One differentiable stage: ``[x | from_lo | from_hi]`` where the
    neighbours send their masked rows ``x[send_lo]`` down and
    ``x[send_hi]`` up. The backward sends the ghost cotangents back and
    adds what comes back into the sent rows (``reverse_comm``)."""

    @staticmethod
    def forward(ctx, x, halo: Halo, axis: int, send_lo, mlo, send_hi, mhi):
        ctx.halo, ctx.axis = halo, axis
        ctx.save_for_backward(send_lo, mlo, send_hi, mhi)
        ctx.n = x.shape[0]
        return halo.extend(axis, x, send_lo, mlo, send_hi, mhi)

    @staticmethod
    def backward(ctx, g):
        send_lo, mlo, send_hi, mhi = ctx.saved_tensors
        n, s = ctx.n, send_lo.shape[0]
        g = g.contiguous()
        # the ghost rows' cotangents go back where they came from; what
        # returns is the cotangent of the rows this rank sent each way
        back_lo, back_hi = ctx.halo.swap(ctx.axis, g[n:n + s], g[n + s:])
        gx = g[:n].clone()
        gx.index_add_(0, send_lo, _masked(back_lo, mlo))
        gx.index_add_(0, send_hi, _masked(back_hi, mhi))
        return gx, None, None, None, None, None, None
