"""Fused radial MLP + uvu tensor product + neighbour sum on the dense
``(N, K)`` layout, forward only (the counterpart of
``sevennet_tpu/ops/pallas_conv.py``, kept under its name so the two are
found side by side).

The JAX module's Pallas kernel (``make_dense_conv_kernel``, B6) computes
the emb/sh-mode forward conv on the un-permuted layout, with the gather
``x[src]`` left to XLA. Here the same function runs on the emb/sh forward
kernel of :mod:`.fused_conv` (B4, ``csrc/fused_conv_fwd.cu``), which
gathers ``x[src]`` itself; the TPU-only arguments (``a_block``,
``interpret``) have no counterpart.
"""

from __future__ import annotations

import torch

from .fused_conv import check_conv_inputs, conv_op, fused_conv_fwd_embsh_plain, launch_fused_conv_fwd

__all__ = ["dense_conv_pallas"]


def dense_conv_pallas(conv_spec, mlp_spec, x, emb, sh, src, mlp_ws) -> torch.Tensor:
    """``x (N, dim_x)``, ``emb (N, K, n_basis)``, ``sh (N, K, dim_f)``,
    ``src (N, K)``, the radial MLP's weights -> ``(N, dim_mid)`` in the
    grouped mid layout. CPU tensors: the plain version. CUDA tensors: the
    emb/sh forward kernel, counted in ``dense_conv_pallas.launches``."""
    op = conv_op(conv_spec, mlp_spec, None)
    N, K = src.shape
    src = src.to(torch.int32).contiguous()
    emb = emb.reshape(N * K, -1).contiguous()
    sh = sh.reshape(N * K, -1).contiguous()
    ws = [w.contiguous() for w in mlp_ws]
    check_conv_inputs(op, True, x, src, emb, sh, ws)
    if x.device.type == "cpu":
        return fused_conv_fwd_embsh_plain(op, x, src, emb, sh, ws)
    out = launch_fused_conv_fwd(op, x, src, emb, sh, ws)
    dense_conv_pallas.launches += 1
    return out


dense_conv_pallas.launches = 0
