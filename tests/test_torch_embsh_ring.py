"""The port's emb/sh large-system conv and the ext conv against the JAX
package's: the emb/sh ring backward (``sevennet_tpu/ops/fused_conv.py:
_fused_conv_ring``) and chunked scatter backward (``_fused_conv_chunked``),
their kernels in interpret mode on the CPU; the plain twin of B4 bwd's slot
entry; ``fused_conv_apply_ext`` and ``fused_conv_apply_ext_vec`` with ghost
rows in ``x_ext``.

On the CPU the port's wrappers run the kernels' plain versions; the slot
entry itself is held against its twin on the card
(tests/test_torch_kernels.py, chip_smoke.py).

Shapes: ``8x0e+8x1e+8x2e``, MLP (8, 16, 16, numel), a circular helix chain
(K 8, four neighbours per atom, every mirror within two rows; emb and sh of
a model with unnormalized spherical harmonics: zero emb on padded slots,
large sh on the sentinel), made with numpy from a seed. Tolerances: atol
2e-5 and rtol 1e-4 for the gradients (tests/test_torch_ring.py's), 1e-5 for
outputs: fp32 on both sides, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_tpu.irreps import Irreps as JIrreps
from sevennet_tpu.irreps import infer_irreps_out as j_infer
from sevennet_tpu.ops import fused_conv as jfc
from sevennet_tpu.ops.mlp import ScalarMLPSpec as JMLPSpec
from sevennet_tpu.ops.tensor_product import ConvTPSpec as JConvTPSpec
from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.radial import bessel_basis, xplor_cutoff
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec
from sevennet_tpu_torch.so3.spherical import spherical_harmonics

torch.set_num_threads(1)
X_IR, F_IR, K, CUT = "8x0e+8x1e+8x2e", "1x0e+1x1e+1x2e", 8, 3.0
ATOL, RTOL = 2e-5, 1e-4
NAMES = ("dx", "demb", "dsh", "dW1", "dW2", "dW3")


def _specs():
    jconv = JConvTPSpec(JIrreps(X_IR), JIrreps(F_IR), j_infer(JIrreps(X_IR), JIrreps(F_IR), 2, "full"))
    conv = ConvTPSpec(Irreps(X_IR), Irreps(F_IR), infer_irreps_out(Irreps(X_IR), Irreps(F_IR), 2, "full"))
    dims = (8, 16, 16, conv.weight_numel)
    return ((jconv, JMLPSpec(dims), jfc.EdgeEmbedSpec(8, CUT, "XPLOR", 2.5, 2)),
            (conv, ScalarMLPSpec(dims), fc.EdgeEmbedSpec(8, CUT, "XPLOR", 2.5, 2)))


def _chain(n, seed=0):
    """Circular helix chain along x (tests/test_torch_ring.py's): neighbours
    at row offsets -2, -1, 1, 2, padded slots with the sentinel vector; the
    emb/sh of its edge vectors, features, weights and cotangent from
    ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    pos = np.stack([1.1 * t, 0.3 * np.sin(0.7 * t), 0.3 * np.cos(0.7 * t)], 1)
    src = np.tile(t[:, None], (1, K)).astype(np.int32)
    shift = np.zeros((n, K, 3), np.float32)
    mask = np.zeros((n, K), bool)
    vec = np.zeros((n, K, 3))
    vec[:, :, 0] = 2.0 * CUT
    for k, o in enumerate((-2, -1, 1, 2)):
        j = t + o
        shift[:, k, 0] = np.where(j >= n, 1.0, np.where(j < 0, -1.0, 0.0))
        src[:, k] = j % n
        mask[:, k] = True
        vec[:, k] = pos[j % n] + shift[:, k, 0:1] * np.array([[1.1 * n, 0, 0]]) - pos
    ev = torch.tensor(vec.reshape(n * K, 3), dtype=torch.float32)
    r = torch.linalg.vector_norm(ev, dim=-1)
    coef = torch.linspace(1.0, 8.0, 8)
    env = xplor_cutoff(r, CUT, 2.5) * torch.tensor(mask.reshape(-1), dtype=torch.float32)
    conv = _specs()[1][0]
    dims = (8, 16, 16, conv.weight_numel)
    return dict(
        src=src, shift=shift, mask=mask,
        mir=fc.mirror_map_numpy(src, shift, mask),
        vec=np.ascontiguousarray(vec.reshape(n * K, 3).T, np.float32),
        emb=(bessel_basis(r, coef, CUT) * env[:, None]).numpy(),
        sh=spherical_harmonics(2, ev, normalize=False).numpy(),
        x=(rng.normal(size=(n, conv.irreps_x.dim)) * 0.5).astype(np.float32),
        coef=coef.numpy(),
        ws=[rng.normal(size=(a, b)).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])],
        ybar=(rng.normal(size=(n, conv.irreps_mid.dim)) * 0.1).astype(np.float32),
    )


def _port(p, row_chunk, ring, param_grads):
    """Output and gradients (x, emb, sh, and with ``param_grads`` the MLP
    weights) of the port's emb/sh conv at the chain's cotangent."""
    conv, mlp, _ = _specs()[1]
    n = p["x"].shape[0]
    x, emb, sh = (torch.tensor(p[k], requires_grad=True) for k in ("x", "emb", "sh"))
    ws = [torch.tensor(w, requires_grad=param_grads) for w in p["ws"]]
    out = fc.fused_conv_apply(conv, mlp, {"w": ws}, x, emb.view(n, K, -1), sh.view(n, K, -1),
                              torch.tensor(p["src"]).long(), torch.tensor(p["mir"]).long(),
                              row_chunk=row_chunk, ring=ring)
    wrt = (x, emb, sh, *ws) if param_grads else (x, emb, sh)
    g = torch.autograd.grad(out, wrt, torch.tensor(p["ybar"]))
    return out.detach().numpy(), [t.numpy() for t in g]


def _jax(p, row_chunk, ring, param_grads):
    """The same through JAX's ``fused_conv_apply`` (block_atoms 8, kernels
    in interpret mode)."""
    jconv, jmlp, _ = _specs()[0]
    n = p["x"].shape[0]

    def f(ws, x, emb, sh):
        return jfc.fused_conv_apply(jconv, jmlp, {"w": list(ws)}, x, emb.reshape(n, K, -1),
                                    sh.reshape(n, K, -1), jnp.asarray(p["src"]),
                                    jnp.asarray(p["mir"]), block_atoms=8,
                                    param_grads=param_grads, row_chunk=row_chunk, ring=ring)

    out, pull = jax.vjp(f, tuple(jnp.asarray(w) for w in p["ws"]),
                        *[jnp.asarray(p[k]) for k in ("x", "emb", "sh")])
    dws, dx, demb, dsh = pull(jnp.asarray(p["ybar"]))
    return np.asarray(out), [np.asarray(a) for a in (dx, demb, dsh, *(dws if param_grads else ()))]


@pytest.mark.parametrize("case", [
    # (port row_chunk, port ring, rows, JAX row_chunk, JAX ring)
    (16, 1, 48, 16, True),    # ring W 1: three chunks, two of them wrapping
    (16, 0, 48, 16, False),   # chunked scatter
    (12, 0, 80, 24, False),   # chunked scatter, rows padded (84 here, 96 in JAX)
    (8, 2, 80, 0, False),     # ring W 2 (ten chunks, the wrap slots in use); JAX has W 1 only
], ids=["ring-W1", "chunked", "chunked-padded", "ring-W2"])
@pytest.mark.parametrize("param_grads", [False, True])
def test_embsh_chunked_paths_match_jax(case, param_grads):
    """The port's emb/sh chunked and ring backward against the JAX package's
    ``fused_conv_apply`` (its ring, its chunked path, or unchunked where
    the JAX package has no counterpart): outputs, dx, demb, dsh and, with
    parameter gradients, the MLP weights'."""
    rc, ring, n, jrc, jring = case
    p = _chain(n, seed=n)
    out_j, want = _jax(p, jrc, jring, param_grads)
    out, got = _port(p, rc, ring, param_grads)
    np.testing.assert_allclose(out, out_j, atol=1e-5, rtol=1e-5)
    assert len(got) == len(want) == (6 if param_grads else 3)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


def test_embsh_ring_checks_its_contract():
    """The emb/sh ring refuses a row chunk that leaves fewer than 2W + 1
    chunks or does not divide the rows, and atoms whose mirrors lie outside
    its window (the chain shuffled, as atoms no cell sort has ordered),
    where the chunked scatter backward still matches the unchunked conv; a
    second backward through either chunked path raises (first order only,
    as in the JAX package)."""
    conv, mlp, _ = _specs()[1]
    p = _chain(48)
    ws = {"w": [torch.tensor(w) for w in p["ws"]]}
    x = torch.tensor(p["x"], requires_grad=True)
    emb, sh = (torch.tensor(p[k], requires_grad=True).view(48, K, -1) for k in ("emb", "sh"))
    src, mir = torch.tensor(p["src"]).long(), torch.tensor(p["mir"]).long()
    with pytest.raises(ValueError, match="2W\\+1"):
        fc.fused_conv_apply(conv, mlp, ws, x, emb, sh, src, mir, row_chunk=16, ring=2)
    with pytest.raises(ValueError, match="divide"):
        fc.fused_conv_apply(conv, mlp, ws, x, emb, sh, src, mir, row_chunk=10, ring=1)
    for rc, ring in ((16, 1), (16, 0)):
        out = fc.fused_conv_apply(conv, mlp, ws, x, emb, sh, src, mir, row_chunk=rc, ring=ring)
        (g,) = torch.autograd.grad(out.square().sum(), x, create_graph=True)
        with pytest.raises(RuntimeError):
            g.sum().backward()

    n, rc = 80, 8
    q = _chain(n, seed=2)
    perm = np.random.default_rng(5).permutation(n)
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)
    q["src"] = rank[q["src"][perm]].astype(np.int32)
    q["shift"], q["mask"] = q["shift"][perm], q["mask"][perm]
    q["mir"] = fc.mirror_map_numpy(q["src"], q["shift"], q["mask"])
    q["x"], q["ybar"] = q["x"][perm], q["ybar"][perm]
    for k in ("emb", "sh"):
        q[k] = np.ascontiguousarray(q[k].reshape(n, K, -1)[perm].reshape(n * K, -1))
    with pytest.raises(ValueError, match="within W = 1 chunks"):
        _port(q, rc, 1, False)
    out0, g0 = _port(q, 0, 0, False)
    out, g = _port(q, rc, 0, False)
    np.testing.assert_allclose(out, out0, atol=1e-6, rtol=1e-6)
    for name, a, b in zip(NAMES, g, g0):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


def test_embsh_bwd_slot_plain_writes_exactly_its_slot():
    """The slot entry's plain twin: ``fused_conv_bwd_embsh_plain``'s dxg of
    the chunk lands in rows [slot*RC*K, (slot+1)*RC*K) of the buffer, the
    other rows stay bitwise as they were, and demb and dsh are the chunk's;
    the wrapper takes the twin on the CPU and checks the buffer and the
    slot."""
    conv, mlp, _ = _specs()[1]
    op = fc.conv_op(conv, mlp, None)
    p = _chain(48)
    x, src, ybar = torch.tensor(p["x"]), torch.tensor(p["src"]), torch.tensor(p["ybar"])
    emb, sh = torch.tensor(p["emb"]), torch.tensor(p["sh"])
    ws = [torch.tensor(w) for w in p["ws"]]
    RC, S, j, slot = 16, 5, 1, 3
    rows = slice(j * RC * K, (j + 1) * RC * K)
    src_c, yb = src[j * RC:(j + 1) * RC], ybar[j * RC:(j + 1) * RC]
    dxg, demb, dsh = fc.fused_conv_bwd_embsh_plain(op, x, src_c, emb[rows], sh[rows], ws, yb)
    whole = fc.fused_conv_bwd_embsh_plain(op, x, src, emb, sh, ws, ybar)
    for a, b in zip((dxg, demb, dsh), whole):
        np.testing.assert_allclose(a.numpy(), b[rows].numpy(), atol=1e-6)
    for fn in (fc.fused_conv_bwd_embsh_slot_plain, fc.fused_conv_bwd_embsh_slot):
        buf = torch.full((S * RC * K, op.dim_x), 7.25)
        before = buf.clone()
        got = fn(op, x, src_c, emb[rows], sh[rows], ws, yb, buf, slot)
        in_slot = slice(slot * RC * K, (slot + 1) * RC * K)
        assert torch.equal(buf[in_slot], dxg)
        assert torch.equal(got[0], demb) and torch.equal(got[1], dsh)
        keep = torch.ones(S * RC * K, dtype=torch.bool)
        keep[in_slot] = False
        assert torch.equal(buf[keep], before[keep])
    with pytest.raises(ValueError, match="slot"):
        fc.fused_conv_bwd_embsh_slot(op, x, src_c, emb[rows], sh[rows], ws, yb, buf, S)
    with pytest.raises(ValueError, match="buf"):
        fc.fused_conv_bwd_embsh_slot(op, x, src_c, emb[rows], sh[rows], ws, yb, buf[:-1], 0)


@pytest.mark.parametrize("row_chunk", [0, 12])
@pytest.mark.parametrize("mode", ["embsh", "vec"])
def test_ext_conv_matches_jax(mode, row_chunk):
    """``fused_conv_apply_ext`` / ``_ext_vec`` on 36 receivers whose senders
    index a 48-row ``x_ext`` (the chain's other 12 atoms standing as ghost
    rows, a third more than the receivers): output and the gradients of
    x_ext (ghost rows included), the edge inputs and every MLP weight
    against the JAX package's, one chunk or three (RC 12, the JAX side 16,
    both padded)."""
    (jconv, jmlp, jemb), (conv, mlp, emb_spec) = _specs()
    p = _chain(48, seed=7)
    n = 36
    src = p["src"][:n]
    rows = slice(0, n * K)
    ybar = p["ybar"][:n]
    if mode == "vec":
        edge = (np.ascontiguousarray(p["vec"][:, rows]),)
    else:
        edge = (p["emb"][rows], p["sh"][rows])
    assert (src >= n).any(), "want ghost senders"

    def jf(ws, x, *e):
        kw = dict(block_atoms=8, param_grads=True, row_chunk=16 if row_chunk else 0)
        if mode == "vec":
            return jfc.fused_conv_apply_ext_vec(jconv, jmlp, {"w": list(ws)}, coef_j, jemb, x,
                                                e[0], jnp.asarray(src), **kw)
        return jfc.fused_conv_apply_ext(jconv, jmlp, {"w": list(ws)}, x, e[0].reshape(n, K, -1),
                                        e[1].reshape(n, K, -1), jnp.asarray(src), **kw)

    coef_j = jnp.asarray(p["coef"])[:, None]
    out_j, pull = jax.vjp(jf, tuple(jnp.asarray(w) for w in p["ws"]), jnp.asarray(p["x"]),
                          *[jnp.asarray(e) for e in edge])
    jdws, jdx, *jde = pull(jnp.asarray(ybar))

    x = torch.tensor(p["x"], requires_grad=True)
    tedge = [torch.tensor(e, requires_grad=True) for e in edge]
    ws = [torch.tensor(w, requires_grad=True) for w in p["ws"]]
    src_t = torch.tensor(src).long()
    if mode == "vec":
        out = fc.fused_conv_apply_ext_vec(conv, mlp, {"w": ws}, torch.tensor(p["coef"]),
                                          emb_spec, x, tedge[0], src_t, row_chunk=row_chunk)
    else:
        out = fc.fused_conv_apply_ext(conv, mlp, {"w": ws}, x, tedge[0].view(n, K, -1),
                                      tedge[1].view(n, K, -1), src_t, row_chunk=row_chunk)
    assert out.shape == (n, conv.irreps_mid.dim)
    g = torch.autograd.grad(out, (x, *tedge, *ws), torch.tensor(ybar))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    assert np.abs(g[0].numpy()[n:]).max() > 1e-3, "the ghost rows get their cotangent"
    for i, (a, b) in enumerate(zip(g, [jdx, *jde, *jdws])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=str(i))
