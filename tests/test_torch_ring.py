"""The port's large-system conv against the JAX package's: the ring backward
(``sevennet_tpu/ops/fused_conv.py:_fused_conv_ring_v``, kernel B3 in
interpret mode on the CPU, as tests/test_fused_conv.py runs it), the
chunked scatter backward, B3's plain twin, the device mirror map, and the
model's routing (``model/model.py:conv_row_chunk``).

On the CPU the port's wrappers run the kernels' plain versions; B3 itself is
held against its twin on the card (tests/test_torch_kernels.py,
chip_smoke.py).

Shapes: ``8x0e+8x1e+8x2e``, MLP (8, 16, 16, numel), a circular helix chain
(K 8, four neighbours per atom, every mirror within two rows), made with
numpy from a seed. Tolerances: atol 2e-5 and rtol 1e-4 for the gradients
(the JAX test's), 1e-5 for outputs: fp32 on both sides, sums in another
order.
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
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec

torch.set_num_threads(1)
X_IR, F_IR, K, CUT = "8x0e+8x1e+8x2e", "1x0e+1x1e+1x2e", 8, 3.0
ATOL, RTOL = 2e-5, 1e-4


def _specs():
    jconv = JConvTPSpec(JIrreps(X_IR), JIrreps(F_IR), j_infer(JIrreps(X_IR), JIrreps(F_IR), 2, "full"))
    conv = ConvTPSpec(Irreps(X_IR), Irreps(F_IR), infer_irreps_out(Irreps(X_IR), Irreps(F_IR), 2, "full"))
    dims = (8, 16, 16, conv.weight_numel)
    return ((jconv, JMLPSpec(dims), jfc.EdgeEmbedSpec(8, CUT, "XPLOR", 2.5, 2)),
            (conv, ScalarMLPSpec(dims), fc.EdgeEmbedSpec(8, CUT, "XPLOR", 2.5, 2)))


def _chain(n, seed=0):
    """Circular helix chain along x (tests/test_fused_conv.py:_chain_vec_setup):
    neighbours at row offsets -2, -1, 1, 2, padded slots with the sentinel
    vector; features, weights and cotangent from ``seed``."""
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
    conv = _specs()[1][0]
    dims = (8, 16, 16, conv.weight_numel)
    return dict(
        src=src, shift=shift, mask=mask,
        mir=fc.mirror_map_numpy(src, shift, mask),
        vec=np.ascontiguousarray(vec.reshape(n * K, 3).T, np.float32),
        x=(rng.normal(size=(n, conv.irreps_x.dim)) * 0.5).astype(np.float32),
        coef=np.linspace(1.0, 8.0, 8).astype(np.float32),
        ws=[rng.normal(size=(a, b)).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])],
        ybar=(rng.normal(size=(n, conv.irreps_mid.dim)) * 0.1).astype(np.float32),
    )


def _port_grads(p, row_chunk, ring, param_grads):
    """Output and gradients (x, vec, and with ``param_grads`` coef and the
    MLP weights) of the port's conv at the chain's cotangent."""
    conv, mlp, emb = _specs()[1]
    x = torch.tensor(p["x"], requires_grad=True)
    vec = torch.tensor(p["vec"], requires_grad=True)
    coef = torch.tensor(p["coef"], requires_grad=param_grads)
    ws = [torch.tensor(w, requires_grad=param_grads) for w in p["ws"]]
    out = fc.fused_conv_apply_vec(conv, mlp, {"w": ws}, coef, emb, x, vec,
                                  torch.tensor(p["src"]).long(), torch.tensor(p["mir"]).long(),
                                  row_chunk=row_chunk, ring=ring)
    wrt = (x, vec, coef, *ws) if param_grads else (x, vec)
    g = torch.autograd.grad(out, wrt, torch.tensor(p["ybar"]))
    return out.detach().numpy(), [t.numpy() for t in g]


@pytest.mark.parametrize("param_grads", [False, True])
def test_ring_matches_jax_ring(param_grads):
    """The port's ring backward (row_chunk 16, W 1, 48 rows: three chunks,
    two of them wrapping) against the JAX ring path with the same
    arguments, whose B3 (``param_grads=False``) or B2′ per chunk runs in
    interpret mode: outputs, and the gradients of x, vec and, with
    parameter gradients, coef and the MLP weights."""
    (jconv, jmlp, jemb), _ = _specs()
    p = _chain(48)

    def f(ws, coef, x, vec):
        return jfc.fused_conv_apply_vec(
            jconv, jmlp, {"w": list(ws)}, coef[:, None], jemb, x, vec, jnp.asarray(p["src"]),
            jnp.asarray(p["mir"]), block_atoms=8, param_grads=param_grads, row_chunk=16, ring=1)

    out_j, pull = jax.vjp(f, tuple(jnp.asarray(w) for w in p["ws"]), jnp.asarray(p["coef"]),
                          jnp.asarray(p["x"]), jnp.asarray(p["vec"]))
    jdws, jdcoef, jdx, jdvec = pull(jnp.asarray(p["ybar"]))
    out, g = _port_grads(p, 16, 1, param_grads)
    np.testing.assert_allclose(out, np.asarray(out_j), atol=1e-5, rtol=1e-5)
    want = [jdx, jdvec] + ([jdcoef, *jdws] if param_grads else [])
    for name, a, b in zip(("dx", "dvec", "dcoef", "dW1", "dW2", "dW3"), g, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("row_chunk,ring,n", [(8, 2, 80), (16, 1, 48), (12, 0, 80), (16, 0, 48)],
                         ids=["ring-W2", "ring-W1", "chunked-padded", "chunked"])
@pytest.mark.parametrize("param_grads", [False, True])
def test_chunked_paths_match_unchunked(row_chunk, ring, n, param_grads):
    """The ring backward at W 2 (RC 8, 80 rows: ten chunks, the rolling
    buffer's wrap slots in use) and W 1, and the chunked scatter backward
    (RC 12 pads 80 rows to 84 with sentinel rows), against the port's
    unchunked mirror path."""
    p = _chain(n, seed=1)
    out0, g0 = _port_grads(p, 0, 0, param_grads)
    out, g = _port_grads(p, row_chunk, ring, param_grads)
    np.testing.assert_allclose(out, out0, atol=1e-6, rtol=1e-6)
    for name, a, b in zip(("dx", "dvec", "dcoef", "dW1", "dW2", "dW3"), g, g0):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


def test_ring_checks_its_contract():
    """The ring needs RC to split the rows into >= 2W + 1 chunks; a second
    backward through a chunked path raises (first order only, as the JAX
    ring path offers no grad-of-grad)."""
    conv, mlp, emb = _specs()[1]
    p = _chain(48)
    args = (conv, mlp, {"w": [torch.tensor(w) for w in p["ws"]]}, torch.tensor(p["coef"]), emb)
    x = torch.tensor(p["x"], requires_grad=True)
    vec = torch.tensor(p["vec"], requires_grad=True)
    src, mir = torch.tensor(p["src"]).long(), torch.tensor(p["mir"]).long()
    with pytest.raises(ValueError, match="2W\\+1"):
        fc.fused_conv_apply_vec(*args, x, vec, src, mir, row_chunk=16, ring=2)
    with pytest.raises(ValueError, match="divide"):
        fc.fused_conv_apply_vec(*args, x, vec, src, mir, row_chunk=10, ring=1)
    for rc, ring in ((16, 1), (16, 0)):
        out = fc.fused_conv_apply_vec(*args, x, vec, src, mir, row_chunk=rc, ring=ring)
        (gx,) = torch.autograd.grad(out.square().sum(), vec, create_graph=True)
        with pytest.raises(RuntimeError):
            gx.sum().backward()


def test_ring_refuses_mirrors_outside_its_window():
    """The chain with its atoms shuffled (mirrors many chunks from their
    rows, as on atoms no cell sort has ordered): the ring backward raises
    instead of reading slots that hold other chunks; the chunked scatter
    backward, which takes any order, matches the unchunked conv there."""
    conv, mlp, emb = _specs()[1]
    n, rc = 80, 8
    p = _chain(n, seed=2)
    perm = np.random.default_rng(5).permutation(n)
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)
    src = rank[p["src"][perm]].astype(np.int32)
    shift, mask = p["shift"][perm], p["mask"][perm]
    q = dict(p, src=src, shift=shift, mask=mask, mir=fc.mirror_map_numpy(src, shift, mask),
             x=p["x"][perm], ybar=p["ybar"][perm],
             vec=np.ascontiguousarray(p["vec"].T.reshape(n, K, 3)[perm].reshape(n * K, 3).T))
    mir = torch.tensor(q["mir"])
    d = np.mod(q["mir"] // K // rc - np.arange(n)[:, None] // rc, n // rc)
    assert ((d > 1) & (d < n // rc - 1)).any()
    with pytest.raises(ValueError, match="within W = 1 chunks"):
        fc.fused_conv_apply_vec(conv, mlp, {"w": [torch.tensor(w) for w in q["ws"]]},
                                torch.tensor(q["coef"]), emb, torch.tensor(q["x"]),
                                torch.tensor(q["vec"]), torch.tensor(q["src"]).long(), mir,
                                row_chunk=rc, ring=1)
    out0, g0 = _port_grads(q, 0, 0, False)
    out, g = _port_grads(q, rc, 0, False)
    np.testing.assert_allclose(out, out0, atol=1e-6, rtol=1e-6)
    for name, a, b in zip(("dx", "dvec"), g, g0):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


def test_bwd_slot_plain_writes_exactly_its_slot():
    """B3's plain twin: ``fused_conv_bwd_plain``'s dxg of the chunk lands in
    rows [slot*RC*K, (slot+1)*RC*K) of the buffer, the other rows stay
    bitwise as they were, and dvec is the chunk's; the wrapper takes the
    twin on the CPU and checks the buffer and the slot."""
    conv, mlp, emb = _specs()[1]
    op = fc.conv_op(conv, mlp, emb)
    p = _chain(48)
    x, coef = torch.tensor(p["x"]), torch.tensor(p["coef"])
    ws = [torch.tensor(w) for w in p["ws"]]
    src, vec, ybar = torch.tensor(p["src"]), torch.tensor(p["vec"]), torch.tensor(p["ybar"])
    RC, S, j, slot = 16, 5, 1, 3
    src_c, vec_c, yb = fc._chunk(RC, K, j, src, vec, ybar)
    dxg, dvec = fc.fused_conv_bwd_plain(op, x, src_c, vec_c, coef, ws, yb)
    dxg_all, dvec_all = fc.fused_conv_bwd_plain(op, x, src, vec, coef, ws, ybar)
    np.testing.assert_allclose(dxg.numpy(), dxg_all[j * RC * K:(j + 1) * RC * K].numpy(), atol=1e-6)
    np.testing.assert_allclose(dvec.numpy(), dvec_all[:, j * RC * K:(j + 1) * RC * K].numpy(),
                               atol=1e-6)
    for fn in (fc.fused_conv_bwd_slot_plain, fc.fused_conv_bwd_slot):
        buf = torch.full((S * RC * K, op.dim_x), 7.25)
        before = buf.clone()
        got = fn(op, x, src_c, vec_c, coef, ws, yb, buf, slot)
        rows = slice(slot * RC * K, (slot + 1) * RC * K)
        assert torch.equal(buf[rows], dxg) and torch.equal(got, dvec)
        keep = torch.ones(S * RC * K, dtype=torch.bool)
        keep[rows] = False
        assert torch.equal(buf[keep], before[keep])
    with pytest.raises(ValueError, match="slot"):
        fc.fused_conv_bwd_slot(op, x, src_c, vec_c, coef, ws, yb, buf, S)
    with pytest.raises(ValueError, match="buf"):
        fc.fused_conv_bwd_slot(op, x, src_c, vec_c, coef, ws, yb, buf[:-1], 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_map_on_device_matches_numpy(seed):
    """``mirror_map`` (tensors, int64 keys) equals ``mirror_map_numpy`` and
    the JAX package's ``mirror_map``, padded slots (mapped to themselves)
    included, on a periodic random box with image shifts."""
    from sevennet_tpu_torch.data.graph import densify_edges
    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy

    rng = np.random.default_rng(seed)
    n, box = 40, 6.0
    pos = rng.uniform(0.0, box, (n, 3))
    dst, src, shift = neighbor_list_numpy(pos, 3.0, np.eye(3) * box, True)
    order = np.argsort(dst, kind="stable")
    k = int(np.bincount(dst).max()) + 3
    src_d, _, shift_d, mask_d = densify_edges(src[order].astype(np.int32),
                                              dst[order].astype(np.int32), shift[order],
                                              np.ones(len(dst), bool), n, k)
    args = (src_d.reshape(n, k), shift_d.reshape(n, k, 3), mask_d.reshape(n, k))
    assert (np.abs(shift_d) > 0).any() and not mask_d.all()
    want = fc.mirror_map_numpy(*args)
    got = fc.mirror_map(*[torch.as_tensor(a) for a in args])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jfc.mirror_map(*[jnp.asarray(a) for a in args])))
    flat = np.arange(n * k).reshape(n, k)
    assert (want[~args[2]] == flat[~args[2]]).all()


def test_model_routes_large_layers_to_the_chunked_conv(monkeypatch):
    """``conv_row_chunk``: the JAX rule (``edge_chunk // K`` rows once a
    layer's gathered edge tensor passes ``chunk_threshold``, whose default
    ``SEVENNET_TPU_CHUNK_THRESHOLD`` overrides); the model's energy is the
    same chunked, ring-chunked and unchunked, and emb/sh mode refuses to
    chunk rather than run unchunked."""
    import dataclasses

    from sevennet_tpu_torch.data.graph import dense_graph_from_arrays
    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.model.model import conv_row_chunk, model_compute

    spec = build_model_spec({"channel": 4, "lmax": 1, "num_convolution_layer": 2,
                             "chemical_species": ["O"], "_edge_chunk": 64})
    assert fc.chunk_threshold() == fc.CHUNK_THRESHOLD_BYTES
    assert conv_row_chunk(spec, 100_000, 64, 480) == 0
    monkeypatch.setenv("SEVENNET_TPU_CHUNK_THRESHOLD", "1000")
    assert fc.chunk_threshold() == 1000
    assert conv_row_chunk(spec, 40, 8, 16) == 8
    assert conv_row_chunk(dataclasses.replace(spec, edge_chunk=0), 40, 8, 16) == 0

    params = params_from_numpy(spec, random_params(spec, 0))
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.0, 9.0, (36, 3))
    dst, src, shift = neighbor_list_numpy(pos, spec.cutoff, np.eye(3) * 9.0, True)
    g = dense_graph_from_arrays(pos, np.zeros(36), src, dst, shift, np.eye(3) * 9.0)
    ref = model_compute(dataclasses.replace(spec, edge_chunk=0), params, g, device="cpu")
    K = g.dense_k
    for extra in ({"edge_chunk": 12 * K}, {"edge_chunk": 10 * K}, {"edge_chunk": 12 * K,
                                                                     "conv_ring": 1}):
        s = dataclasses.replace(spec, **extra)
        assert conv_row_chunk(s, 36, K, 4) > 0
        out = model_compute(s, params, g, device="cpu")
        np.testing.assert_allclose(out["energy"].numpy(), ref["energy"].numpy(), rtol=1e-6)
        np.testing.assert_allclose(out["forces"].numpy(), ref["forces"].numpy(), atol=1e-5)
    legacy = dataclasses.replace(spec, normalize_sph=False, edge_chunk=12 * K)
    with pytest.raises(NotImplementedError, match="A2"):
        model_compute(legacy, params, g, device="cpu")


def test_training_refuses_a_chunked_layer(monkeypatch):
    """``model_compute(create_graph=True)`` (the trainer's force and stress
    loss) raises where a layer would chunk, since the chunked and ring
    backward are first order only; below the threshold, and on the plain
    path, it runs."""
    import dataclasses

    from sevennet_tpu_torch.data.graph import dense_graph_from_arrays
    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.model.model import model_compute

    spec = build_model_spec({"channel": 4, "lmax": 1, "num_convolution_layer": 2,
                             "chemical_species": ["O"]})
    params = params_from_numpy(spec, random_params(spec, 0))
    pos = np.random.default_rng(4).uniform(0.0, 9.0, (36, 3))
    dst, src, shift = neighbor_list_numpy(pos, spec.cutoff, np.eye(3) * 9.0, True)
    g = dense_graph_from_arrays(pos, np.zeros(36), src, dst, shift, np.eye(3) * 9.0)
    chunked = dataclasses.replace(spec, edge_chunk=12 * g.dense_k)
    model_compute(chunked, params, g, device="cpu", create_graph=True)
    monkeypatch.setenv("SEVENNET_TPU_CHUNK_THRESHOLD", "1000")
    with pytest.raises(NotImplementedError, match="second derivative"):
        model_compute(chunked, params, g, device="cpu", create_graph=True)
    out = model_compute(chunked, params, g, device="cpu", create_graph=True, plain=True)
    assert out["forces"].requires_grad
