"""Write a frozen TorchScript deployment of a model in the layout of the
reference's LAMMPS deployments (``sevenn/scripts/deploy.py:16-77``), for
the importers (``sevennet_tpu/io/torchscript_import.py`` and the port's
copy) to read back. Used by tests/test_torch_torchscript_import.py and by
``chip_smoke.py``'s deployed phase; it imports torch, numpy and the port
only.

The artifact holds each parameter as a constant of the frozen graph, in
the reference's execution order (built here from the ``ModelSpec``): the
Bessel coefficients; the embedding linear; per layer the self connection,
the first self-interaction, the radial MLP, the denominator, the second
self-interaction; the readout; the scale and the shift. A path's constant
is its checkpoint weight times its norm ``T`` (a linear's path weight, a
tensor product's ``pw / sqrt(dim_out)``, the radial MLP's
``1 / sqrt(fan_in)``) over the explicit scalar ``s`` its consumer
multiplies the data by (1 unless the caller scales that entry). Its
``forward`` is flat and multiplies each constant by a value derived from
the input, so that freezing can fold none of them away; equal constants
(the denominators of a model) are pooled by freezing as in the
reference's artifacts.

A pre-0.11 artifact (``old``) stores the last radial-MLP layer's columns
in the tensor product's construction order, each path's columns negated
where its Wigner table is stored negated, and carries the tables.
"""

import time

import numpy as np
import torch

from sevennet_tpu_torch.io.torch_checkpoint import state_dict_from_params
from sevennet_tpu_torch.model.build import CHEMICAL_SYMBOLS
from sevennet_tpu_torch.so3.wigner import real_wigner_3j


def _split(flat, shapes):
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(np.asarray(flat[off:off + n]).reshape(shape))
        off += n
    assert off == flat.size, (off, flat.size)
    return out


def _w3j_triples(conv):
    """(l1, l2, l3) of every conv path with all three l > 0, in order."""
    seen = []
    for i, j, k in conv.instructions_enum:
        ls = (conv.irreps_x[i].ir.l, conv.irreps_filter[j].ir.l, conv.irreps_mid[k].ir.l)
        if min(ls) > 0 and ls not in seen:
            seen.append(ls)
    return seen


def _construction_order(conv, w, flips):
    """The last radial-MLP weight's columns from sorted-instruction order
    back to construction order, negated on the paths of ``flips``; as it is
    where the two orders coincide (the importers then sort nothing)."""
    if tuple(ins[:3] for ins in conv.instructions) == tuple(conv.instructions_enum):
        return w
    blocks, off = {}, 0
    for ins in conv.instructions:
        i, j, k = ins[:3]
        mul = conv.irreps_x[i].mul * conv.irreps_filter[j].mul
        blocks[(i, j, k)] = w[:, off:off + mul]
        off += mul
    cols = []
    for i, j, k in conv.instructions_enum:
        ls = (conv.irreps_x[i].ir.l, conv.irreps_filter[j].ir.l, conv.irreps_mid[k].ir.l)
        cols.append(-blocks[(i, j, k)] if ls in flips else blocks[(i, j, k)])
    return np.concatenate(cols, axis=1)


def constant_stream(spec, params, scaled=(), scale=1.0, old=False, flips=()):
    """``[(key, float32 array, s)]`` in deployed execution order. ``scaled``
    names the state-dict keys whose consumers multiply the data by
    ``scale`` (``s``); an ``old`` stream carries every layer's Wigner
    tables (``key`` None), those of ``flips`` negated, and the last
    radial-MLP columns in construction order."""
    sd = state_dict_from_params(spec, params)
    stream = []

    def emit(key, consts, norms):
        s = scale if key in scaled else 1.0
        for c, T in zip(consts, norms):
            stream.append((key, (np.asarray(c, np.float64) * (T / s)).astype(np.float32), s))

    def linear(key, lspec):
        emit(key, _split(sd[key], lspec.weight_shapes), [a for _, _, a in lspec.instructions])

    def raw(key, shape=None):
        v = np.asarray(sd[key], np.float32)
        stream.append((key, v.reshape(shape) if shape else v, 1.0))

    raw("edge_embedding.basis_function.coeffs")
    linear("onehot_to_feature_x.linear.weight", spec.embed_linear)
    for L in spec.layers:
        t = L.t
        if L.sc_type == "nequip":
            key = f"{t}_self_connection_intro.fc_tensor_product.weight"
            f = L.sc_fctp
            emit(key, _split(sd[key], f.weight_shapes),
                 [pw / np.sqrt(f.irreps_out[io].ir.dim) for _, _, io, pw in f.instructions])
        elif L.sc_type == "linear":
            linear(f"{t}_self_connection_intro.linear.weight", L.sc_linear)
        linear(f"{t}_self_interaction_1.linear.weight", L.si1)
        if old:
            for ls in _w3j_triples(L.conv):
                tab = real_wigner_3j(*ls) * (-1.0 if ls in flips else 1.0)
                stream.append((None, tab.astype(np.float32), 1.0))
        dims = L.radial_mlp.dims
        for i in range(len(dims) - 1):
            key = f"{t}_convolution.weight_nn.layer{i}.weight"
            w = np.asarray(sd[key])
            if old and i == len(dims) - 2:
                w = _construction_order(L.conv, w, flips)
            emit(key, [w], [1.0 / np.sqrt(dims[i])])
        raw(f"{t}_convolution.denominator", (1,))
        linear(f"{t}_self_interaction_2.linear.weight", L.si2)
    linear("reduce_input_to_hidden.linear.weight", spec.readout1)
    linear("reduce_hidden_to_energy.linear.weight", spec.readout2)
    raw("rescale_atomic_energy.scale")
    raw("rescale_atomic_energy.shift")
    return stream


class _Deployed(torch.nn.Module):
    """Multiplies each constant by the input (or by ``input * s`` where
    its entry is scaled) and sums: every constant is consumed once, in
    stream order, by an ``aten::mul`` whose other operand is the data."""

    def __init__(self, stream):
        super().__init__()
        self.scales = [s for _, _, s in stream]
        for i, (_, c, _) in enumerate(stream):
            self.register_buffer(f"c{i}", torch.from_numpy(c))

    def forward(self, x):
        acc = x * 0.0
        for i, s in enumerate(self.scales):
            data = x if s == 1.0 else x * s
            acc = acc + (getattr(self, f"c{i}") * data).sum()
        return acc


def write_deployed(path, spec, params, version="0.11.0", cutoff=None, **stream_kw):
    """Trace, freeze and save the artifact of ``spec``/``params`` at
    ``path`` with the deployment's ``_extra_files``; returns the stream
    written (:func:`constant_stream`)."""
    stream = constant_stream(spec, params, **stream_kw)
    module = torch.jit.trace(_Deployed(stream).eval(), torch.tensor(1.0))
    frozen = torch.jit.freeze(module)
    symbols = [CHEMICAL_SYMBOLS[z] for z, _ in sorted(spec.type_map, key=lambda zt: zt[1])]
    extra = {
        "chemical_symbols_to_index": " ".join(symbols),
        "cutoff": str(spec.cutoff if cutoff is None else cutoff),
        "num_species": str(len(symbols)),
        "model_type": "E3_equivariant_model",
        "version": version,
        "dtype": "single",
        "time": time.strftime("%Y-%m-%d"),
    }
    torch.jit.save(frozen, str(path), _extra_files=extra)
    return stream
