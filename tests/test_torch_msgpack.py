"""The port's msgpack decoder (``sevennet_tpu_torch/io/msgpack.py``)
against the ``msgpack`` package and flax's serializer, which the port may
not import: hypothesis-drawn nested trees of every msgpack type the JAX
package's checkpoints hold (nil, bool, int over the full 64-bit range,
float32 and float64, str, bin, array, map), numpy arrays and scalars as
flax's extension types 1 and 3, and arrays chunked as flax chunks arrays
over its chunk size. Decoding is exact: the same values, dtypes and shapes.
"""

import flax.serialization as fser
import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sevennet_tpu_torch.io.msgpack import msgpack_restore, unpackb

SCALARS = (st.none() | st.booleans() | st.integers(-(2 ** 63), 2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300))
TREES = st.recursive(
    SCALARS,
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=12) | st.integers(-1000, 1000), kids, max_size=20),
    max_leaves=60)
DTYPES = ("float32", "float64", "int32", "int64", "uint8", "bool", "float16", "complex64")


def _arrays(draw_shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=draw_shape) * 100
    if dtype.startswith("complex"):
        a = a + 1j * rng.normal(size=draw_shape)
    return a.astype(dtype)


ARRAYS = st.builds(_arrays, st.lists(st.integers(0, 5), max_size=3).map(tuple),
                   st.sampled_from(DTYPES), st.integers(0, 2 ** 16))
ARRAY_TREES = st.recursive(
    ARRAYS | ARRAYS.map(lambda a: a.reshape(-1)[0] if a.size else np.float32(1.5)),
    lambda kids: st.dictionaries(st.text(min_size=1, max_size=8), kids, max_size=6),
    max_leaves=20)


def _same(got, want, ordered=True):
    """Equal values, types and dtypes; map keys in the same order unless
    ``ordered`` is off (flax sorts a dict's keys when it writes)."""
    if isinstance(want, np.ndarray) or isinstance(want, np.generic):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict)
        assert list(got) == list(want) if ordered else sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k], ordered)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b, ordered)
    else:
        assert type(got) is type(want) and got == want


@settings(max_examples=200, deadline=None)
@given(tree=TREES, single=st.booleans())
def test_plain_trees_match_msgpack(tree, single):
    """Any tree of the plain types, floats packed as float64 or float32."""
    data = msgpack.packb(tree, use_single_float=single, use_bin_type=True)
    _same(unpackb(data), msgpack.unpackb(data, strict_map_key=False))


@settings(max_examples=100, deadline=None)
@given(tree=ARRAY_TREES)
def test_flax_array_trees_match_flax(tree):
    """Trees of numpy arrays and scalars as ``flax.serialization`` writes
    them (extension types 1 and 3)."""
    data = fser.msgpack_serialize(tree)
    _same(msgpack_restore(data), fser.msgpack_restore(data))


def test_chunked_arrays_join(monkeypatch):
    """Arrays over flax's chunk size arrive as chunk dicts; the decoder
    joins them as flax does (the chunk size set small to draw them)."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(7, 5)).astype(np.float32),
            "deep": {"b": np.arange(40, dtype=np.int64), "s": np.float32(2.0)},
            "small": np.ones(3, np.float64)}
    data = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_restore(data)
    _same(got, fser.msgpack_restore(data))
    _same(got, tree, ordered=False)


def test_malformed_data_raises():
    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="ends inside"):
        unpackb(data[:-1])
    with pytest.raises(ValueError, match="after the object"):
        unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="unknown type byte"):
        unpackb(b"\xc1")
