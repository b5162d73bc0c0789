"""The port's host partitioner (``sevennet_tpu_torch/parallel/partition.py``)
against the JAX package's: every array of the decomposition equal, for 1, 2
and 4 slabs along axes 0 and 2 of a periodic box, and the same refusal of
slabs thinner than the cutoff."""

import numpy as np
import pytest

from sevennet_tpu.parallel.partition import partition_system as j_partition
from sevennet_tpu_torch.parallel.partition import DomainDecomposition, partition_system

CUTOFF = 3.0


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(5)
    n, box = 72, 14.0
    pos = rng.uniform(0, box, (n, 3))
    species = rng.integers(0, 2, n).astype(np.int32)
    return pos, species, np.diag([box, box * 1.05, box * 0.95])


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("axis", [0, 2])
def test_partition_equals_jax(system, n_dev, axis):
    pos, species, cell = system
    dd = partition_system(pos, species, cell, CUTOFF, n_dev, axis=axis)
    jd = j_partition(pos, species, cell, CUTOFF, n_dev, axis=axis)
    for f in DomainDecomposition.__dataclass_fields__:
        got, want = getattr(dd, f), getattr(jd, f)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            assert got == want, f
    # every atom is owned exactly once
    owned = dd.owner_global_idx[dd.owner_global_idx >= 0]
    assert sorted(owned.tolist()) == list(range(len(pos)))


def test_partition_refuses_thin_slabs(system):
    pos, species, cell = system
    with pytest.raises(ValueError, match="slab thickness") as got:
        partition_system(pos, species, cell, CUTOFF, 5)
    with pytest.raises(ValueError, match="slab thickness") as want:
        j_partition(pos, species, cell, CUTOFF, 5)
    assert str(got.value) == str(want.value)
