"""Domain-decomposed evaluation and MD on ``torch.distributed`` (the port
of ``sevennet_tpu/parallel``): the host partitioner (:mod:`.partition`),
the halo transport (:mod:`.comm`), energy and forces of a partition
(:mod:`.model`) and the distributed MD engine (:mod:`.md`)."""

from .md import DistMDState, DistributedMDEngine
from .model import distributed_compute, make_distributed_compute
from .partition import DomainDecomposition, partition_system

__all__ = [
    "DomainDecomposition",
    "partition_system",
    "distributed_compute",
    "make_distributed_compute",
    "DistributedMDEngine",
    "DistMDState",
]
