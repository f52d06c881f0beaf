"""bigsi-tpu: a BItsliced Genomic Signature Index on a JAX accelerator.

A from-scratch rebuild of BIGSI (Phelimb/BIGSI, Bradley et al., Nature
Biotechnology 2019): sample Bloom filters are packed into a
device-resident, column-sharded uint32 bitslice matrix; k-mer hashing
and the row-gather/AND/popcount query programs run on the device (an
NVIDIA GPU) via JAX/XLA, scaling over a ``jax.sharding.Mesh``.
"""

from bigsi_tpu.version import __version__
from bigsi_tpu.graph import BIGSI, BigsiQueryResult

__all__ = ["BIGSI", "BigsiQueryResult", "__version__"]
