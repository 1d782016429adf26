"""SPMD scaling plane: meshes, halo sharding, collective count merging.

The reference is single-threaded library code (SURVEY.md §2.7); this
plane is the framework's new design obligation: data-parallel k-mer
pipelines over a ``jax.sharding.Mesh`` with (K-1)-base halos and
hash-prefix ``all_to_all`` count-table exchange.
"""

from .mesh import data_mesh
from .pipeline import (
    ShardedCountConfig,
    sharded_canonical_count,
    sharded_count_step,
    exchange_and_merge,
)
from .sixframe import SixFrameCountConfig, sharded_sixframe_aa_count
from .minimizers import sharded_minimizer_select
from .multiword import sharded_canonical_count_mw
