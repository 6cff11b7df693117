"""Multi-chip scaling of the sample/mode axes over a ``jax.sharding.Mesh``.

The reference's only parallelism is the K-sample rollout batch inside one GPU
(SURVEY.md §2.2); here that axis shards across devices: the planner
annotates the [K, T, nu] action tensor with a named sharding and GSPMD
partitions the vmapped rollout, inserting the all-reduces for the global
min/sum/argmax of the weight computation automatically.
"""
from m3p2i_aip_tpu.parallel.mesh import (
    SAMPLE_AXIS,
    make_mesh,
    sample_sharding,
    shard_planner,
)
