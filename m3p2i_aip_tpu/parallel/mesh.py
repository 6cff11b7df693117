"""Device-mesh helpers for sharding MPPI rollouts across chips.

Design (SURVEY.md §2.2, §5 "Distributed communication backend"): the K
rollout samples are embarrassingly parallel through the dynamics scan; only
the distribution update needs cross-sample reductions (min / sum / argmax of
the [K] cost vector — a few scalars of collective traffic per replan).  So the
sharding story is: 1-D mesh over the sample axis, GSPMD auto-partitioning from
one ``with_sharding_constraint`` on the sampled action tensor.  M3P2I's two
modes live in the two halves of K (mppi.py:397-400), so an even device count
also splits cleanly mode-major: devices [0, n/2) carry mode 0, the rest mode 1,
and per-mode masked reductions stay local-heavy.

The mesh is a flat 1-D device list: the cards of one host are joined all to
all (NVLink), so the layout follows the algorithm alone.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SAMPLE_AXIS = "samples"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the sample axis (all local devices by default)."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (SAMPLE_AXIS,))


def sample_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for [K, ...] tensors: partitioned on the leading sample axis."""
    return NamedSharding(mesh, P(SAMPLE_AXIS))


def shard_planner(planner, mesh: Optional[Mesh] = None):
    """Attach a mesh to an MPPI/M3P2I planner (in place) and return it.

    The planner's jitted ``command`` then constrains its [K, T, nu] sample
    tensor to the mesh, letting GSPMD partition the rollout over chips.
    K must be divisible by the mesh size.
    """
    mesh = mesh if mesh is not None else make_mesh()
    n = mesh.devices.size
    if planner.K % n:
        raise ValueError(f"num_samples={planner.K} not divisible by mesh size {n}")
    planner.set_mesh(mesh)
    return planner
