"""Device-mesh helpers for multi-chip scaling.

The reference scales by running 5 ROS processes on one machine (SURVEY.md
§2.3); this design scales by sharding the data-parallel axes of the
SLAM workload over a `jax.sharding.Mesh`:

  * landmark/factor blocks of the BA Hessian  -> psum reduction (sharded_ba)
  * LiDAR map points for kNN                  -> per-shard top-k + merge
  * ScanContext database rows                 -> sharded distance matrix
  * keyframe ranges of the global pose graph  -> sharded residual/matvec
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "shard"  # single data axis: factors / map points / database rows


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (AXIS,))


_ACTIVE_MESH: Mesh | None = None


def set_active_mesh(mesh: Mesh | None):
    """Install the mesh used by sharded code paths selected via config flags
    (e.g. BAConfig.sharded) that cannot carry a Mesh object themselves."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh() -> Mesh:
    if _ACTIVE_MESH is None:
        raise RuntimeError("no active mesh: call parallel.mesh.set_active_mesh")
    return _ACTIVE_MESH


def shard_rows(mesh: Mesh):
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
