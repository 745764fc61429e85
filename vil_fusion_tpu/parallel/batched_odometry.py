"""Sequence-parallel LiDAR odometry over the device mesh.

The cleanest multi-chip scaling axis for a SLAM workload is embarrassingly
parallel: S independent sequences (dataset evaluation sweeps, multi-robot
fleets, parameter searches) with the sequence axis sharded over devices —
each chip runs the full fused odometry step for its sequences, zero
communication. shard_map runs the vmapped step on each device's local
sequences, so custom kernels inside it (the GPU kNN) stay per-device
instead of being left to XLA's partitioner.
"""
from __future__ import annotations

import functools

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from vil_fusion_tpu.models import lidar_odometry as lo
from vil_fusion_tpu.parallel.mesh import AXIS


def shard_states(mesh, states: lo.MapState):
    """Place a batched MapState with the sequence axis sharded over the mesh."""
    sh = NamedSharding(mesh, P(AXIS))
    return jax.tree.map(lambda a: jax.device_put(a, sh), states)


def odometry_step_sharded(mesh, states: lo.MapState, points, valid,
                          cfg: lo.OdomConfig = lo.OdomConfig()):
    """One step of S sequences, S sharded over devices. Inputs `points`
    (S, N, 3) / `valid` (S, N) are placed with the same sharding."""
    sh = NamedSharding(mesh, P(AXIS))
    points = jax.device_put(points, sh)
    valid = jax.device_put(valid, sh)
    return _sharded_step(mesh, cfg)(states, points, valid)


@functools.lru_cache(maxsize=None)
def _sharded_step(mesh, cfg: lo.OdomConfig):
    return jax.jit(jax.shard_map(
        lambda s, p, v: lo.odometry_step_batched(s, p, v, cfg),
        mesh=mesh, in_specs=P(AXIS), out_specs=P(AXIS), check_vma=False))
