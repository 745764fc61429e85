#!/usr/bin/env python
"""A/B of the two kNN paths on one GPU: the fused Pallas kernel
(ops/pallas/knn_pallas.py) against the XLA form (ops/knn.py), per call at the
three main-path shapes and as the chained ms of the deployed frame program
and of lidar odometry (bench.py's chained breakdown).

    python tools/knn_ab.py

The per-call times are chip_smoke.py's phase b. This runs its pipeline
phase (which leaves a warmed VILFusionPipeline to chain from), then times
the frame program with each kNN path in turns: fused, XLA, fused. Each
switch clears JAX's caches, so every turn recompiles.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    import jax

    import bench
    import chip_smoke as cs

    cs.phase_device()
    from vil_fusion_tpu.ops import knn as knn_xla
    from vil_fusion_tpu.ops.pallas import knn_pallas
    from vil_fusion_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(cs._on_event)
    _, pipe, frames = cs._phase("d pipeline", cs.phase_pipeline)

    fused = knn_pallas.knn
    paths = {"fused": fused,
             "xla": lambda q, d, v, k=5: knn_xla.knn(q, d, v, k=k)}
    turns = []
    for name in ("fused", "xla", "fused"):
        jax.clear_caches()
        knn_pallas.knn = paths[name]
        ms = cs._phase(f"chained {name}", bench._chained_stage_breakdown,
                       pipe, frames, stages=("lidar_odometry",
                                             "full_frame_program"))
        turns.append(dict(knn=name, **ms))
        cs.log(f"chained {name}: {json.dumps(ms)}")
    knn_pallas.knn = fused
    cs.log(f"nvidia-smi: {cs.nvidia_smi()}")
    print(json.dumps({"chained_ms": turns}))


if __name__ == "__main__":
    main()
