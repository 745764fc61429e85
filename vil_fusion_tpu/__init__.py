"""vil_fusion_tpu — visual-inertial-LiDAR SLAM framework in JAX.

Top-level conveniences; see README.md and PARITY.md for the layout.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# f32 matmuls on the GPU may run in TF32, which keeps about 3 decimal
# digits. The estimator's normal equations, Schur complements and alignment
# solves (Ceres/GTSAM run f64 in the reference) and the expanded-form kNN
# distances (|q|^2 + |d|^2 - 2 q.d) cannot afford that, so every matmul runs
# in full float32. They are all small (<= window*15 ~ 150 dims), so the cost
# is low. Set once here rather than leaking precision= through every einsum;
# image convolutions opt out (ops/image.py). Override with
# VIL_FUSION_MATMUL_PRECISION=(default|float32|highest).
_prec = _os.environ.get("VIL_FUSION_MATMUL_PRECISION", "float32")
if _prec != "default":
    _jax.config.update("jax_default_matmul_precision", _prec)

from vil_fusion_tpu.runtime.config import RigConfig, load_rig  # noqa: F401


def make_pipeline(rig_path: str, mode: str = "vil", **kw):
    """Load a rig YAML and build the full pipeline."""
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline

    return VILFusionPipeline(load_rig(rig_path), mode=mode, **kw)
