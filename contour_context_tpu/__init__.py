"""contour_context_tpu: a JAX/XLA rebuild, for accelerators, of the capabilities of
"Contour Context: Abstract Structural Distribution for 3D LiDAR Loop Detection and
Metric Pose Estimation" (ICRA 2023, reference implementation: lewisjiang/contour-context).

This is NOT a port. The reference is a single-threaded C++14 pipeline built on
OpenCV/Eigen/Ceres/nanoflann; this package re-designs every component as
batched fixed-shape device code:

- BEV rasterization        -> scatter-max + argmax-payload gather
- contour extraction       -> multi-level label-propagation connected components +
                              segment-sum moments, fixed-shape contour tables
- retrieval keys           -> ring histogram as a dense masked Gaussian contraction
- BCI constellation        -> batched 256-bit boolean ops + batched circular
                              window consensus                  (ops/descriptor.py,
                              ops/cascade.py)
- kd-tree retrieval        -> masked brute-force batched L2 top-k over an
                              HBM-resident key matrix, optionally row-sharded over
                              a device mesh                     (db.py, parallel.py)
- CandidateManager         -> on-device batched cascade + sequential proposal merge,
                              the whole query as ONE XLA dispatch (ops/candidate.py)
- Ceres GMM-L2 refinement  -> batched fixed-iteration Levenberg-Marquardt with
                              analytic jax autodiff             (ops/gmm.py)

Host Python does only file IO, orchestration and evaluation bookkeeping; the
file loader has a native C++ implementation (csrc/loader.cpp).
"""

from contour_context_tpu.config import (
    ContourManagerConfig,
    ContourSimThresConfig,
    ContourDBConfig,
    TreeBucketConfig,
    GMMOptConfig,
    CandidateScoreEnsemble,
    ScoreConstellSim,
    ScorePairwiseSim,
    ScorePostProc,
    PipelineConfig,
    load_pipeline_config_yaml,
    mulran_pipeline_config,
)

__version__ = "0.1.0"


def __getattr__(name):  # lazy: keep `import contour_context_tpu` jax-free
    if name in ("ContourDB", "QueryHandle", "drain_handles"):
        from contour_context_tpu import db
        return getattr(db, name)
    if name in ("LoopClosurePipeline", "run_batch"):
        from contour_context_tpu import pipeline
        return getattr(pipeline, name)
    if name in ("OnlineSpinner", "LoopDetection"):
        from contour_context_tpu import online
        return getattr(online, name)
    if name == "ScanDesc":
        from contour_context_tpu.types import ScanDesc
        return ScanDesc
    raise AttributeError(name)
