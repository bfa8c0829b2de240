"""rssync_tpu — gyro-to-video clock synchronization on an NVIDIA GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of VladimirP1/rs-sync
(the reference): recover the slowly drifting clock delay
between a rolling-shutter camera video and its gyroscope log with
sub-millisecond accuracy, so stabilization software can warp frames using the
gyro orientation history.

Layering (mirrors reference SURVEY.md §1):

  ops/       pure math kernels: quaternions, natural cubic splines, fisheye
             lens model, robust-loss helpers        (ref: src/core_support/)
  core/      the sync engine: epipolar problem builder, RANSAC translation
             guesser, PreSync delay grid, Sync alternating optimizer, and the
             `SyncProblem` API preserving ISyncProblem semantics
                                                    (ref: src/core/)
  frontend/  telemetry ingest (GPMF), gyro integration, feature tracking,
             lens profiles                          (ref: rust/, src/core_testcode.cpp)
  pipeline/  JSON-recipe driver, CSV outputs        (ref: src/core_testcode.cpp)
  parallel/  multi-window / multi-clip batching over a jax.sharding.Mesh
  analysis/  sync-quality metrics (RMSE vs linear delay model)
                                                    (ref: python/plot_sync.py)

Everything on the hot path is batched, fixed-shape, functionally pure JAX:
frames, delay-grid points, RANSAC hypotheses and sync windows are all vmapped
axes of single XLA launches rather than the reference's TBB thread loops.
"""

from rssync_tpu.core.api import SyncProblem, create_sync_problem

__all__ = ["SyncProblem", "create_sync_problem"]
__version__ = "0.1.0"
