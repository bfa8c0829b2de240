"""The sync engine: JAX rebuild of the reference's `rssync_core`
(ref: src/core/). All hot paths are batched JAX functions over padded
fixed-shape window tensors; `api.SyncProblem` preserves ISyncProblem
semantics (ref: src/core/public/rssync.h:9-31).
"""
