"""Multi-window / multi-clip batching and device-mesh sharding.

The reference parallelizes frames with TBB threads inside one window
(SURVEY §2.7); here the scaling axis is the *window* (syncpoint)
batch: all of a clip's sync windows run as one vmapped launch, and
batches shard over a `jax.sharding.Mesh` for multi-chip (SURVEY §5.8:
XLA collectives over the device interconnect — no hand-written comms).
"""
