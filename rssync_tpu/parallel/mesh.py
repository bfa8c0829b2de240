"""Device-mesh sharding of window batches.

Multi-chip scaling (SURVEY §5.8, BASELINE configs[4]): sync windows
are embarrassingly parallel, so the batch axis shards over a 1-D
`jax.sharding.Mesh` and XLA partitions the whole batched program —
per-window compute stays chip-local (no collectives on the hot path;
only the tiny result gather crosses the interconnect).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rssync_tpu.core.problem import SplineTable, TrackWindow

WINDOW_AXIS = "windows"


def make_mesh(devices=None) -> Mesh:
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices, dtype=object).reshape(-1), (WINDOW_AXIS,))


def pad_to_multiple(wins: TrackWindow, multiple: int) -> tuple[TrackWindow, int]:
    """Pad the leading window axis to a multiple of the mesh size
    (padded windows have frame_mask == 0 everywhere -> zero cost,
    immediate convergence)."""
    W = wins.frame_mask.shape[0]
    pad = (-W) % multiple
    if pad == 0:
        return wins, W
    padded = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)), wins
    )
    return padded, W


def shard_windows(wins: TrackWindow, mesh: Mesh) -> TrackWindow:
    """Place the stacked window batch with the leading axis sharded
    over the mesh; the spline table replicates."""
    sh = NamedSharding(mesh, P(WINDOW_AXIS))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), wins)


def replicate_table(table: SplineTable, mesh: Mesh) -> SplineTable:
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), table)


def shard_vector(x: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    return jax.device_put(x, NamedSharding(mesh, P(WINDOW_AXIS)))
