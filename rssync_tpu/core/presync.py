"""PreSync: brute-force coarse delay search as one vmapped launch.

JAX rebuild of `pre_sync` / `DebugPreSync`
(ref: src/core/core_private.cpp:61-90, 336-361). The reference runs a
sequential delay loop with a TBB parallel frame loop inside; here the
whole (delay-grid x frames x features x hypotheses) volume is a single
XLA computation: the delay grid is processed in vmapped chunks via
`lax.map` so peak device memory stays bounded (chunk x windows x
frames x features intermediates) while each chunk still fills the
device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rssync_tpu.core.problem import SplineTable, TrackWindow, compute_problem
from rssync_tpu.core.ransac import guess_motion_window
from rssync_tpu.ops.robust import clamp_k

#: RANSAC hypothesis count inside the coarse cost (ref :77).
PRESYNC_RANSAC_ITERS = 20

#: delay-grid points evaluated concurrently per lax.map step (peak
#: device memory ~ chunk x windows x frames x features intermediates).
#: Smaller chunks bound memory and fuse better; smaller than 4 costs
#: much more compile time. The value on the H100 is not measured yet
#: (a sweep is ROADMAP.md S2).
DELAY_CHUNK = 4


def presync_grid(initial_delay: float, radius: float, step: float) -> list:
    """The reference's f64-accumulated PreSync delay grid
    (ref core_private.cpp:69-70: `for (d = rough - radius;
    d < rough + radius; d += step)`). The sequential f64 accumulation
    is parity-critical — floating-point accumulation order decides
    whether the final grid point lands inside or outside the half-open
    bound — so every call site shares THIS function (api.pre_sync,
    pipeline.recipe, parallel.multi, pipeline.guess_orient)."""
    grid = []
    d = float(initial_delay) - float(radius)
    hi = float(initial_delay) + float(radius)
    step = float(step)
    while d < hi:
        grid.append(d)
        d += step
    return grid


def cost_with_motion(P: jnp.ndarray, M: jnp.ndarray, frame_mask: jnp.ndarray) -> jnp.ndarray:
    """Window cost given per-frame translation directions M (F, 3).

    Per frame (ref core_private.cpp:79-85):
        k = clamp(1e2 / |P M|, 10, 1000)
        r = (P M) * k / |M|
        frame cost = sqrt( sum_i sqrt(log1p(r_i^2)) )
    window cost = sum over frames. P is SoA (3, F, N), padded entries 0.
    """
    PM = jnp.einsum("cfn,fc->fn", P, M, precision="highest")
    k = clamp_k(1e2 / jnp.maximum(
        jnp.sqrt(jnp.sum(PM * PM, axis=-1)), 1e-30
    ))  # (F,)
    Mn = jnp.maximum(jnp.sqrt(jnp.sum(M * M, axis=-1)), 1e-30)
    r = PM * (k / Mn)[:, None]
    rho = jnp.log1p(r * r)
    frame_cost = jnp.sqrt(jnp.sum(jnp.sqrt(rho), axis=-1))
    return jnp.sum(frame_cost * frame_mask)


def window_cost(
    table: SplineTable, win: TrackWindow, delay, key: jax.Array,
    bands=None,
) -> jnp.ndarray:
    """Approximate sync cost of one window at one delay
    (ref core_private.cpp:73-86): per-frame 20-hypothesis RANSAC
    motion, then the robust cost above."""
    P = compute_problem(table, win, delay, bands)  # (3, F, N)
    M = guess_motion_window(
        P, win.counts, key, PRESYNC_RANSAC_ITERS
    )  # (F, 3)
    return cost_with_motion(P, M, win.frame_mask)


@partial(jax.jit, static_argnames=("wide",))
def presync_scan(
    table: SplineTable,
    win: TrackWindow,
    delays: jnp.ndarray,
    key: jax.Array,
    wide: bool = False,
) -> jnp.ndarray:
    """Costs for every delay in `delays` — the whole grid in chunked
    vmapped launches (ref's sequential loop at core_private.cpp:69-87).
    Fresh RANSAC draws per (delay, frame), like the reference's
    per-task thread-local RNG, but keyed. Handles any grid length by
    padding to a multiple of DELAY_CHUNK.

    wide=True (callers must ensure the grid spans at most
    +-WIDE_SMAX knots around its center) extracts per-frame wide
    coefficient slabs once instead of per (delay, frame)."""
    from rssync_tpu.core.problem import make_wide_bands

    D = delays.shape[0]
    bands = None
    if wide:
        center = 0.5 * (jnp.min(delays) + jnp.max(delays))
        bands = make_wide_bands(table, win, center)
    pad = (-D) % DELAY_CHUNK
    delays_p = jnp.pad(delays, (0, pad))
    keys = jax.random.split(key, delays_p.shape[0])
    chunks = delays_p.reshape(-1, DELAY_CHUNK)
    kchunks = keys.reshape(-1, DELAY_CHUNK, 2)

    def one_chunk(args):
        ds, ks = args
        return jax.vmap(lambda d, k: window_cost(table, win, d, k, bands))(ds, ks)

    costs = jax.lax.map(one_chunk, (chunks, kchunks)).reshape(-1)
    return costs[:D]


def presync_best(costs: jnp.ndarray, delays: jnp.ndarray):
    """(min cost, argmin delay) — the pair-compare of ref :89."""
    i = jnp.argmin(costs)
    return costs[i], delays[i]
