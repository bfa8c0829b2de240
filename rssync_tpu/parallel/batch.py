"""Batched sync: stack windows, vmap the engine over the window axis.

The reference syncs one window at a time (driver loop,
ref core_testcode.cpp:303-316: per syncpoint PreSync then 4x Sync).
Here every syncpoint of a clip — or of many clips — is one leading
axis of a single XLA program: PreSync becomes a (windows x delays)
launch and Sync a vmapped `lax.while_loop` (lanes that converge first
freeze while the rest continue; XLA runs until all are done).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence  # noqa: F401

import jax
import jax.numpy as jnp

from rssync_tpu.core.presync import PRESYNC_RANSAC_ITERS, cost_with_motion
from rssync_tpu.core.problem import SplineTable, TrackWindow, compute_problem
from rssync_tpu.core.ransac import guess_motion_window_batched
from rssync_tpu.core.sync import SyncResult, sync_window


def stack_windows(windows: Sequence[TrackWindow]) -> TrackWindow:
    """Stack per-window tensors into one batch with a leading W axis,
    padding frames/features to the batch maxima."""
    Fm = max(w.num_frames for w in windows)
    Nm = max(w.num_features for w in windows)
    band = max(w.band for w in windows)  # static: promote to the max

    def pad(win: TrackWindow) -> TrackWindow:
        df = Fm - win.num_frames
        dn = Nm - win.num_features

        def pf(x, dims):
            pads = [(0, 0)] * x.ndim
            for d, amount in dims:
                pads[d] = (0, amount)
            return jnp.pad(x, pads)

        return TrackWindow(
            rays_a=pf(win.rays_a, [(1, df), (2, dn)]),
            rays_b=pf(win.rays_b, [(1, df), (2, dn)]),
            i0_a=pf(win.i0_a, [(0, df), (1, dn)]),
            i0_b=pf(win.i0_b, [(0, df), (1, dn)]),
            f0_a=pf(win.f0_a, [(0, df), (1, dn)]),
            f0_b=pf(win.f0_b, [(0, df), (1, dn)]),
            base_a=pf(win.base_a, [(0, df)]),
            base_b=pf(win.base_b, [(0, df)]),
            feat_mask=pf(win.feat_mask, [(0, df), (1, dn)]),
            frame_mask=pf(win.frame_mask, [(0, df)]),
            counts=pf(win.counts, [(0, df)]),
            band=band,
        )

    padded = [pad(w) for w in windows]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *padded)


@partial(jax.jit, static_argnames=("wide",))
def batched_presync(
    table: SplineTable,
    wins: TrackWindow,
    delays: jnp.ndarray,
    key: jax.Array,
    wide: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """All windows x all delay-grid points.

    wins: stacked TrackWindow with leading W axis. delays: (D,).
    Returns (best_cost (W,), best_delay (W,)).

    The delay grid is processed in DELAY_CHUNK-sized vmapped slices via
    lax.map: full vmap over (W x D) materializes the gather volume
    (D*W*F*N intermediates — tens of GB at the reference operating
    point); a chunk keeps peak device memory bounded while each slice
    still fills the device.
    """
    from rssync_tpu.core.presync import DELAY_CHUNK
    from rssync_tpu.core.problem import make_wide_bands

    W = wins.frame_mask.shape[0]
    D = delays.shape[0]
    center = 0.5 * (jnp.min(delays) + jnp.max(delays))
    bands = None
    if wide:
        bands = jax.vmap(lambda w: make_wide_bands(table, w, center))(wins)
    pad = (-D) % DELAY_CHUNK
    delays_p = jnp.pad(delays, (0, pad), constant_values=jnp.inf)
    Dp = delays_p.shape[0]
    keys = jax.random.split(key, W * Dp).reshape(Dp, W, 2)
    chunks = delays_p.reshape(-1, DELAY_CHUNK)
    kchunks = keys.reshape(-1, DELAY_CHUNK, W, 2)

    def one_chunk(args):
        ds, ks = args  # (K,), (K, W, 2)
        # padded (inf) grid entries evaluate at the grid center (finite,
        # so no inf flows through floor/int32 casts — the same sanitize
        # as parallel/multi.batched_presync_multi) and score inf below.
        ds = jnp.where(jnp.isfinite(ds), ds, center)
        # The chunk is one flattened B = K x W batch for the scoring
        # call (guess_motion_window_batched): one launch over
        # B x F rows. No transposes: the batch axis is leading, so the
        # (3, F, N) blocks stay intact.
        if bands is None:
            P = jax.vmap(lambda d: jax.vmap(
                lambda win: compute_problem(table, win, d)
            )(wins))(ds)
        else:
            P = jax.vmap(lambda d: jax.vmap(
                lambda win, b: compute_problem(table, win, d, b)
            )(wins, bands))(ds)  # (K, W, 3, F, N)
        K = ds.shape[0]
        F, N = P.shape[-2], P.shape[-1]
        Pb = P.reshape(K * W, 3, F, N)
        cb = jnp.broadcast_to(
            wins.counts[None], (K, W, F)).reshape(K * W, F)
        mb = jnp.broadcast_to(
            wins.frame_mask[None], (K, W, F)).reshape(K * W, F)
        M = guess_motion_window_batched(
            Pb, cb, ks.reshape(K * W, 2), PRESYNC_RANSAC_ITERS
        )  # (B, F, 3)
        costs = jax.vmap(cost_with_motion)(Pb, M, mb)
        return costs.reshape(K, W)

    costs = jax.lax.map(one_chunk, (chunks, kchunks)).reshape(Dp, W)
    costs = jnp.where(jnp.isfinite(delays_p)[:, None], costs, jnp.inf)
    i = jnp.argmin(costs, axis=0)  # (W,)
    return jnp.take_along_axis(costs, i[None], axis=0)[0], delays_p[i]


@partial(jax.jit, static_argnames=("wide",))
def batched_sync(
    table: SplineTable,
    wins: TrackWindow,
    initial_delays: jnp.ndarray,
    search_centers: jnp.ndarray,
    search_radius,
    key: jax.Array,
    wide: bool = False,
) -> SyncResult:
    """vmapped fine Sync over the window axis. initial_delays,
    search_centers: (W,). wide: see core/sync.py::sync_window."""
    W = wins.frame_mask.shape[0]
    keys = jax.random.split(key, W)
    radius = jnp.broadcast_to(jnp.asarray(search_radius, initial_delays.dtype), (W,))
    return jax.vmap(
        lambda w, d0, c, r, k: sync_window(table, w, d0, c, r, k, wide=wide)
    )(wins, initial_delays, search_centers, radius, keys)


@partial(jax.jit, static_argnames=("wide", "passes"))
def batched_sync_pipeline(
    table: SplineTable,
    wins_open: TrackWindow,
    wins_closed: TrackWindow,
    delays: jnp.ndarray,
    initial_delay,
    search_radius,
    key: jax.Array,
    wide: bool = False,
    passes: int = 4,
) -> tuple[jnp.ndarray, list[SyncResult]]:
    """The whole per-clip engine in ONE dispatch: batched PreSync over
    the delay grid, then `passes` Sync re-estimations (the driver's
    4x loop, ref core_testcode.cpp:308-314) with search_center =
    initial_delay — each pass re-initializing motion/k at the new
    delay, exactly like separate Sync calls. One launch instead of
    1 + passes.

    Returns (presync_best (W,), [SyncResult per pass])."""
    keys = jax.random.split(key, passes + 1)
    _, best = batched_presync(table, wins_open, delays, keys[0], wide=wide)
    W = wins_open.frame_mask.shape[0]
    centers = jnp.full((W,), initial_delay, best.dtype)
    cur = best
    results = []
    for i in range(passes):
        res = batched_sync(
            table, wins_closed, cur, centers, search_radius, keys[i + 1],
            wide=wide,
        )
        cur = res.delay
        results.append(res)
    return best, results
