"""Multi-clip batching: windows from SEVERAL clips (each with its own
gyro spline) sync as one batched launch.

BASELINE configs[4] ("N videos x M syncpoints" over several chips): the
window axis already scales across a Mesh (parallel/mesh.py); this
module adds the per-window spline-table axis so the batch can mix
clips. Tables are padded to a common knot count with edge-replicated
columns (the same boundary semantics as the engine's clamped gather;
windows are interior so the shifted far-extrapolation point is
unobservable).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from rssync_tpu.core.problem import SplineTable, TrackWindow
from rssync_tpu.core.sync import SyncResult, sync_window
from rssync_tpu.core.presync import window_cost
from rssync_tpu.parallel.batch import stack_windows


def stack_tables(tables: Sequence[SplineTable]) -> SplineTable:
    """Stack per-window spline tables on a leading axis, padding the
    knot axis to the batch maximum with edge-replicated columns."""
    n_max = max(int(t.coeffs.shape[-1]) for t in tables)

    def pad(t: SplineTable) -> SplineTable:
        d = n_max - int(t.coeffs.shape[-1])
        if d == 0:
            return t

        def edge_pad(c):
            return jnp.concatenate(
                [c, jnp.repeat(c[:, -1:], d, axis=1)], axis=1
            )

        return SplineTable(
            coeffs=edge_pad(t.coeffs),
            coeffs_padded=edge_pad(t.coeffs_padded),
            sample_rate=t.sample_rate,
        )

    padded = [pad(t) for t in tables]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *padded)


def _check_interior(
    table: SplineTable, win: TrackWindow, delay_margin_s: float, who: str
) -> None:
    """Enforce the interior-window assumption for a table that will be
    padded: every valid feature's spline index, swung by
    ±delay_margin_s, must stay inside THIS clip's own knot range.
    Edge-padding a shorter table replaces its quadratic extrapolation
    with a per-knot sawtooth, so evaluation past the true last knot
    must be rejected rather than silently wrong."""
    m = np.asarray(win.feat_mask) > 0
    if not m.any():
        return
    i0 = np.concatenate(
        [np.asarray(win.i0_a)[m], np.asarray(win.i0_b)[m]]
    )
    sr = float(np.asarray(table.sample_rate))
    margin = int(np.ceil(abs(delay_margin_s) * sr)) + 1
    n = int(table.coeffs.shape[-1])
    lo = int(i0.min()) - margin
    hi = int(i0.max()) + margin
    if lo < 0 or hi >= n - 1:
        raise ValueError(
            f"{who}: window spline band [{lo}, {hi}] (with "
            f"{delay_margin_s:+.3f}s delay margin) leaves the clip's own "
            f"knot interior [0, {n - 2}]; edge-padded tables are only "
            "valid for interior windows"
        )


def stack_problems(
    tables: Sequence[SplineTable],
    windows: Sequence[TrackWindow],
    delay_margin_s: float = 0.0,
) -> tuple[SplineTable, TrackWindow]:
    """Stack (table, window) pairs — one table per window; repeat a
    clip's table for each of its windows. Windows whose tables get
    padded must stay interior to their own clip's knot range over the
    ±delay_margin_s search swing (checked, see _check_interior)."""
    if len(tables) != len(windows):
        raise ValueError("one table per window required")
    n_max = max(int(t.coeffs.shape[-1]) for t in tables)
    for i, (t, w) in enumerate(zip(tables, windows)):
        if int(t.coeffs.shape[-1]) < n_max:
            _check_interior(t, w, delay_margin_s, f"stack_problems[{i}]")
    return stack_tables(tables), stack_windows(windows)


@partial(jax.jit, static_argnames=("wide",))
def batched_presync_multi(
    tables: SplineTable,
    wins: TrackWindow,
    delays: jnp.ndarray,
    key: jax.Array,
    wide: bool = False,
    centers: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-window-table variant of parallel.batch.batched_presync:
    (best_cost (W,), best_delay (W,)).

    delays: a shared (D,) grid, or a PER-WINDOW (W, D) grid padded
    with inf (heterogeneous recipes: each clip keeps its own
    initial_guess/radius/step — BASELINE configs[4] without the
    round-2 homogeneity restriction). Padded (inf) entries evaluate at
    the window's center (finite, so no NaNs propagate) and score inf.
    centers: (W,) wide-band/sanitize centers; defaults to each
    window's own finite-grid midpoint.
    """
    from rssync_tpu.core.presync import DELAY_CHUNK
    from rssync_tpu.core.problem import make_wide_bands

    W = wins.frame_mask.shape[0]
    if delays.ndim == 1:
        delays = jnp.broadcast_to(delays[None], (W, delays.shape[0]))
    D = delays.shape[1]
    finite = jnp.isfinite(delays)
    if centers is None:
        centers = (
            jnp.min(jnp.where(finite, delays, jnp.inf), axis=1)
            + jnp.max(jnp.where(finite, delays, -jnp.inf), axis=1)
        ) * 0.5  # (W,)
    bands = None
    if wide:
        bands = jax.vmap(make_wide_bands)(tables, wins, centers)
    pad = (-D) % DELAY_CHUNK
    delays_p = jnp.pad(
        delays, ((0, 0), (0, pad)), constant_values=jnp.inf
    )  # (W, Dp)
    Dp = delays_p.shape[1]
    keys = jax.random.split(key, W * Dp).reshape(Dp, W, 2)
    chunks = delays_p.T.reshape(-1, DELAY_CHUNK, W)
    kchunks = keys.reshape(-1, DELAY_CHUNK, W, 2)

    def one_chunk(args):
        ds, ks = args  # (K, W), (K, W, 2)
        ds_eval = jnp.where(jnp.isfinite(ds), ds, centers[None])
        if bands is None:
            per = lambda d_w, kk: jax.vmap(
                lambda t, w, d, k: window_cost(t, w, d, k)
            )(tables, wins, d_w, kk)
        else:
            per = lambda d_w, kk: jax.vmap(
                lambda t, w, d, k, b: window_cost(t, w, d, k, b)
            )(tables, wins, d_w, kk, bands)
        return jax.vmap(per)(ds_eval, ks)

    costs = jax.lax.map(one_chunk, (chunks, kchunks)).reshape(Dp, W)
    costs = jnp.where(jnp.isfinite(delays_p.T), costs, jnp.inf)
    i = jnp.argmin(costs, axis=0)  # (W,)
    return (
        jnp.take_along_axis(costs, i[None], axis=0)[0],
        jnp.take_along_axis(delays_p, i[:, None], axis=1)[:, 0],
    )


@partial(jax.jit, static_argnames=("wide",))
def batched_sync_multi(
    tables: SplineTable,
    wins: TrackWindow,
    initial_delays: jnp.ndarray,
    search_centers: jnp.ndarray,
    search_radius,
    key: jax.Array,
    wide: bool = False,
) -> SyncResult:
    """Per-window-table variant of parallel.batch.batched_sync."""
    W = wins.frame_mask.shape[0]
    keys = jax.random.split(key, W)
    radius = jnp.broadcast_to(
        jnp.asarray(search_radius, initial_delays.dtype), (W,)
    )
    return jax.vmap(
        lambda t, w, d0, c, r, k: sync_window(t, w, d0, c, r, k, wide=wide)
    )(tables, wins, initial_delays, search_centers, radius, keys)


def _per_clip(value, n: int) -> list:
    """Broadcast a scalar setting to n clips; pass sequences through."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"expected {n} per-clip values, got {len(value)}")
        return list(value)
    return [value] * n


def sync_clips(
    problems,
    syncpoint_lists: Sequence[Sequence[int]],
    sync_window_frames,
    initial_delay,
    presync_step,
    presync_radius,
    key: jax.Array,
    sync_passes: int = 4,
) -> list[list[float]]:
    """High-level multi-clip driver: N SyncProblems (one per clip,
    tracks + gyro already set) x their syncpoint lists -> per-clip
    delay lists (seconds). All windows of all clips run as ONE batched
    PreSync launch + `sync_passes` batched Sync launches; shard the
    window axis over a Mesh (parallel/mesh.py) for multi-chip.

    sync_window_frames / initial_delay / presync_step / presync_radius
    may each be a scalar (shared) or a per-clip sequence — clips keep
    their own settings via per-window delay grids, wide-band centers,
    and search radii (BASELINE configs[4] heterogeneous fleets).
    """
    n = len(problems)
    wsizes = _per_clip(sync_window_frames, n)
    inits = _per_clip(initial_delay, n)
    steps = _per_clip(presync_step, n)
    radii = _per_clip(presync_radius, n)

    tables, wins_open, wins_closed, owners = [], [], [], []
    for ci, (sp, pts) in enumerate(zip(problems, syncpoint_lists)):
        for pos in pts:
            tables.append(sp.spline_table)
            wins_open.append(
                sp.build_window(pos, pos + wsizes[ci], closed=False)
            )
            wins_closed.append(
                sp.build_window(pos, pos + wsizes[ci], closed=True)
            )
            owners.append(ci)

    if not owners:
        # every clip's schedule is empty (sync_window doesn't fit):
        # nothing to stack or launch — per-clip empty results
        return [[] for _ in problems]

    margin = max(
        abs(i0) + r for i0, r in zip(inits, radii)
    )
    t_stack, w_open = stack_problems(tables, wins_open, margin)
    _, w_closed = stack_problems(tables, wins_closed, margin)

    from rssync_tpu.core.presync import presync_grid

    grids = [
        presync_grid(inits[ci], radii[ci], steps[ci]) for ci in range(n)
    ]
    Dmax = max(len(g) for g in grids)
    delays_np = np.full((len(owners), Dmax), np.inf, np.float32)
    for wi, ci in enumerate(owners):
        delays_np[wi, : len(grids[ci])] = grids[ci]
    delays = jnp.asarray(delays_np)
    centers = jnp.asarray([inits[ci] for ci in owners], jnp.float32)
    radius_w = jnp.asarray([radii[ci] for ci in owners], jnp.float32)

    wide = all(
        sp._wide_ok(r) for sp, r in zip(problems, radii)
    )
    key, k1 = jax.random.split(key)
    _, best = batched_presync_multi(
        t_stack, w_open, delays, k1, wide=wide, centers=centers
    )
    cur = best
    for _ in range(sync_passes):
        key, k = jax.random.split(key)
        res = batched_sync_multi(
            t_stack, w_closed, cur, centers, radius_w, k, wide=wide
        )
        cur = res.delay

    out: list[list[float]] = [[] for _ in problems]
    for delay, ci in zip(np.asarray(cur, np.float64), owners):
        out[ci].append(float(delay))
    return out
