"""The end-to-end batch pipeline: JSON recipe in, sync CSV out.

Rebuild of the reference driver `main`
(ref: src/core_testcode.cpp:235-319) with the same recipe schema
(README.md:15-44; times in **milliseconds**), the same outputs — a
`<frame>,<delay_ms>` sync CSV (ref :315) and an always-written 200-point
`debug.csv` loss surface of the first window (ref :285-301, `#if 1`) —
and the same per-syncpoint algorithm: optional PreSync, then 4 Sync
re-estimation passes with search_center = initial_delay and radius =
presync radius or infinity (ref :308-314).

Two execution modes:
  batched=True (default): every syncpoint window is stacked and the
    whole clip syncs as ONE batched PreSync launch + 4 batched Sync
    launches (parallel/batch.py) — the batched replacement for the
    reference's sequential syncpoint loop.
  batched=False: sequential per-syncpoint calls, mirroring the
    reference's control flow exactly (debug / parity runs).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from rssync_tpu.core.api import SyncProblem
from rssync_tpu.frontend.integrate import integrate_gyro
from rssync_tpu.frontend.lens_profiles import load_lens_profile
from rssync_tpu.frontend.telemetry import load_gyro
from rssync_tpu.frontend.tracking import track_frames
from rssync_tpu.parallel.batch import (
    batched_presync,
    batched_sync,
    stack_windows,
)

SYNC_PASSES = 4  # ref core_testcode.cpp:314
DEBUG_PLOT_SIZE = 200  # ref :288


@dataclass
class RecipeResult:
    syncpoints: list[int]
    delays_ms: list[float]
    csv_path: str | None
    debug_csv_path: str | None


def fill_gyro(problem: SyncProblem, gyro_path: str, orient: str | None) -> None:
    """optdata_fill_gyro equivalent (ref: core_testcode.cpp:37-54):
    load telemetry, integrate rates into orientations, feed the
    variable-rate intake (timestamps to integer µs)."""
    data = load_gyro(gyro_path, orient)
    quats = integrate_gyro(data.timestamps, data.gyro)
    ts_us = (data.timestamps * 1_000_000).astype(np.int64)
    problem.set_gyro_quaternions_us(ts_us, quats)


def make_syncpoints(params: dict, frame_start: int, frame_end: int) -> list[int]:
    """Syncpoint schedule (ref: core_testcode.cpp:270-280)."""
    fmt = params.get("syncpoints_format", "auto")
    if fmt == "auto":
        window = int(params["sync_window"])
        dist = int(params["syncpoint_distance"])
        out, pos = [], frame_start
        while pos + window < frame_end:
            out.append(pos)
            pos += dist
        return out
    if fmt == "array":
        return [int(p) for p in params["syncpoints_array"]]
    raise ValueError(f"unknown syncpoints_format {fmt!r}")


def _load_recipe(recipe) -> dict:
    if isinstance(recipe, (str, bytes)):
        with open(recipe) as f:
            return json.load(f)
    if hasattr(recipe, "read"):
        return json.load(recipe)
    return recipe


def _window_pair_ranges(recipe: dict) -> list[tuple[int, int]] | None:
    """Pair ranges the engine will actually read: the union of every
    syncpoint window (plus the debug.csv first window). Decoding only
    these skips inter-window frames — identical outputs (the reference
    decodes everything but equally never reads inter-window pairs,
    core_testcode.cpp:99-122) at a fraction of the decode cost."""
    params = recipe["params"]
    frame_start, frame_end = (int(v) for v in recipe["input"]["frame_range"])
    window = int(params["sync_window"])
    pts = make_syncpoints(params, frame_start, frame_end)
    return [(p, p + window + 1) for p in pts] + [
        (frame_start, frame_start + window + 1)  # debug.csv window
    ]


from rssync_tpu.core.presync import presync_grid as _presync_grid  # noqa: E402


def _start_engine_warm(sp, lens, recipe: dict, progress: bool, warm_gate):
    """Start compiling the engine's batched programs in a background
    thread, overlapping the decode-bound tracking stage.

    The windows' SHAPES are fully determined before any video decodes:
    features/frame from the grid (video probe), frames/window and
    window count from the recipe schedule, spline-table shapes from the
    already-ingested gyro. A dummy problem (sharing the real spline
    table) takes zero-flow tracks for the first window, builds one
    open + one closed window, replicates them to the real window
    count, and runs batched PreSync + Sync + DebugPreSync once —
    populating the in-process jit cache so the real calls after
    tracking skip their XLA compiles (the persistent compilation
    cache, utils/timing.enable_compile_cache, helps only from the
    second process on).

    Best-effort: any exception is reported (progress mode) and
    swallowed — the real calls then just compile inline as before.
    Returns the started Thread (join before the sync stage) or None.
    """
    import threading

    from rssync_tpu.core.api import SyncProblem
    from rssync_tpu.frontend.tracking import (
        VideoSource,
        auto_grid_step,
        grid_points,
        lift_rays,
        rolling_shutter_ts,
    )

    inp = recipe["input"]
    params = recipe["params"]
    frame_start, frame_end = (int(v) for v in inp["frame_range"])
    syncpoints = make_syncpoints(params, frame_start, frame_end)
    if not syncpoints:
        return None
    sync_window = int(params["sync_window"])
    initial_delay = float(inp.get("initial_guess", 0.0)) / 1000.0
    use_presync = bool(inp.get("use_simple_presync", False))
    presync_radius = float(inp.get("simple_presync_radius", 200.0)) / 1000.0
    radius = presync_radius if use_presync else math.inf
    step = float(inp.get("simple_presync_step", 2.0)) / 1000.0
    debug_csv = recipe.get("output", {}).get("debug_csv_path", "debug.csv")

    probe = VideoSource(inp["video_path"])
    width, height, fps = probe.width, probe.height, probe.fps
    probe.cap.release()
    pts = grid_points(
        width, height, inp.get("grid_step") or auto_grid_step(width)
    )
    pts_j = jnp.asarray(pts, jnp.float32)

    def warm():
        try:
            # wait for the tracker-critical compiles: tracking cannot
            # start until its LK + ray-lift executables exist, and
            # these batched engine programs are only needed AFTER
            # tracking, so the tracker's warm goes first. The
            # gate is per-invocation (created by _prepare_problem, set
            # by track_frames' warm thread — or pre-set when the
            # tracking stage runs no device compiles at all). The
            # timeout is a safety net for flows that never track.
            warm_gate.wait(timeout=1800)
            dummy = SyncProblem(seed=0x5EED)
            dummy._table = sp._table
            dummy._sample_rate = sp._sample_rate
            dummy._quats_start = sp._quats_start
            # zero-flow tracks: rays are identical across frames
            # (one device round-trip), only the RS timestamps differ
            ra_j, rb_j = lift_rays(lens, pts_j, pts_j)
            ra = np.asarray(ra_j, np.float64)
            rb = np.asarray(rb_j, np.float64)
            p0 = syncpoints[0]
            for f in range(p0, p0 + sync_window + 1):
                ts_a, ts_b = rolling_shutter_ts(
                    lens, pts, pts, f / fps, (f + 1) / fps, height
                )
                dummy.set_track_result(f, ts_a, ts_b, ra, rb)
            W = len(syncpoints)
            table = dummy.spline_table
            dtype = jnp.float32
            wide = dummy._wide_ok(radius)
            w_open = dummy.build_window(p0, p0 + sync_window, closed=False)
            w_closed = dummy.build_window(p0, p0 + sync_window, closed=True)
            wins_o = stack_windows([w_open] * W)
            wins_c = stack_windows([w_closed] * W)
            if debug_csv:
                dummy.debug_pre_sync(
                    initial_delay, p0, p0 + sync_window,
                    presync_radius, DEBUG_PLOT_SIZE,
                )
            if use_presync:
                grid = _presync_grid(initial_delay, radius, step)
                _, d0 = batched_presync(
                    table, wins_o,
                    jnp.asarray(np.asarray(grid), dtype),
                    dummy.next_key(), wide=wide,
                )
            else:
                d0 = jnp.full((W,), initial_delay, dtype)
            centers = jnp.full((W,), initial_delay, dtype)
            res = batched_sync(
                table, wins_c, d0, centers, radius, dummy.next_key(),
                wide=wide,
            )
            np.asarray(res.delay)  # block until compiled + run
            if progress:
                print("# engine compile warm done", flush=True)
        except Exception as e:  # noqa: BLE001 — warming is best-effort
            if progress:
                print(f"# engine compile warm failed: {e!r}", flush=True)

    t = threading.Thread(target=warm, daemon=True, name="engine-warm")
    t.start()
    return t


def _prepare_problem(
    recipe: dict, method, seed, track_cache_dir, timings, progress,
    decode_scope: str = "windows",
    warm: bool = False,
):
    """Gyro + track intake for one recipe -> (SyncProblem, frame range).

    decode_scope: "windows" (default) decodes/tracks only the pairs
    inside syncpoint windows; "full" decodes the whole frame_range
    (the reference's behavior — same outputs, slower host decode)."""
    import threading

    from rssync_tpu.utils import track_cache

    inp = recipe["input"]
    sp = SyncProblem(seed=seed)
    with timings.stage("gyro_ingest"):
        fill_gyro(sp, inp["gyro_path"], inp.get("gyro_orientation"))
    lens = load_lens_profile(
        inp["lens_profile"]["path"], inp["lens_profile"]["name"]
    )
    frame_start, frame_end = (int(v) for v in inp["frame_range"])
    if decode_scope == "windows":
        from rssync_tpu.frontend.tracking import _merge_pair_ranges

        ranges = _merge_pair_ranges(
            _window_pair_ranges(recipe), frame_start, frame_end
        )
        if ranges == [(frame_start, frame_end)]:
            ranges = None  # windows tile the whole span: same as full
    elif decode_scope == "full":
        ranges = None
    else:
        raise ValueError(f"unknown decode_scope {decode_scope!r}")
    key = track_cache.cache_key(
        inp["video_path"], frame_start, frame_end,
        inp.get("grid_step"), method, tuple(lens.as_array()),
        ranges=ranges,
    ) if track_cache_dir else ""
    warm_gate = threading.Event()
    # when the tracking stage submits no device compiles — host-only
    # DIS flow, or an upcoming track-cache hit — nothing contends for
    # the compile service, so the engine warm starts immediately
    # instead of idling behind the whole tracking stage
    cache_will_hit = bool(track_cache_dir) and os.path.exists(
        os.path.join(track_cache_dir, f"tracks_{key}.npz")
    )
    if method != "lk" or cache_will_hit:
        warm_gate.set()
    warm_thread = (
        _start_engine_warm(sp, lens, recipe, progress, warm_gate)
        if warm else None
    )
    with timings.stage("tracking"):
        track_cache.tracks_cached_or_compute(
            sp, track_cache_dir, key,
            lambda: track_frames(
                sp, lens, inp["video_path"], frame_start, frame_end,
                grid_step=inp.get("grid_step"),
                method=method, progress=progress, ranges=ranges,
                warm_gate=warm_gate,
            ),
        )
    # no-op for the lk path (its warm thread already set the gate);
    # unblocks the engine warm on any path that skipped tracker warm
    warm_gate.set()
    if warm_thread is not None:
        with timings.stage("warm_join"):
            warm_thread.join()
    return sp, frame_start, frame_end


def run_recipe(
    recipe,
    method: str = "lk",
    seed: int = 0,
    batched: bool = True,
    progress: bool = False,
    track_cache_dir: str | None = None,
    timings=None,
    trace: bool = False,
    decode_scope: str = "windows",
) -> RecipeResult:
    """Execute a recipe (path, file object, or dict).

    track_cache_dir: optional directory caching the track stage so
    sync experiments re-run without re-decoding video (SURVEY §5.4).
    timings: optional utils.timing.Timings collecting per-stage
    wall-clock.
    decode_scope: "windows" (default) decodes only syncpoint-window
    pairs; "full" decodes the whole frame_range (reference behavior,
    identical outputs).
    """
    from rssync_tpu.utils.timing import Timings
    from rssync_tpu.utils import track_cache

    timings = timings if timings is not None else Timings()
    recipe = _load_recipe(recipe)
    inp = recipe["input"]
    params = recipe["params"]
    output = recipe.get("output", {})

    sp, frame_start, frame_end = _prepare_problem(
        recipe, method, seed, track_cache_dir, timings, progress,
        decode_scope=decode_scope, warm=batched,
    )
    sync_window = int(params["sync_window"])
    syncpoints = make_syncpoints(params, frame_start, frame_end)

    initial_delay = float(inp.get("initial_guess", 0.0)) / 1000.0
    use_presync = bool(inp.get("use_simple_presync", False))
    presync_radius_ms = float(inp.get("simple_presync_radius", 200.0))
    presync_step_ms = float(inp.get("simple_presync_step", 2.0))

    # debug.csv: loss surface of the first window (ref :285-301)
    debug_csv_path = output.get("debug_csv_path", "debug.csv")
    if debug_csv_path:
        with timings.stage("debug_presync"):
            delays, costs = sp.debug_pre_sync(
                initial_delay, frame_start, frame_start + sync_window,
                presync_radius_ms / 1000.0, DEBUG_PLOT_SIZE,
            )
        with open(debug_csv_path, "w") as f:
            for d, c in zip(delays, costs):
                f.write(f"{d:g},{c:g}\n")

    with timings.stage("sync_all"):
        if not syncpoints:
            # empty schedule (sync_window doesn't fit the frame range):
            # the reference's loop body just never runs and it writes
            # an empty CSV (ref :303-316); match that instead of
            # crashing in stack_windows
            delays_ms = []
        elif batched:
            delays_ms = _run_batched(
                sp, syncpoints, sync_window, initial_delay,
                use_presync, presync_radius_ms, presync_step_ms, progress,
                trace,
            )
        else:
            delays_ms = _run_sequential(
                sp, syncpoints, sync_window, initial_delay,
                use_presync, presync_radius_ms, presync_step_ms, progress,
            )
    if progress:
        print(timings.report(), flush=True)

    csv_path = output.get("csv_path")
    if csv_path:
        # output.gyroflow_offsets (opt-in extension): append a third
        # column with the value to enter in GyroFlow's manual offset
        # field (sign flip + lens.ro/2 frame-center shift — the
        # thesis's manual-verification convention, thesis p.15/p.32).
        gf_ro = None
        if bool(output.get("gyroflow_offsets", False)):
            from rssync_tpu.analysis.metrics import to_gyroflow_offset

            gf_ro = load_lens_profile(
                inp["lens_profile"]["path"], inp["lens_profile"]["name"]
            ).ro
        with open(csv_path, "w") as f:
            for pos, dms in zip(syncpoints, delays_ms):
                if gf_ro is None:
                    f.write(f"{pos},{dms:g}\n")
                else:
                    gf_ms = 1000.0 * to_gyroflow_offset(dms / 1000.0, gf_ro)
                    f.write(f"{pos},{dms:g},{gf_ms:g}\n")

    return RecipeResult(
        syncpoints=syncpoints,
        delays_ms=delays_ms,
        csv_path=csv_path,
        debug_csv_path=debug_csv_path,
    )


def _run_sequential(
    sp, syncpoints, sync_window, initial_delay,
    use_presync, presync_radius_ms, presync_step_ms, progress,
):
    """Reference-exact control flow (ref :303-316)."""
    out = []
    for pos in syncpoints:
        if progress:
            print(pos, flush=True)
        delay = initial_delay
        radius = math.inf
        if use_presync:
            radius = presync_radius_ms / 1000.0
            _, delay = sp.pre_sync(
                delay, pos, pos + sync_window, presync_step_ms / 1000.0, radius
            )
        for _ in range(SYNC_PASSES):
            _, delay = sp.sync(delay, pos, pos + sync_window, initial_delay, radius)
        out.append(1000.0 * delay)
    return out


def _run_batched(
    sp, syncpoints, sync_window, initial_delay,
    use_presync, presync_radius_ms, presync_step_ms, progress,
    trace=False,
):
    """All syncpoints as one stacked batch: 1 PreSync launch + 4 Sync
    launches for the whole clip.

    trace=True prints the reference's per-iteration `delay step` lines
    (ref core_private.cpp:330) for every window after each pass, read
    from the SyncResult trace buffers — the batched-mode equivalent of
    the sequential mode's live stderr stream."""
    table = sp.spline_table
    dtype = jnp.float32
    open_wins = stack_windows(
        [sp.build_window(p, p + sync_window, closed=False) for p in syncpoints]
    )
    closed_wins = stack_windows(
        [sp.build_window(p, p + sync_window, closed=True) for p in syncpoints]
    )
    W = len(syncpoints)
    radius = math.inf
    delays = jnp.full((W,), initial_delay, dtype)
    if use_presync:
        radius = presync_radius_ms / 1000.0
        grid = _presync_grid(
            initial_delay, radius, presync_step_ms / 1000.0
        )
        _, delays = batched_presync(
            table, open_wins, jnp.asarray(np.asarray(grid), dtype),
            sp.next_key(), wide=sp._wide_ok(radius),
        )
    # NOTE: batched_sync_pipeline fuses presync + the 4 passes into one
    # dispatch at nearly three times the compile time; the separate
    # dispatches stay (the async runtime already pipelines them).
    centers = jnp.full((W,), initial_delay, dtype)
    wide = sp._wide_ok(radius)
    results = []
    for i in range(SYNC_PASSES):
        if progress:
            print(f"sync pass {i}", flush=True)
        res = batched_sync(
            table, closed_wins, delays, centers, radius, sp.next_key(),
            wide=wide,
        )
        delays = res.delay
        results.append(res)
    if trace:
        import sys

        for i, res in enumerate(results):
            iters = np.asarray(res.iterations)
            tr_d = np.asarray(res.trace_delay, np.float64)
            tr_s = np.asarray(res.trace_step, np.float64)
            for w, pos in enumerate(syncpoints):
                print(f"# pass {i} window {pos} ({iters[w]} iters)",
                      file=sys.stderr)
                for it in range(int(iters[w])):
                    print(f"{tr_d[w, it]:g} {abs(tr_s[w, it]):g}",
                          file=sys.stderr)
    return [1000.0 * float(d) for d in np.asarray(delays, np.float64)]


def run_multi_recipes(
    recipes,
    method: str = "lk",
    seed: int = 0,
    progress: bool = False,
    track_cache_dir: str | None = None,
    decode_scope: str = "windows",
) -> list[RecipeResult]:
    """Sync N clips as ONE batched engine run (BASELINE configs[4]).

    Every recipe's gyro + tracks load into its own SyncProblem; all
    clips' syncpoint windows then stack into a single window axis with
    per-window spline tables (parallel/multi.py::sync_clips): one
    PreSync launch + 4 Sync launches for the whole fleet. Shard the
    window axis over a Mesh for multi-chip (parallel/mesh.py).

    Each recipe keeps its OWN sync_window, initial_guess, and
    simple-presync radius/step (per-window delay grids and wide-band
    centers in the engine — heterogeneous fleets are fine). The one
    constraint (asserted): use_simple_presync must be on for every
    recipe — the batched multi path needs a bounded delay swing for
    its padded spline-table stacking.
    """
    from rssync_tpu.parallel.multi import sync_clips
    from rssync_tpu.utils.timing import Timings

    timings = Timings()
    loaded = [_load_recipe(r) for r in recipes]

    def param(d, *path, default=None):
        for p in path[:-1]:
            d = d.get(p, {})
        return d.get(path[-1], default)

    for r in loaded:
        if not bool(param(r, "input", "use_simple_presync", default=False)):
            raise ValueError("multi-clip mode requires use_simple_presync")
    windows = [int(r["params"]["sync_window"]) for r in loaded]
    inits_ms = [
        float(param(r, "input", "initial_guess", default=0.0))
        for r in loaded
    ]
    radii_ms = [
        float(param(r, "input", "simple_presync_radius", default=200.0))
        for r in loaded
    ]
    steps_ms = [
        float(param(r, "input", "simple_presync_step", default=2.0))
        for r in loaded
    ]

    problems, syncpoint_lists = [], []
    for i, r in enumerate(loaded):
        sp, fs, fe = _prepare_problem(
            r, method, seed + i, track_cache_dir, timings, progress,
            decode_scope=decode_scope,
        )
        problems.append(sp)
        syncpoint_lists.append(make_syncpoints(r["params"], fs, fe))

    with timings.stage("sync_all_clips"):
        delay_lists = sync_clips(
            problems, syncpoint_lists, windows,
            [v / 1000.0 for v in inits_ms],
            [v / 1000.0 for v in steps_ms],
            [v / 1000.0 for v in radii_ms],
            problems[0].next_key(),
            sync_passes=SYNC_PASSES,
        )
    if progress:
        print(timings.report(), flush=True)

    results = []
    for r, pts, ds in zip(loaded, syncpoint_lists, delay_lists):
        delays_ms = [1000.0 * d for d in ds]
        csv_path = r.get("output", {}).get("csv_path")
        if csv_path:
            with open(csv_path, "w") as f:
                for pos, dms in zip(pts, delays_ms):
                    f.write(f"{pos},{dms:g}\n")
        results.append(RecipeResult(
            syncpoints=pts, delays_ms=delays_ms,
            csv_path=csv_path, debug_csv_path=None,
        ))
    return results
