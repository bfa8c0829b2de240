"""Headline benchmark: track + PreSync + Sync of a 60 s GoPro-shaped
clip on one NVIDIA GPU.

Workload (reference operating point, README.md / BASELINE.md):
  - 60 s @ 60 fps -> 3600 tracked frame pairs at 2704x2028
  - 130-feature grid (step 200), pyramidal LK on device (per-frame
    pyramids shared across pairs, 16-pair blocks)
  - 30 syncpoints: 60-frame windows every 120 frames
  - PreSync +-200 ms at 2 ms step (200-delay grid), then 4 Sync passes
  - engine rays from the vectorized synthetic generator (no video
    decode in the measurement: the metric is device compute; frames
    are device-generated noise — LK cost is data-independent)

Every stage time is host wall-clock around work that ends in
`block_until_ready`, best of 3 repetitions after a warm-up. The run
fails without a GPU backend; it prints the device and the card's name
and power limit beside the numbers.

Prints ONE json line: {"metric", "value" (seconds), "unit", "device",
"card", "extras"}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip() or "unknown card"

    import jax
    import jax.numpy as jnp

    from rssync_tpu.utils.timing import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"# bench: backend is {jax.default_backend()!r}, not a GPU",
              file=sys.stderr)
        return 1

    from rssync_tpu.frontend.tracking import grid_points
    from rssync_tpu.parallel.batch import (
        batched_presync,
        batched_sync,
        stack_windows,
    )
    from rssync_tpu.testing.engine_problem import make_engine_problem

    fetch = jax.block_until_ready
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"# device: {device}; card: {card}", file=sys.stderr)

    # ---- tracking stage -------------------------------------------------
    # frames enter pre-padded to the level-0 storage dims, as the real
    # pipeline ships them (pad_frames_host under the decode-ahead
    # overlap): the pad never runs on device
    from rssync_tpu.frontend.tracking import (
        _fine_plan,
        _stored_dims,
        auto_levels,
        lk_track_video_chunked,
    )
    from rssync_tpu.frontend.tracking import LK_ITERS, LK_RADIUS

    H, W = 2028, 2704
    lv = auto_levels(H, W)
    fine0 = 0 in {l for l, *_ in _fine_plan(lv, LK_ITERS, LK_RADIUS)}
    Hp, Wp = _stored_dims(H, W, "fine" if fine0 else "lane")
    n_pairs_total = 3599
    seg = 240  # pairs per dispatch (seg+1 frames resident, ~1.4 GB u8)
    key = jax.random.PRNGKey(0)
    pts = jnp.asarray(grid_points(W, H, 200), jnp.float32)
    print(f"# features/frame: {pts.shape[0]}", file=sys.stderr)

    frames = fetch(jax.random.randint(key, (seg + 1, Hp, Wp), 0, 255,
                                      jnp.uint8))
    t0 = time.time()
    fetch(lk_track_video_chunked(
        frames, chunk=16, grid_step=200, logical_hw=(H, W)))
    print(f"# lk compile+warmup: {time.time() - t0:.1f}s", file=sys.stderr)

    n_disp = (n_pairs_total + seg - 1) // seg  # 15 dispatches / clip
    track_best = np.inf
    for _ in range(3):
        t0 = time.time()
        outs = [
            lk_track_video_chunked(
                frames, chunk=16, grid_step=200, logical_hw=(H, W))
            for _ in range(n_disp)
        ]
        fetch(outs)
        track_best = min(track_best, time.time() - t0)
    track_time = track_best
    print(
        f"# tracking: {track_best:.3f}s per 60s clip "
        f"({1e3 * track_best / (n_disp * seg):.4f} ms/pair) [{card}]",
        file=sys.stderr,
    )

    # ---- on-video accuracy (same tracker code path as the timing) -------
    # 48 affine-warped textured 2.7k pairs with analytic ground-truth
    # flow (testing/texture_scene.py; host render cached on disk).
    from rssync_tpu.frontend.tracking import pad_frames_host
    from rssync_tpu.testing.texture_scene import render_scene, tracking_error

    t0 = time.time()
    tex_frames, affines = render_scene(
        seed=5, n_frames=49, height=H, width=W)
    print(f"# texture scene (host, cached): {time.time() - t0:.1f}s",
          file=sys.stderr)
    tracked = np.asarray(lk_track_video_chunked(
        jnp.asarray(pad_frames_host(np.asarray(tex_frames))),
        chunk=16, grid_step=200, logical_hw=(H, W)))
    pts_np = np.asarray(grid_points(W, H, 200), np.float64)
    track_med_px, track_p95_px = tracking_error(
        tracked, pts_np, affines, W, H)
    print(
        f"# on-video tracking error: med {track_med_px:.3f} px, "
        f"p95 {track_p95_px:.3f} px (48 textured pairs)",
        file=sys.stderr,
    )

    # ---- engine stage ---------------------------------------------------
    t0 = time.time()
    prob = make_engine_problem(
        seed=0, duration=60.0, fps=60.0, n_features=130, sync_window=60,
        syncpoint_distance=120, true_delay=0.0423,
    )
    wins = stack_windows(prob.windows)
    print(
        f"# problem build (host): {time.time() - t0:.1f}s, "
        f"{len(prob.syncpoints)} windows",
        file=sys.stderr,
    )

    delays = jnp.asarray(np.arange(-0.2, 0.2, 0.002) + 0.0, jnp.float32)
    radius = 0.2

    t0 = time.time()
    c, d = batched_presync(
        prob.table, wins, delays, jax.random.PRNGKey(1), wide=True
    )
    fetch(d)
    print(f"# presync compile+run: {time.time() - t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    r = batched_sync(
        prob.table, wins, d, d, radius, jax.random.PRNGKey(2), wide=True
    )
    fetch(r.delay)
    print(f"# sync compile+run: {time.time() - t0:.1f}s", file=sys.stderr)

    presync_best = np.inf
    sync_best = np.inf
    final = None
    for rep in range(3):
        t0 = time.time()
        _, best = batched_presync(
            prob.table, wins, delays, jax.random.PRNGKey(10 + rep), wide=True
        )
        fetch(best)
        presync_best = min(presync_best, time.time() - t0)
        t0 = time.time()
        cur = best
        for i in range(4):
            res = batched_sync(
                prob.table, wins, cur, best, radius,
                jax.random.PRNGKey(20 + 4 * rep + i), wide=True,
            )
            cur = res.delay
        fetch(cur)
        sync_best = min(sync_best, time.time() - t0)
        final = cur

    err_ms = np.abs(np.asarray(final, np.float64) - prob.true_delay).max() * 1e3
    print(
        f"# presync: {presync_best:.3f}s  sync(4x): {sync_best:.3f}s  "
        f"max offset err: {err_ms:.4f} ms [{card}]",
        file=sys.stderr,
    )
    if err_ms > 0.5:
        print("# WARNING: accuracy above 0.5 ms target", file=sys.stderr)

    total = track_time + presync_best + sync_best
    print(
        json.dumps(
            {
                "metric": "60s GoPro-shaped clip: track+presync+sync "
                          "wall-clock, 1 GPU",
                "value": round(total, 4),
                "unit": "s",
                "device": device,
                "card": card,
                "extras": {
                    "track_s": round(track_time, 4),
                    "presync_s": round(presync_best, 4),
                    "sync4x_s": round(sync_best, 4),
                    "offset_err_ms": round(float(err_ms), 4),
                    "onvideo_track_med_px": round(track_med_px, 3),
                    "onvideo_track_p95_px": round(track_p95_px, 3),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
