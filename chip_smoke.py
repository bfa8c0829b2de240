#!/usr/bin/env python3
"""Smoke test of rssync_tpu on one NVIDIA GPU: the quickest proof that
the system still starts, compiles and gives the right answers there.

Run from the repository root on a machine with the card:

    python chip_smoke.py                # phases a-d on one card
    python chip_smoke.py --four-cards   # the sharded multi-clip fleet

Phases (one process owns the card; any failure exits non-zero):

a. device: the JAX backend must be "gpu"; prints platform, device
   kind, device count, and the card's name and power limit.
b. kernel parity: the Triton scoring kernel vs the XLA bisection at
   PreSync and Sync widths, the tracker's strip fetch vs its legacy
   gather at 2704x2028, all compiled (testing/gpu_parity.py); prints
   `memory_analysis()` of the tracking and PreSync executables.
c. golden parity: tests/test_golden.py in-process on the card, against
   the reference engine's own outputs in tests/golden/golden.npz.
d. main path: a seeded 2704x2028 60 fps clip with a known delay is
   rendered, written as mp4v, and run twice through the CLI
   (`rssync_tpu.pipeline.__main__.main`): decode, LK tracking, PreSync
   over +-200 ms in 2 ms steps, 4 Sync passes, CSV. Max offset error
   must be <= 0.5 ms.

`--four-cards` runs only the multi-clip fleet (4 clips x 8 windows at
the engine's full width) sharded over a 1-D mesh of 4 cards, and the
same fleet on one card; per-window delays must agree within 1 us.

`--rehearse` is a dress rehearsal on the CPU at tiny sizes with the
kernels interpreted (`JAX_PLATFORMS=cpu python chip_smoke.py
--rehearse`); it proves control flow only.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
#: scratch space for the rendered clip and outputs (listed in .gitignore)
WORK = os.path.join(REPO, ".smoke_work")

#: the reference rig (ROADMAP.md): 2704x2028 @ 60 fps, 11.11 ms
#: rolling-shutter readout, 200 Hz gyro, 130-feature grid, 60-frame
#: windows every 120 frames, PreSync +-200 ms @ 2 ms, 4 Sync passes
RIG = dict(width=2704, height=2028, fps=60.0, readout=0.01111,
           gyro_rate=200.0, n_frames=1000, sync_window=60,
           syncpoint_distance=120, radius_ms=200.0, step_ms=2.0)
TINY = dict(width=640, height=480, fps=30.0, readout=0.01111,
            gyro_rate=200.0, n_frames=40, sync_window=12,
            syncpoint_distance=8, radius_ms=80.0, step_ms=2.0)
MAX_OFFSET_ERR_MS = 0.5
FLEET_AGREE_S = 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def nvidia_smi(*query: str) -> str:
    """One nvidia-smi query, from a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", *query], capture_output=True, text=True,
        timeout=60, check=True,
    )
    return out.stdout.strip()


def card_line(rehearse: bool) -> str:
    try:
        return nvidia_smi("--query-gpu=name,power.limit",
                          "--format=csv,noheader")
    except (OSError, subprocess.SubprocessError) as exc:
        if rehearse:
            return "no card (rehearsal)"
        fail(f"nvidia-smi failed: {exc!r}")


class ComputeAppsSampler:
    """Samples the processes that hold the card while a phase runs:
    the DecodePool's spawn workers must never open it."""

    def __init__(self, enabled: bool, period: float = 2.0):
        self.enabled = enabled
        self.period = period
        self.pids: set[str] = set()
        self.most = 0  # most processes listed in one sample
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                out = nvidia_smi("--query-compute-apps=pid,used_memory",
                                 "--format=csv,noheader")
                rows = [ln for ln in out.splitlines() if ln.strip()]
                self.pids |= {ln.split(",")[0].strip() for ln in rows}
                self.most = max(self.most, len(rows))
                self.samples += 1
            except (OSError, subprocess.SubprocessError):
                pass
            self._stop.wait(self.period)

    def __enter__(self):
        if self.enabled:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self.enabled:
            self._thread.join()


def phase_device(rehearse: bool, card: str) -> dict:
    import jax

    backend = jax.default_backend()
    if backend != "gpu" and not rehearse:
        fail(f"JAX backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    print(f"[a] device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}")
    print(f"[a] card: {card}", flush=True)
    return info


def phase_kernel_parity(rehearse: bool, tag: str) -> None:
    import jax
    import jax.numpy as jnp

    from rssync_tpu.frontend import tracking as T
    from rssync_tpu.parallel.batch import batched_presync, stack_windows
    from rssync_tpu.testing.engine_problem import make_engine_problem
    from rssync_tpu.testing.gpu_parity import run_parity

    t0 = time.perf_counter()
    res = run_parity(interpret=rehearse)
    for name, r in res.items():
        print(f"[b] {name} {r['err']:.3g} (tol {r['tol']:.3g}) "
              + ("ok" if r["ok"] else "FAIL"))
    print(f"[b] parity wall (compile included) "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    bad = [n for n, r in res.items() if not r["ok"]]
    if bad:
        fail(f"kernel parity: {bad}")

    rig = TINY if rehearse else RIG
    H, W = rig["height"], rig["width"]
    levels = T.auto_levels(H, W)
    fine0 = 0 in {l for l, *_ in T._fine_plan(levels, T.LK_ITERS,
                                               T.LK_RADIUS)}
    Hp, Wp = T._stored_dims(H, W, "fine" if fine0 else "lane")
    frames = jax.ShapeDtypeStruct((T.TRACK_BLOCK + 1, Hp, Wp), jnp.uint8)
    pts = T._static_pts(T.grid_points(W, H))
    track_exe = T._lk_track_video_jit.lower(
        frames, pts, levels, T.LK_RADIUS, T.LK_ITERS, (H, W)).compile()
    print(f"[b] tracking executable ({T.TRACK_BLOCK} pairs at {W}x{H}) "
          f"memory_analysis: {track_exe.memory_analysis()}")

    prob = make_engine_problem(
        seed=0, duration=12.0 if rehearse else 60.0, fps=rig["fps"],
        n_features=24 if rehearse else 130,
        sync_window=rig["sync_window"],
        syncpoint_distance=rig["syncpoint_distance"])
    wins = stack_windows(prob.windows)
    r, s = rig["radius_ms"] / 1e3, rig["step_ms"] / 1e3
    delays = jnp.arange(-r, r, s, dtype=jnp.float32)
    presync_exe = batched_presync.lower(
        prob.table, wins, delays, jax.random.PRNGKey(0), wide=True
    ).compile()
    print(f"[b] PreSync executable ({len(prob.windows)} windows x "
          f"{delays.shape[0]} delays) memory_analysis: "
          f"{presync_exe.memory_analysis()}", flush=True)


def phase_golden() -> None:
    import jax
    import pytest

    os.environ["RSSYNC_GPU_TESTS"] = "1"  # conftest: keep this backend
    prec = jax.config.jax_default_matmul_precision
    print("[c] matmul precision: HIGHEST on every f32 engine contraction "
          f"(explicit); process default {prec!r}", flush=True)
    t0 = time.perf_counter()
    rc = pytest.main([
        os.path.join(REPO, "tests", "test_golden.py"), "-q",
        "-p", "no:cacheprovider", "-p", "no:randomly",
        "--rootdir", REPO,
    ])
    print(f"[c] golden parity exit {int(rc)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        fail(f"golden parity (pytest exit {int(rc)})")


def _render_clip(rig: dict, seed: int):
    from rssync_tpu.testing.synthvideo import make_clip

    clip_dir = os.path.join(WORK, "clip")
    t0 = time.perf_counter()
    clip = make_clip(
        clip_dir, seed=seed, true_delay=0.0185, fps=rig["fps"],
        n_frames=rig["n_frames"], width=rig["width"],
        height=rig["height"], gyro_rate=rig["gyro_rate"],
        readout=rig["readout"], pad=1.0,
    )
    print(f"[d] rendered {clip.n_frames} frames {clip.width}x"
          f"{clip.height} in {time.perf_counter() - t0:.1f} s; true "
          f"delay {clip.true_delay * 1e3:.4f} ms", flush=True)
    recipe = {
        "input": {
            "video_path": clip.video_path, "gyro_path": clip.gyro_path,
            "gyro_orientation": clip.orient,
            "frame_range": [0, clip.n_frames - 1],
            "lens_profile": {"path": clip.lens_path,
                             "name": clip.lens_name},
            "initial_guess": 500.0, "use_simple_presync": True,
            "simple_presync_radius": rig["radius_ms"],
            "simple_presync_step": rig["step_ms"],
        },
        "params": {"sync_window": rig["sync_window"],
                   "syncpoints_format": "auto",
                   "syncpoint_distance": rig["syncpoint_distance"]},
        "output": {"csv_path": os.path.join(WORK, "sync.csv"),
                   "debug_csv_path": os.path.join(WORK, "debug.csv")},
    }
    path = os.path.join(WORK, "recipe.json")
    with open(path, "w") as f:
        json.dump(recipe, f)
    return clip, path


def _run_cli(recipe_path: str) -> tuple[float, str]:
    """One CLI run in this process; returns (wall s, its stdout)."""
    from rssync_tpu.pipeline.__main__ import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main([recipe_path])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"CLI exit {rc}")
    return wall, buf.getvalue()


def _stage_table(stdout: str) -> str:
    """The `Timings.report()` table the CLI prints in progress mode."""
    lines = stdout.splitlines()
    start = next((i for i, ln in enumerate(lines)
                  if ln.startswith("stage ")), None)
    if start is None:
        return "(no stage table)"
    table = [lines[start]]
    for ln in lines[start + 1:]:
        if not ln.rstrip().endswith("s"):
            break
        table.append(ln)
    return "\n".join(table)


def phase_main_path(rehearse: bool, seed: int, tag: str) -> None:
    import numpy as np

    from rssync_tpu.ops.pallas_score import score_impl

    rig = TINY if rehearse else RIG
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        clip, recipe_path = _render_clip(rig, seed)
        print(f"[d] scoring implementation: {score_impl()}")
        with ComputeAppsSampler(not rehearse) as apps:
            cold, _ = _run_cli(recipe_path)
            warm, out = _run_cli(recipe_path)
        rows = np.loadtxt(os.path.join(WORK, "sync.csv"), delimiter=",",
                          ndmin=2)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    err = np.abs(rows[:, 1] - clip.true_delay * 1e3)
    print(f"[d] {rows.shape[0]} syncpoints: max offset err "
          f"{err.max():.4f} ms, mean {err.mean():.4f} ms "
          f"(tol {MAX_OFFSET_ERR_MS} ms)")
    print(f"[d] cold CLI wall (compile included) {cold:.2f} s {tag}")
    print(f"[d] warm CLI wall {warm:.2f} s {tag}; per-stage split:")
    print(_stage_table(out))
    if not rehearse:
        print(f"[d] processes on the card: at most {apps.most} per sample, "
              f"pids {sorted(apps.pids)} ({apps.samples} samples)",
              flush=True)
        if apps.most != 1 or len(apps.pids) != 1:
            fail(f"expected one process on the card, saw {apps.pids}")
    if rows.shape[0] < (2 if rehearse else 8):
        fail(f"only {rows.shape[0]} syncpoints")
    if not np.all(np.isfinite(err)) or err.max() > MAX_OFFSET_ERR_MS:
        fail(f"offset error {err.max():.4f} ms > {MAX_OFFSET_ERR_MS} ms")


def _fleet(rehearse: bool):
    """4 clips x 8 windows at the engine's full width (2 windows of 24
    features when rehearsing), stacked with per-window spline tables."""
    from rssync_tpu.parallel.multi import stack_problems
    from rssync_tpu.testing.engine_problem import make_engine_problem

    truths = [0.0423, -0.031, 0.0177, 0.0611]
    tables, wins, truth = [], [], []
    for i, d in enumerate(truths):
        p = make_engine_problem(
            seed=11 + i, duration=4.0 if rehearse else 16.5,
            fps=30.0 if rehearse else 60.0,
            n_features=24 if rehearse else 130,
            sync_window=12 if rehearse else 60,
            syncpoint_distance=48 if rehearse else 120, true_delay=d)
        tables += [p.table] * len(p.windows)
        wins += p.windows
        truth += [d] * len(p.windows)
    t, w = stack_problems(tables, wins, 0.2)
    return t, w, truth


def _run_fleet(tables, wins, mesh=None):
    """PreSync over +-200 ms @ 2 ms, then 4 Sync passes; returns
    (delays (W,), wall s)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rssync_tpu.core.presync import presync_grid
    from rssync_tpu.parallel import mesh as pmesh
    from rssync_tpu.parallel.multi import (
        batched_presync_multi,
        batched_sync_multi,
    )

    if mesh is not None:
        tables = jax.tree_util.tree_map(
            lambda x: pmesh.shard_vector(x, mesh), tables)
        wins = pmesh.shard_windows(wins, mesh)
    delays = jnp.asarray(np.asarray(presync_grid(0.0, 0.2, 0.002)),
                         jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    t0 = time.perf_counter()
    _, cur = batched_presync_multi(tables, wins, delays, keys[0], wide=True)
    centers = jnp.zeros_like(cur)
    for i in range(4):
        cur = batched_sync_multi(tables, wins, cur, centers, 0.2,
                                 keys[i + 1], wide=True).delay
    cur = jax.block_until_ready(cur)
    return np.asarray(cur, np.float64), time.perf_counter() - t0


def phase_four_cards(rehearse: bool, tag: str) -> None:
    import jax
    import numpy as np

    from rssync_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    if len(devs) < 4:
        fail(f"--four-cards needs 4 devices, found {len(devs)}")
    tables, wins, truth = _fleet(rehearse)
    mesh = make_mesh(devs[:4])
    results = {}
    for name, m in (("4 cards", mesh), ("1 card", None)):
        d, cold = _run_fleet(tables, wins, m)
        d, warm = _run_fleet(tables, wins, m)
        results[name] = d
        err = np.abs(d - np.asarray(truth)) * 1e3
        print(f"[4] {name}: {d.shape[0]} windows, cold {cold:.2f} s, warm "
              f"{warm:.3f} s {tag}; max offset err {err.max():.4f} ms",
              flush=True)
        if err.max() > MAX_OFFSET_ERR_MS:
            fail(f"{name}: offset error {err.max():.4f} ms")
    gap = float(np.abs(results["4 cards"] - results["1 card"]).max())
    print(f"[4] 4-card vs 1-card max |delay difference| {gap:.3g} s "
          f"(tol {FLEET_AGREE_S:g} s)")
    if not gap <= FLEET_AGREE_S:
        fail(f"4-card and 1-card delays differ by {gap:.3g} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-clip fleet, sharded over 4 "
                         "cards and on 1")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU dress rehearsal at tiny sizes, kernels "
                         "interpreted")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    # before JAX opens the device; one line per card
    card = "; ".join(card_line(args.rehearse).splitlines())
    sys.path.insert(0, REPO)
    from rssync_tpu.utils.timing import enable_compile_cache

    enable_compile_cache()
    info = phase_device(args.rehearse, card)
    tag = f"[{card}]"
    if args.four_cards:
        phase_four_cards(args.rehearse, tag)
    else:
        phase_kernel_parity(args.rehearse, tag)
        phase_golden()
        phase_main_path(args.rehearse, args.seed, tag)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
