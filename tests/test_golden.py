"""Golden parity vs the REAL reference engine.

tests/golden/golden.npz is produced by golden/generate.py driving
librssync_golden.so — the reference's own src/core/core_private.cpp
compiled unmodified against the shims in golden/shim (see
golden/README.md). These tests check the JAX rebuild against those
committed artifacts: P matrices, frame losses + jacobians, raw spline
samples (including the extrapolation-boundary quirks), PreSync /
DebugPreSync behavior, and 4-pass Sync delays.

Scene configs must match golden/generate.py::SCENES exactly.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

from rssync_tpu.core import presync as presync_mod
from rssync_tpu.core import sync as sync_mod
from rssync_tpu.core.problem import (
    build_track_window,
    compute_problem,
    make_spline_table,
)
from rssync_tpu.ops.spline import eval_spline_packed

from synthetic import make_scene

import jax

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")

# keep in lockstep with golden/generate.py
SCENES = {
    "rot16": dict(seed=8, true_delay=-0.0442, n_frames=16, n_points=80),
    "trans12": dict(seed=3, true_delay=0.0185, n_frames=12, n_points=60,
                    translation_speed=0.8),
    "lowfeat": dict(seed=5, true_delay=0.012, n_frames=10, n_points=10),
    "trans30": dict(seed=13, true_delay=-0.021, n_frames=12, n_points=70,
                    translation_speed=2.5),
    "varrate": dict(seed=21, true_delay=0.0305, n_frames=12, n_points=60,
                    rate_jitter=0.35),
    "interp": dict(seed=34, true_delay=-0.0117, n_frames=12, n_points=60,
                   rate_jitter=0.3, gyro_rate=213.0),
}
PROBE_DELAYS = [-0.05, -0.0442, 0.0, 0.013, 0.05]
PROBE_M = np.array([0.267261, 0.534522, 0.801784])
PROBE_VARK = 250.0


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _problem(name):
    cfg = SCENES[name]
    scene = make_scene(**cfg)
    if name == "interp":
        # the reference driver's `#if 0` fixed-rate path
        # (core_testcode.cpp:20-35) on BOTH engines: the golden npz
        # carries the exact angular-rate log the reference consumed;
        # the rebuild pushes it through its own gyro_interpolate +
        # fixed-dt integration + fixed-rate intake
        from rssync_tpu.frontend.integrate import integrate_gyro_fixed_rate
        from rssync_tpu.ops.signal import gyro_interpolate

        g = np.load(GOLDEN)
        new_ts, new_g, rate = gyro_interpolate(
            g["interp/rates_ts"], g["interp/rates"].T
        )
        quats = integrate_gyro_fixed_rate(new_g.T, float(rate))
        table = make_spline_table(quats, float(rate))
        quats_start = float(new_ts[0])
        sample_rate = float(rate)
    elif cfg.get("rate_jitter", 0.0) > 0.0:
        # variable-rate scene: the micro-second intake path (50 Hz
        # rounding + SLERP resample, ref core_private.cpp:142-190) on
        # BOTH engines — golden/generate.py feeds golden_set_gyro_us
        from rssync_tpu.core.api import resample_quats_us

        ts_us = np.round(np.asarray(scene.gyro_ts) * 1e6).astype(np.int64)
        rate, new_ts, new_q = resample_quats_us(ts_us, scene.quats_wxyz)
        table = make_spline_table(new_q, float(rate))
        quats_start = float(new_ts[0]) / 1e6
        sample_rate = float(rate)
    else:
        table = make_spline_table(scene.quats_wxyz, scene.gyro_rate)
        quats_start = float(scene.gyro_ts[0])
        sample_rate = scene.gyro_rate
    frames = sorted(scene.frames)
    win = build_track_window(
        [scene.frames[f][0] for f in frames],
        [scene.frames[f][1] for f in frames],
        [scene.frames[f][2] for f in frames],
        [scene.frames[f][3] for f in frames],
        quats_start=quats_start,
        sample_rate=sample_rate,
    )
    return scene, table, win, frames


def test_varrate_gyro_params_match_reference(golden):
    """The µs intake's integer arithmetic (rate estimate, 50 Hz
    rounding, grid start) must agree with the reference exactly."""
    from rssync_tpu.core.api import resample_quats_us

    scene = make_scene(**SCENES["varrate"])
    ts_us = np.round(np.asarray(scene.gyro_ts) * 1e6).astype(np.int64)
    rate, new_ts, _ = resample_quats_us(ts_us, scene.quats_wxyz)
    ref_rate, ref_start = golden["varrate/gyro_params"]
    assert float(rate) == ref_rate
    np.testing.assert_allclose(float(new_ts[0]) / 1e6, ref_start, atol=0)


@pytest.mark.parametrize("name", list(SCENES))
def test_P_matrix_matches_reference(golden, name):
    scene, table, win, frames = _problem(name)
    F = SCENES[name]["n_frames"]
    for d in PROBE_DELAYS:
        P = np.moveaxis(
            np.asarray(compute_problem(table, win, jnp.float32(d))), 0, -1
        )  # (F, N, 3)
        for f in (0, F // 2, F - 2):
            ref = golden[f"{name}/P/f{f}/d{d}"]
            np.testing.assert_allclose(
                P[f, : ref.shape[0]], ref, atol=5e-5,
                err_msg=f"{name} frame {f} delay {d}",
            )


@pytest.mark.parametrize("name", list(SCENES))
def test_frame_loss_matches_reference(golden, name):
    scene, table, win, frames = _problem(name)
    F = SCENES[name]["n_frames"]
    M = jnp.asarray(PROBE_M, jnp.float32)

    for d in (0.0, SCENES[name]["true_delay"]):
        for f in (0, F // 2):
            ref = golden[f"{name}/loss/f{f}/d{d}"]
            ref_simple = golden[f"{name}/loss_simple/f{f}/d{d}"][0]
            # full and simple overloads agree in the reference
            np.testing.assert_allclose(ref[0], ref_simple, rtol=1e-12)

            def loss_fn(delay):
                P = compute_problem(table, win, delay)
                return sync_mod.frame_loss(P[:, f], M, jnp.float32(PROBE_VARK))

            val, dgrad = jax.value_and_grad(loss_fn)(jnp.float32(d))
            np.testing.assert_allclose(float(val), ref[0], rtol=5e-4,
                                       atol=1e-6,
                                       err_msg=f"{name} f{f} d{d} loss")
            # reference delay-grad is a central difference (step 1e-6)
            # in f64; ours is analytic f32
            np.testing.assert_allclose(
                float(dgrad), ref[1], rtol=2e-2, atol=5e-3 * abs(ref[1]) + 1e-2,
                err_msg=f"{name} f{f} d{d} delay grad",
            )

            def loss_m(m):
                P = compute_problem(table, win, jnp.float32(d))
                return sync_mod.frame_loss(P[:, f], m, jnp.float32(PROBE_VARK))

            jm = np.asarray(jax.grad(loss_m)(M))
            np.testing.assert_allclose(
                jm, ref[2:], rtol=1e-3, atol=1e-4,
                err_msg=f"{name} f{f} d{d} motion jac",
            )


@pytest.mark.parametrize("name", list(SCENES))
def test_spline_matches_reference(golden, name):
    scene, table, win, frames = _problem(name)
    ts = golden[f"{name}/spline/ts"]
    ref = golden[f"{name}/spline/vals"]  # (T, 4)
    i0 = jnp.asarray(np.floor(ts), jnp.int32)
    p = jnp.asarray(ts - np.floor(ts), jnp.float32)
    got = np.asarray(eval_spline_packed(table.coeffs, i0, p)).T  # (T, 4)
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("name", list(SCENES))
def test_presync_matches_reference(golden, name):
    scene, table, win, frames = _problem(name)
    F = SCENES[name]["n_frames"]
    ref_cost, ref_delay = golden[f"{name}/presync"]

    delays = jnp.asarray(np.arange(-0.2, 0.2, 0.002), jnp.float32)
    costs = presync_mod.presync_scan(
        table, win, delays, jax.random.PRNGKey(0)
    )
    _, best = presync_mod.presync_best(costs, delays)
    # RANSAC draws differ between engines; the located coarse minimum
    # must agree to within two grid bins
    assert abs(float(best) - ref_delay) <= 0.004 + 1e-9, (best, ref_delay)

    ref_curve = golden[f"{name}/debug_presync/costs"]
    ref_dd = golden[f"{name}/debug_presync/delays"]
    dbg_delays = jnp.asarray(ref_dd, jnp.float32)
    curve = np.asarray(
        presync_mod.presync_scan(table, win, dbg_delays, jax.random.PRNGKey(1))
    )
    # same argmin neighborhood
    assert abs(int(np.argmin(curve)) - int(np.argmin(ref_curve))) <= 2
    # same loss-surface shape (RANSAC noise keeps it from being exact)
    a = (curve - curve.mean()) / curve.std()
    b = (ref_curve - ref_curve.mean()) / ref_curve.std()
    assert float(np.mean(a * b)) > 0.99


@pytest.mark.parametrize("name", list(SCENES))
def test_sync_matches_reference(golden, name):
    scene, table, win, frames = _problem(name)
    cfg = SCENES[name]
    ref_finals = golden[f"{name}/sync_delays"]
    _, ref_presync_delay = golden[f"{name}/presync"]

    delay = jnp.float32(ref_presync_delay)
    for i in range(4):
        res = sync_mod.sync_window(
            table, win, delay, jnp.float32(ref_presync_delay),
            jnp.float32(0.2), jax.random.PRNGKey(10 + i),
        )
        delay = res.delay
    got = float(delay)
    assert abs(got - ref_finals[-1]) < 2.5e-4, (got, ref_finals[-1])
    assert abs(got - cfg["true_delay"]) < 5e-4


@pytest.mark.parametrize("name", list(SCENES))
def test_sync_trajectory_matches_reference(golden, name):
    """Per-iteration delay iterates of the REAL engine's 4-pass Sync
    (captured from its stderr trace, core_private.cpp:330) vs ours in
    motion_opt='lbfgs' mode. With the ensmallen strong-Wolfe line
    search in both the golden shim and batched_lbfgs, the trajectories
    agree to ~1e-7 (measured); the 3e-5 tolerance absorbs the trace's
    6-significant-digit stderr precision plus varrate's f32 resampled-
    spline noise (~1e-5 wiggle around convergence). The reference does
    not print the final breaking iteration, hence the prefix
    comparison."""
    scene, table, win, frames = _problem(name)
    _, ref_presync_delay = golden[f"{name}/presync"]

    delay = jnp.float32(ref_presync_delay)
    for p in range(4):
        res = sync_mod.sync_window(
            table, win, delay, jnp.float32(ref_presync_delay),
            jnp.float32(0.2), jax.random.PRNGKey(10 + p),
            motion_opt="lbfgs",
        )
        traj_ref = golden[f"{name}/sync_traj/p{p}"]
        n_it = int(res.iterations)
        assert abs(n_it - len(traj_ref)) <= 1, (n_it, len(traj_ref))
        m = min(len(traj_ref), n_it)
        # interp's table is rates->resample->reintegrate: the extra
        # interpolation noise flattens the loss near convergence, so
        # later-pass iterates wander ~5e-5 around the same minimum
        # (final-offset parity is still pinned by
        # test_sync_matches_reference and the 0.08 ms truth error)
        atol = 1e-4 if name == "interp" else 3e-5
        if m:
            ours = np.asarray(res.trace_delay)[:m]
            np.testing.assert_allclose(
                ours, traj_ref[:m, 0], atol=atol,
                err_msg=f"{name} pass {p}",
            )
            steps = np.abs(np.asarray(res.trace_step)[:m])
            np.testing.assert_allclose(
                steps, traj_ref[:m, 1], atol=atol,
                err_msg=f"{name} pass {p} steps",
            )
        delay = res.delay
