"""Engine tests: compute_problem / RANSAC / PreSync vs the f64 oracle,
and PreSync+Sync ground-truth recovery on a synthetic scene."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

from rssync_tpu.core import presync as presync_mod
from rssync_tpu.core import ransac
from rssync_tpu.core import sync as sync_mod
from rssync_tpu.core.problem import build_track_window, compute_problem, make_spline_table

def problem_mod_compute(table, win, delay):
    return compute_problem(table, win, jnp.float32(delay))

from oracle import OracleProblem
from synthetic import make_scene


@pytest.fixture(scope="module")
def scene():
    return make_scene(seed=3, true_delay=0.037, n_frames=12, n_points=60)


@pytest.fixture(scope="module")
def engine_problem(scene):
    table = make_spline_table(scene.quats_wxyz, scene.gyro_rate)
    frames = sorted(scene.frames)
    win = build_track_window(
        [scene.frames[f][0] for f in frames],
        [scene.frames[f][1] for f in frames],
        [scene.frames[f][2] for f in frames],
        [scene.frames[f][3] for f in frames],
        quats_start=float(scene.gyro_ts[0]),
        sample_rate=scene.gyro_rate,
    )
    return table, win, frames


@pytest.fixture(scope="module")
def oracle_problem(scene):
    op = OracleProblem(scene.quats_wxyz, scene.gyro_rate, float(scene.gyro_ts[0]))
    for f, (ta, tb, ra, rb) in scene.frames.items():
        op.set_track(f, ta, tb, ra, rb)
    return op


def test_compute_problem_matches_oracle(engine_problem, oracle_problem):
    table, win, frames = engine_problem
    for delay in [0.0, 0.037, -0.1]:
        # engine layout is SoA (3, F, N); compare in the oracle's (N, 3)
        P = np.moveaxis(
            np.asarray(compute_problem(table, win, jnp.float32(delay))), 0, -1
        )
        for fi, f in enumerate(frames):
            Pref = oracle_problem.compute_problem(f, delay)
            n = Pref.shape[0]
            np.testing.assert_allclose(P[fi, :n], Pref, atol=2e-5)
            # padded rows zero
            assert np.all(P[fi, n:] == 0.0)


def test_problem_rows_vanish_at_true_delay(engine_problem, scene):
    """Pure-rotation scene: P rows ~ 0 at the true delay, |P| >> 0 off."""
    table, win, _ = engine_problem
    P_true = np.asarray(compute_problem(table, win, jnp.float32(scene.true_delay)))
    P_off = np.asarray(compute_problem(table, win, jnp.float32(scene.true_delay + 0.02)))
    assert np.abs(P_true).max() < 5e-4
    assert np.abs(P_off).max() > 1e-3


def test_ransac_matches_oracle_given_same_pairs(engine_problem, oracle_problem):
    table, win, frames = engine_problem
    delay = 0.01
    P = np.asarray(compute_problem(table, win, jnp.float32(delay)))  # (3,F,N)
    key = jax.random.PRNGKey(42)
    f = 0
    count = int(win.counts[f])
    r0, r1 = ransac.sample_pairs(key, 50, count)
    got = np.asarray(ransac.guess_motion_from_pairs(
        jnp.asarray(P[:, f]), count, r0, r1
    ))
    ref = oracle_problem.compute_problem(frames[f], delay)
    want = oracle_problem.guess_motion_from_pairs(ref, np.asarray(r0), np.asarray(r1))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sample_pairs_distinct_and_in_range():
    key = jax.random.PRNGKey(0)
    r0, r1 = ransac.sample_pairs(key, 1000, jnp.asarray(37))
    r0, r1 = np.asarray(r0), np.asarray(r1)
    assert np.all(r0 != r1)
    assert r0.min() >= 0 and r0.max() < 37
    assert r1.min() >= 0 and r1.max() < 37


def test_presync_cost_formula_matches_oracle(engine_problem, oracle_problem):
    """Cost-formula parity, decoupled from RANSAC argmin tie-breaks:
    feed the ORACLE's winning motions into the engine's f32 cost and
    compare against the oracle's f64 cost."""
    table, win, frames = engine_problem
    delay = 0.005
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, win.num_frames)
    pairs, Ms = {}, []
    for fi, f in enumerate(frames):
        r0, r1 = ransac.sample_pairs(
            keys[fi], presync_mod.PRESYNC_RANSAC_ITERS, int(win.counts[fi])
        )
        pairs[f] = (np.asarray(r0), np.asarray(r1))
        Pref = oracle_problem.compute_problem(f, delay)
        Ms.append(oracle_problem.guess_motion_from_pairs(Pref, *pairs[f]))
    want = oracle_problem.presync_cost(frames, delay, pairs)
    P = problem_mod_compute(table, win, delay)
    got = float(
        presync_mod.cost_with_motion(
            P, jnp.asarray(np.stack(Ms), jnp.float32), win.frame_mask
        )
    )
    assert abs(got - want) / max(abs(want), 1e-9) < 2e-3


def test_presync_ransac_winner_is_defensible(engine_problem, oracle_problem):
    """The engine's f32 RANSAC winner may differ from the oracle's on
    near-ties; assert its oracle-scored quartile is no worse than the
    oracle winner's by more than f32 noise."""
    table, win, frames = engine_problem
    delay = 0.005
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, win.num_frames)
    P_all = np.asarray(problem_mod_compute(table, win, delay))
    for fi, f in enumerate(frames):
        count = int(win.counts[fi])
        r0, r1 = ransac.sample_pairs(
            keys[fi], presync_mod.PRESYNC_RANSAC_ITERS, count
        )
        got_M = np.asarray(
            ransac.guess_motion_from_pairs(jnp.asarray(P_all[:, fi]), count, r0, r1)
        )
        Pref = oracle_problem.compute_problem(f, delay)
        oracle_M = oracle_problem.guess_motion_from_pairs(
            Pref, np.asarray(r0), np.asarray(r1)
        )

        def quartile(P, M):
            nP = P / np.maximum(np.linalg.norm(P, axis=1, keepdims=True), 1e-12)
            res2 = np.sort((nP @ M) ** 2)
            return res2[len(res2) // 4]

        assert quartile(Pref, got_M) <= quartile(Pref, oracle_M) + 1e-6


def test_presync_recovers_true_delay(engine_problem, scene):
    table, win, _ = engine_problem
    delays = np.arange(-0.2, 0.2, 0.002) + 0.0
    costs = presync_mod.presync_scan(
        table, win, jnp.asarray(delays, jnp.float32), jax.random.PRNGKey(1)
    )
    cost, best = presync_mod.presync_best(costs, jnp.asarray(delays, jnp.float32))
    assert abs(float(best) - scene.true_delay) < 0.002 + 1e-6


def test_sync_refines_to_submillisecond(engine_problem, scene):
    table, win, _ = engine_problem
    res = sync_mod.sync_window(
        table,
        win,
        jnp.float32(scene.true_delay + 0.004),  # start 4 ms off
        jnp.float32(scene.true_delay + 0.004),
        jnp.float32(0.2),
        jax.random.PRNGKey(2),
    )
    assert abs(float(res.delay) - scene.true_delay) < 5e-4
    assert int(res.iterations) < 400


def test_sync_jvp_gradient_matches_vjp(engine_problem, scene):
    """delay_grad="jvp" (default) and "vjp" are the same derivative up
    to float rounding: full Sync trajectories must agree to a few µs
    and land on the same final delay (regression pin for the
    forward-mode delay gradient)."""
    table, win, _ = engine_problem
    out = {}
    for mode in ("jvp", "vjp"):
        out[mode] = sync_mod.sync_window(
            table, win,
            jnp.float32(scene.true_delay + 0.004),
            jnp.float32(scene.true_delay + 0.004),
            jnp.float32(0.2),
            jax.random.PRNGKey(2),
            delay_grad=mode,
        )
    assert abs(float(out["jvp"].delay) - float(out["vjp"].delay)) < 2e-6
    tj = np.asarray(out["jvp"].trace_delay)
    tv = np.asarray(out["vjp"].trace_delay)
    n = min(int(out["jvp"].iterations), int(out["vjp"].iterations))
    np.testing.assert_allclose(tj[:n], tv[:n], atol=5e-6)


def test_sync_with_translation_scene():
    """Strong-translation scene — the per-frame translation direction
    must absorb parallax (the reference's 'table' dataset regime)."""
    scene = make_scene(
        seed=11, true_delay=-0.021, n_frames=12, n_points=60,
        translation_speed=1.5,
    )
    table = make_spline_table(scene.quats_wxyz, scene.gyro_rate)
    frames = sorted(scene.frames)
    win = build_track_window(
        [scene.frames[f][0] for f in frames],
        [scene.frames[f][1] for f in frames],
        [scene.frames[f][2] for f in frames],
        [scene.frames[f][3] for f in frames],
        quats_start=float(scene.gyro_ts[0]),
        sample_rate=scene.gyro_rate,
    )
    res = sync_mod.sync_window(
        table, win,
        jnp.float32(scene.true_delay + 0.003),
        jnp.float32(scene.true_delay + 0.003),
        jnp.float32(0.2),
        jax.random.PRNGKey(5),
    )
    assert abs(float(res.delay) - scene.true_delay) < 1e-3


def test_sync_radius_guard(engine_problem, scene):
    """Delay leaving search_center ± radius stops the loop (ref :326-328)."""
    table, win, _ = engine_problem
    res = sync_mod.sync_window(
        table, win,
        jnp.float32(scene.true_delay + 0.004),
        jnp.float32(scene.true_delay + 0.5),  # center far away ->
        jnp.float32(1e-5),                    # guard trips immediately
        jax.random.PRNGKey(2),
    )
    assert int(res.iterations) == 1
