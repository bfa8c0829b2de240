"""Generate golden parity artifacts from the compiled REFERENCE engine.

Drives golden/librssync_golden.so (the reference's src/core compiled
unmodified — see golden/README.md) on synthetic scenes with known true
delay, and writes every comparison tensor to tests/golden/golden.npz:

  - P matrices (opt_compute_problem) at several (frame, delay)
  - full / simple frame losses + jacobians at fixed (M, var_k)
  - raw spline samples over the knot range
  - PreSync best (cost, delay), DebugPreSync cost curve
  - 4-pass Sync final delays

The artifacts are committed; tests/test_golden.py checks the JAX
rebuild against them without needing the native build. Deterministic:
the golden build pins the RANSAC seed and runs serial (rng_override.h).

Usage (from the repo root): python golden/generate.py
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)

from synthetic import make_scene  # noqa: E402

DP = ctypes.POINTER(ctypes.c_double)


def _lib():
    lib = ctypes.CDLL(os.path.join(REPO, "golden", "librssync_golden.so"))
    lib.golden_create.restype = ctypes.c_void_p
    lib.golden_destroy.argtypes = [ctypes.c_void_p]
    lib.golden_set_gyro_fixed.argtypes = [
        ctypes.c_void_p, DP, ctypes.c_size_t, ctypes.c_double, ctypes.c_double]
    lib.golden_set_gyro_us.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), DP, ctypes.c_size_t]
    lib.golden_set_track.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [DP] * 4 + [ctypes.c_size_t])
    lib.golden_presync.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, DP, DP]
    lib.golden_sync.argtypes = lib.golden_presync.argtypes
    lib.golden_debug_presync.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, DP, DP, ctypes.c_int]
    lib.golden_compute_problem.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, DP]
    lib.golden_compute_problem.restype = ctypes.c_int
    lib.golden_frame_loss.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, DP, ctypes.c_double,
        DP, DP, DP]
    lib.golden_frame_loss_simple.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, DP, ctypes.c_double]
    lib.golden_frame_loss_simple.restype = ctypes.c_double
    lib.golden_spline_eval.argtypes = [ctypes.c_void_p, ctypes.c_double, DP]
    lib.golden_sample_rate.argtypes = [ctypes.c_void_p]
    lib.golden_sample_rate.restype = ctypes.c_double
    lib.golden_quats_start.argtypes = [ctypes.c_void_p]
    lib.golden_quats_start.restype = ctypes.c_double
    lib.golden_fill_gyro_interp.argtypes = [
        ctypes.c_void_p, DP, DP, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_double)]
    lib.golden_fill_gyro_interp.restype = ctypes.c_int
    return lib


def _dp(a):
    return np.ascontiguousarray(a, np.float64).ctypes.data_as(DP)


def rates_from_quats(quats_wxyz: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Angular-rate log (n, 3) rad/s whose left-multiply integration
    (q_i = from_aa(w_i*dt_i) o q_{i-1}, the driver convention of
    core_testcode.cpp:41-46) reproduces the scene's orientation
    history up to a constant global rotation (q_0 = identity instead
    of the scene's q_0 — the epipolar loss is invariant to it):
    w_i = rotvec(q_i o q_{i-1}^-1)/dt_i, w_0 = w_1."""
    from scipy.spatial.transform import Rotation

    q = np.asarray(quats_wxyz, np.float64)
    r = Rotation.from_quat(q[:, [1, 2, 3, 0]])  # xyzw
    rel = r[1:] * r[:-1].inv()  # left difference
    dt = np.diff(np.asarray(ts, np.float64))
    w = rel.as_rotvec() / dt[:, None]
    return np.concatenate([w[:1], w])


class Golden:
    """ctypes wrapper over one reference SyncProblem."""

    def __init__(self, lib, scene, intake="fixed"):
        self.lib = lib
        self.p = lib.golden_create()
        q = np.ascontiguousarray(scene.quats_wxyz, np.float64)
        assert q.shape[1] == 4
        self._keep = [q]
        if intake == "us":
            # exercise the variable-rate intake (50 Hz rounding + SLERP
            # resample, ref core_private.cpp:142-190)
            ts_us = np.ascontiguousarray(
                np.round(np.asarray(scene.gyro_ts) * 1e6).astype(np.int64))
            self._keep.append(ts_us)
            lib.golden_set_gyro_us(
                self.p, ts_us.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                _dp(q), q.shape[0])
        elif intake == "interp":
            # the reference driver's `#if 0` path (core_testcode.cpp:
            # 20-35): angular-rate log -> gyro_interpolate resample ->
            # fixed-dt integration -> fixed-rate overload
            rates = np.ascontiguousarray(
                rates_from_quats(q, scene.gyro_ts), np.float64)
            ts = np.ascontiguousarray(scene.gyro_ts, np.float64)
            self._keep += [rates, ts]
            self.rates = rates
            first = ctypes.c_double()
            self.interp_rate = lib.golden_fill_gyro_interp(
                self.p, _dp(ts), _dp(rates), ts.shape[0],
                ctypes.byref(first))
            self.interp_first_ts = first.value
        else:
            assert intake == "fixed"
            lib.golden_set_gyro_fixed(
                self.p, _dp(q), q.shape[0], float(scene.gyro_rate),
                float(scene.gyro_ts[0]))
        self.counts = {}
        for f, (ts_a, ts_b, rays_a, rays_b) in scene.frames.items():
            ra = np.ascontiguousarray(np.asarray(rays_a, np.float64))
            rb = np.ascontiguousarray(np.asarray(rays_b, np.float64))
            assert ra.shape[1] == 3, ra.shape
            self.lib.golden_set_track(
                self.p, f, _dp(ts_a), _dp(ts_b), _dp(ra), _dp(rb), ra.shape[0])
            self.counts[f] = ra.shape[0]

    def compute_problem(self, frame, delay):
        out = np.zeros((self.counts[frame], 3), np.float64)
        n = self.lib.golden_compute_problem(self.p, frame, float(delay), _dp0(out))
        assert n == self.counts[frame]
        return out

    def frame_loss(self, frame, delay, M, var_k):
        loss = ctypes.c_double()
        dg = ctypes.c_double()
        jm = np.zeros(3, np.float64)
        self.lib.golden_frame_loss(
            self.p, frame, float(delay), _dp(np.asarray(M, np.float64)),
            float(var_k), ctypes.byref(loss), ctypes.byref(dg), _dp0(jm))
        return loss.value, dg.value, jm

    def frame_loss_simple(self, frame, delay, M, var_k):
        return self.lib.golden_frame_loss_simple(
            self.p, frame, float(delay), _dp(np.asarray(M, np.float64)),
            float(var_k))

    def spline_eval(self, t):
        out = np.zeros(4, np.float64)
        self.lib.golden_spline_eval(self.p, float(t), _dp0(out))
        return out

    def presync(self, initial, fb, fe, step, radius):
        c = ctypes.c_double()
        d = ctypes.c_double()
        self.lib.golden_presync(self.p, initial, fb, fe, step, radius,
                                ctypes.byref(c), ctypes.byref(d))
        return c.value, d.value

    def sync(self, initial, fb, fe, center, radius):
        c = ctypes.c_double()
        d = ctypes.c_double()
        self.lib.golden_sync(self.p, initial, fb, fe, center, radius,
                             ctypes.byref(c), ctypes.byref(d))
        return c.value, d.value

    def sync_traced(self, initial, fb, fe, center, radius):
        """sync() + the engine's per-iteration stderr trace
        `<delay> <step_size>` (ref core_private.cpp:330), captured via
        an fd-2 redirect. Returns (cost, delay, traj (n_iters, 2))."""
        import tempfile

        sys.stderr.flush()
        old = os.dup(2)
        tmp = tempfile.TemporaryFile()
        os.dup2(tmp.fileno(), 2)
        try:
            c, d = self.sync(initial, fb, fe, center, radius)
        finally:
            os.dup2(old, 2)
            os.close(old)
        tmp.seek(0)
        rows = []
        for ln in tmp.read().decode(errors="replace").splitlines():
            parts = ln.split()
            if len(parts) == 2:
                try:
                    rows.append([float(parts[0]), float(parts[1])])
                except ValueError:
                    pass
        tmp.close()
        traj = np.asarray(rows, np.float64).reshape(-1, 2)
        return c, d, traj

    def debug_presync(self, initial, fb, fe, radius, n):
        delays = np.zeros(n, np.float64)
        costs = np.zeros(n, np.float64)
        self.lib.golden_debug_presync(self.p, initial, fb, fe, radius,
                                      _dp0(delays), _dp0(costs), n)
        return delays, costs

    def close(self):
        self.lib.golden_destroy(self.p)


def _dp0(a):
    """Pointer into an existing (writable) array — no copy."""
    assert a.flags["C_CONTIGUOUS"] and a.dtype == np.float64
    return a.ctypes.data_as(DP)


SCENES = {
    "rot16": dict(seed=8, true_delay=-0.0442, n_frames=16, n_points=80),
    "trans12": dict(seed=3, true_delay=0.0185, n_frames=12, n_points=60,
                    translation_speed=0.8),
    # round-3 additions (VERDICT r2 item 5b):
    # near-degenerate low-feature frames (RANSAC quartile index n/4=2)
    "lowfeat": dict(seed=5, true_delay=0.012, n_frames=10, n_points=10),
    # translation-dominant scene, much stronger than trans12
    "trans30": dict(seed=13, true_delay=-0.021, n_frames=12, n_points=70,
                    translation_speed=2.5),
    # variable-rate gyro -> micro-second intake path (50 Hz rounding +
    # SLERP resample) on BOTH engines
    "varrate": dict(seed=21, true_delay=0.0305, n_frames=12, n_points=60,
                    rate_jitter=0.35),
    # round-4 addition (VERDICT r3 #6): the reference driver's `#if 0`
    # fixed-rate path (gyro_interpolate at 213 -> 200 Hz + fixed-dt
    # integration + fixed-rate overload) on BOTH engines, from an
    # angular-rate log
    "interp": dict(seed=34, true_delay=-0.0117, n_frames=12, n_points=60,
                   rate_jitter=0.3, gyro_rate=213.0),
}

#: scenes fed through the driver's gyro_interpolate path
INTERP_SCENES = {"interp"}

PROBE_DELAYS = [-0.05, -0.0442, 0.0, 0.013, 0.05]
PROBE_M = np.array([0.267261, 0.534522, 0.801784])
PROBE_VARK = 250.0


def main():
    lib = _lib()
    out = {}
    for name, cfg in SCENES.items():
        scene = make_scene(**cfg)
        if name in INTERP_SCENES:
            intake = "interp"
        elif cfg.get("rate_jitter", 0.0) > 0.0:
            intake = "us"
        else:
            intake = "fixed"
        g = Golden(lib, scene, intake=intake)
        F = cfg["n_frames"]
        # the effective spline params differ from the raw log under the
        # us intake (50 Hz rounding + resample); export for test parity
        out[f"{name}/gyro_params"] = np.array(
            [g.lib.golden_sample_rate(g.p), g.lib.golden_quats_start(g.p)])
        if intake == "interp":
            # the rate log the rebuild must push through its own
            # gyro_interpolate + fixed-rate integration
            out[f"{name}/rates"] = g.rates
            out[f"{name}/rates_ts"] = np.asarray(scene.gyro_ts, np.float64)
            out[f"{name}/interp_params"] = np.array(
                [float(g.interp_rate), g.interp_first_ts])

        for d in PROBE_DELAYS:
            for f in (0, F // 2, F - 2):
                out[f"{name}/P/f{f}/d{d}"] = g.compute_problem(f, d)
        for d in (0.0, cfg["true_delay"]):
            for f in (0, F // 2):
                loss, dg, jm = g.frame_loss(f, d, PROBE_M, PROBE_VARK)
                out[f"{name}/loss/f{f}/d{d}"] = np.array(
                    [loss, dg, *jm])
                out[f"{name}/loss_simple/f{f}/d{d}"] = np.array(
                    [g.frame_loss_simple(f, d, PROBE_M, PROBE_VARK)])
        ts = np.linspace(-5.0, len(scene.quats_wxyz) + 5.0, 97)
        out[f"{name}/spline/ts"] = ts
        out[f"{name}/spline/vals"] = np.stack([g.spline_eval(t) for t in ts])

        c, d = g.presync(0.0, 0, F, 0.002, 0.2)
        out[f"{name}/presync"] = np.array([c, d])
        dd, cc = g.debug_presync(0.0, 0, F, 0.2, 200)
        out[f"{name}/debug_presync/delays"] = dd
        out[f"{name}/debug_presync/costs"] = cc

        delay = d
        finals = []
        for p in range(4):
            _, delay, traj = g.sync_traced(delay, 0, F - 1, d, 0.2)
            finals.append(delay)
            # per-iteration (delay, step_size) of the REAL engine
            # (6-sig-digit stderr precision) for trajectory parity
            out[f"{name}/sync_traj/p{p}"] = traj
        out[f"{name}/sync_delays"] = np.array(finals)
        print(f"{name}: presync={d:+.4f}  sync={delay:+.6f}  "
              f"true={cfg['true_delay']:+.6f}  "
              f"err={abs(delay - cfg['true_delay']) * 1e3:.4f} ms",
              file=sys.stderr)
        g.close()

    dst = os.path.join(REPO, "tests", "golden", "golden.npz")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    np.savez_compressed(dst, **out)
    print(f"wrote {dst} ({len(out)} arrays)", file=sys.stderr)


if __name__ == "__main__":
    main()
