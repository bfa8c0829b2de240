"""Front-end tests: telemetry parsing (GPMF MP4, gcsv, csv,
orientation), gyro integration, lens profiles, metrics."""

import numpy as np
import pytest

from rssync_tpu.frontend import telemetry
from rssync_tpu.frontend.integrate import integrate_gyro, integrate_gyro_fixed_rate
from rssync_tpu.frontend.lens_profiles import load_lens_profile
from rssync_tpu.analysis.metrics import sync_rmse, sync_rmse_from_csv
from rssync_tpu.utils.checks import SyncPanic

from gpmf_fixture import write_camm_mp4, write_gpmf_mp4


@pytest.fixture
def gyro_signal(rng):
    n = 1000
    t = np.arange(n) / 200.0
    g = np.stack(
        [np.sin(2 * np.pi * 0.7 * t), np.cos(2 * np.pi * 1.3 * t), 0.3 * np.sin(t)],
        axis=1,
    )
    return t, g


def test_gpmf_mp4_roundtrip(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = str(tmp_path / "clip.mp4")
    write_gpmf_mp4(p, g, rate_hz=200.0)
    data = telemetry.load_gyro(p, prefer_native=False)
    assert data.samples == len(g)
    np.testing.assert_allclose(data.gyro, g, atol=1e-3)  # int16 quantization
    np.testing.assert_allclose(data.timestamps, t, atol=1e-2)  # stts ms grid
    # monotonic
    assert np.all(np.diff(data.timestamps) >= 0)


def test_camm_mp4_roundtrip(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = str(tmp_path / "cam.mp4")
    write_camm_mp4(p, g, rate_hz=200.0)
    data = telemetry.load_gyro(p, prefer_native=False)
    assert data.samples == len(g)
    np.testing.assert_allclose(data.gyro, g, atol=1e-6)  # f32 payload
    np.testing.assert_allclose(data.timestamps, t, atol=1e-4)


def test_blackbox_csv(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = str(tmp_path / "LOG00001.01.csv")
    deg = np.rad2deg(g)
    with open(p, "w") as f:
        f.write("loopIteration, time, axisP[0], gyroADC[0], gyroADC[1], gyroADC[2]\n")
        for i in range(len(t)):
            f.write(f"{i}, {t[i] * 1e6:.0f}, 0, "
                    f"{deg[i, 0]:.6f}, {deg[i, 1]:.6f}, {deg[i, 2]:.6f}\n")
    data = telemetry.load_gyro(p, prefer_native=False)
    assert data.samples == len(g)
    np.testing.assert_allclose(data.gyro, g, atol=1e-6)
    np.testing.assert_allclose(data.timestamps, t, atol=1e-6)


def test_gpmf_orin_normalization(tmp_path, gyro_signal):
    """ORIN='zxY' means the raw columns are (z, x, -y)-ish; the parser
    must normalize back to XYZ."""
    t, g = gyro_signal
    # write columns permuted per ORIN=ZXy: raw = [z, x, -y]
    raw = np.stack([g[:, 2], g[:, 0], -g[:, 1]], axis=1)
    p = str(tmp_path / "o.mp4")
    write_gpmf_mp4(p, raw, rate_hz=200.0, orin=b"ZXy", orio=b"XYZ")
    data = telemetry.load_gyro(p, prefer_native=False)
    np.testing.assert_allclose(data.gyro, g, atol=2e-3)


def test_orientation_string(gyro_signal):
    _, g = gyro_signal
    out = telemetry.apply_orientation(g, "yZX")
    np.testing.assert_allclose(out[:, 0], -g[:, 1])
    np.testing.assert_allclose(out[:, 1], g[:, 2])
    np.testing.assert_allclose(out[:, 2], g[:, 0])
    with pytest.raises(ValueError):
        telemetry.apply_orientation(g, "abc")


def test_gcsv_roundtrip(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = tmp_path / "log.gcsv"
    lines = ["GYROFLOW IMU LOG", "version,1.3", "id,custom_logger",
             "tscale,0.005", "gscale,0.00122", "ascale,0.0001", "t,gx,gy,gz"]
    for i in range(len(t)):
        ticks = int(round(t[i] / 0.005))
        lines.append(
            f"{ticks},{g[i,0]/0.00122:.3f},{g[i,1]/0.00122:.3f},{g[i,2]/0.00122:.3f}"
        )
    p.write_text("\n".join(lines))
    data = telemetry.load_gyro(str(p), prefer_native=False)
    np.testing.assert_allclose(data.timestamps, t, atol=1e-9)
    np.testing.assert_allclose(data.gyro, g, atol=1e-5)


def test_csv_roundtrip(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = tmp_path / "log.csv"
    np.savetxt(p, np.column_stack([t, g]), delimiter=",",
               header="t,gx,gy,gz")
    data = telemetry.load_gyro(str(p), prefer_native=False)
    np.testing.assert_allclose(data.gyro, g, atol=1e-6)


def test_integration_matches_sequential(gyro_signal):
    """associative_scan integration == naive sequential fold."""
    t, g = gyro_signal
    got = integrate_gyro(t, g)
    # sequential reference in f64 (scipy-free, straight from the spec)
    from scipy.spatial.transform import Rotation

    q = Rotation.identity()
    seq = [np.array([1.0, 0, 0, 0])]
    for i in range(1, len(t)):
        dq = Rotation.from_rotvec(g[i] * (t[i] - t[i - 1]))
        q = dq * q  # left multiply
        x, y, z, w = q.as_quat()
        seq.append(np.array([w, x, y, z]))
    seq = np.stack(seq)
    sign = np.sign(np.sum(got * seq, axis=1, keepdims=True))
    np.testing.assert_allclose(got, sign * seq, atol=5e-5)


def test_integration_fixed_rate(gyro_signal):
    _, g = gyro_signal
    out = integrate_gyro_fixed_rate(g, 200.0)
    assert out.shape == (len(g), 4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-6)


def test_lens_profile_loader(tmp_path):
    p = tmp_path / "lens.txt"
    p.write_text(
        "other_cam 0.02 1000 1000 960 540 0.1 0.01 0.001 0.0001\n"
        "hero6_27k_43 0.01111 1186 1186 1355.389 1020.317 "
        "0.04440465777694087 0.01946789951179939 "
        "-0.004476697539343917 -0.002042912877740792\n"
    )
    lens = load_lens_profile(str(p), "hero6_27k_43")
    assert lens.ro == pytest.approx(0.01111)
    assert lens.fx == pytest.approx(1186)
    assert lens.k4 == pytest.approx(-0.002042912877740792)
    with pytest.raises(RuntimeError, match="preset"):
        load_lens_profile(str(p), "nope")


def test_sync_rmse_metric(tmp_path):
    frames = np.arange(0, 1000, 100)
    true = 5.0 + 0.001 * frames
    noise = np.array([0.1, -0.1, 0.05, -0.05, 0.0, 0.1, -0.1, 0.0, 0.05, -0.05])
    q = sync_rmse(frames, true + noise)
    # reference formula: std(linear fit - measured) (plot_sync.py:44-50)
    import scipy.stats as st
    r = st.linregress(frames, true + noise)
    expect = np.std(r.intercept + r.slope * frames - (true + noise))
    assert q.rmse == pytest.approx(expect, abs=1e-9)
    assert q.slope == pytest.approx(r.slope, abs=1e-9)
    p = tmp_path / "sync.csv"
    np.savetxt(p, np.column_stack([frames, true + noise]), delimiter=",")
    q2 = sync_rmse_from_csv(str(p))
    assert q2.rmse == pytest.approx(q.rmse)


def test_to_gyroflow_offset():
    """The thesis's manual-verification convention (thesis p.15/p.32):
    sign flip + readout/2 frame-center shift — for the Hero-6's
    11.11 ms readout the shift is +5.555 ms."""
    from rssync_tpu.analysis.metrics import to_gyroflow_offset

    # zero engine delay -> pure +r/2 convention offset
    assert to_gyroflow_offset(0.0, 0.01111) == pytest.approx(0.005555)
    # sign flips: a +12.3 ms engine delay enters GyroFlow as -12.3 + 5.555
    assert to_gyroflow_offset(0.0123, 0.01111) == pytest.approx(
        -0.0123 + 0.005555
    )
    # array-friendly
    out = to_gyroflow_offset(np.array([0.0, 0.01]), 0.02)
    np.testing.assert_allclose(out, [0.01, 0.0])


def test_presync_grid_matches_reference_loop():
    """presync_grid must reproduce the reference's f64 accumulation
    (core_private.cpp:69-70) bit-for-bit — including whether the last
    point lands inside the half-open bound."""
    from rssync_tpu.core.presync import presync_grid

    for init, radius, step in [
        (0.0, 0.2, 0.002),
        (-0.0123, 0.05, 0.003),
        (1.5, 0.1, 0.007),
        (0.0, 0.01, 0.002),
    ]:
        ref = []
        d = init - radius
        while d < init + radius:
            ref.append(d)
            d += step
        got = presync_grid(init, radius, step)
        assert got == ref  # exact f64 equality, not approx


def test_bad_gyro_file(tmp_path):
    p = tmp_path / "junk.gcsv"
    p.write_text("hello\nworld\n")
    with pytest.raises(SyncPanic):
        telemetry.load_gyro(str(p), prefer_native=False)


def _probe_to_text(path, orient=None):
    import io

    from rssync_tpu.frontend.probe import probe_file

    out = io.StringIO()
    ok = probe_file(str(path), orient, out=out)
    return ok, out.getvalue()


def test_probe_gpmf_mp4(tmp_path):
    """The first-contact kit dumps box tree, track candidates, KLV
    tree, sample counts, and rate estimate for a healthy GPMF MP4."""
    from gpmf_fixture import write_gpmf_mp4

    n = 400
    t = np.arange(n) / 200.0
    g = np.stack([np.sin(3 * t), np.cos(2 * t), 0.5 * t], axis=1)
    p = tmp_path / "clip.mp4"
    write_gpmf_mp4(str(p), g, rate_hz=200.0)
    ok, text = _probe_to_text(p)
    assert ok
    for needle in ("box tree", "moov", "trak", "GPMF", "KLV tree",
                   "GYRO", "SCAL", "samples: 400", "200.00 Hz",
                   "strictly increasing: True", "finite: True"):
        assert needle in text, f"probe output missing {needle!r}:\n{text}"


def test_probe_reports_where_parsing_stopped(tmp_path):
    """A truncated MP4 must produce a diagnosis — where the box walk
    stopped and which parse raised — not a silent empty result."""
    from gpmf_fixture import write_gpmf_mp4

    n = 400
    g = np.zeros((n, 3))
    p = tmp_path / "clip.mp4"
    write_gpmf_mp4(str(p), g, rate_hz=200.0)
    trunc = tmp_path / "trunc.mp4"
    trunc.write_bytes(p.read_bytes()[:1000])
    ok, text = _probe_to_text(trunc)
    assert not ok
    assert "box walk stopped" in text
    assert "PARSE FAILED" in text
    assert "at " in text  # traceback frames locating the failure


def test_probe_gcsv_and_cli(tmp_path):
    """Text formats get a header dump; the CLI returns 0/1."""
    from rssync_tpu.frontend.probe import main

    p = tmp_path / "log.gcsv"
    p.write_text(
        "GYROFLOW IMU LOG\ntscale,0.001\ngscale,1\nascale,1\n"
        "t,gx,gy,gz\n"
        + "".join(f"{i},0.1,0.2,0.3\n" for i in range(100))
    )
    ok, text = _probe_to_text(p)
    assert ok
    assert "first" in text and "tscale" in text
    assert main(["--probe", str(p)]) == 0
    bad = tmp_path / "junk.gcsv"
    bad.write_text("hello\nworld\n")
    assert main(["--probe", str(bad)]) == 1
