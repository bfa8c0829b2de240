"""Tracking tests: LK vs known shifts, LK vs cv2 DIS on rendered
frames, and the fused undistort/RS-timestamp/ray stage."""

import numpy as np
import jax.numpy as jnp
import pytest

from rssync_tpu.frontend import tracking
from rssync_tpu.ops import lens as lens_ops


def _texture_image(rng, h, w):
    """Natural-ish (1/f-spectrum, non-periodic) random texture:
    multi-scale sum of smoothed white noise. Periodic textures (e.g.
    sinusoid sums) make coarse pyramid levels alias onto the wrong
    lobe, which is a texture pathology, not a tracker property."""
    from scipy.ndimage import gaussian_filter

    img = np.zeros((h, w))
    for sigma, amp in [(1.5, 1.0), (4.0, 2.0), (12.0, 4.0), (32.0, 8.0)]:
        img += amp * gaussian_filter(rng.normal(size=(h, w)), sigma)
    img -= img.min()
    img *= 255.0 / img.max()
    return img


def test_lk_recovers_known_translation(rng):
    img = _texture_image(rng, 240, 320)
    shift = np.array([6.3, -3.7])
    # features move by +shift: img_b[p] = img_a[p - shift]
    from scipy.ndimage import shift as nd_shift

    img_b = nd_shift(img, (shift[1], shift[0]), order=1, mode="nearest")
    pts = tracking.grid_points(320, 240, 60)
    tracked = np.asarray(
        tracking.lk_track(jnp.asarray(img), jnp.asarray(img_b), jnp.asarray(pts, jnp.float32))
    )
    flow = tracked - pts
    # interior points (window fully inside)
    inner = (
        (pts[:, 0] > 40) & (pts[:, 0] < 280) & (pts[:, 1] > 40) & (pts[:, 1] < 200)
    )
    err = np.linalg.norm(flow[inner] - shift, axis=1)
    assert np.median(err) < 0.1
    assert err.max() < 0.5


def test_lk_large_motion_via_pyramid(rng):
    img = _texture_image(rng, 480, 640)
    shift = np.array([55.0, 38.0])
    from scipy.ndimage import shift as nd_shift

    img_b = nd_shift(img, (shift[1], shift[0]), order=1, mode="nearest")
    pts = np.asarray([[320.0, 240.0], [200.0, 200.0], [400.0, 300.0]])
    tracked = np.asarray(
        tracking.lk_track(jnp.asarray(img), jnp.asarray(img_b), jnp.asarray(pts, jnp.float32))
    )
    err = np.linalg.norm(tracked - pts - shift, axis=1)
    assert err.max() < 0.5


def test_lk_matches_cv2_dis_on_rotation(rng):
    """Rotate a texture slightly; LK and DIS should agree on the grid."""
    import cv2

    img = _texture_image(rng, 360, 480).astype(np.uint8)
    M = cv2.getRotationMatrix2D((240, 180), 1.2, 1.0)  # 1.2 degrees
    img_b = cv2.warpAffine(img, M, (480, 360))
    pts = tracking.grid_points(480, 360, 80)
    tracked = np.asarray(
        tracking.lk_track(
            jnp.asarray(img.astype(np.float32)),
            jnp.asarray(img_b.astype(np.float32)),
            jnp.asarray(pts, jnp.float32),
        )
    )
    dis = cv2.DISOpticalFlow.create()
    flow = dis.calc(img, img_b, None)
    ij = pts.astype(int)
    dis_tracked = pts + flow[ij[:, 1], ij[:, 0]]
    inner = (
        (pts[:, 0] > 80) & (pts[:, 0] < 400) & (pts[:, 1] > 80) & (pts[:, 1] < 280)
    )
    err = np.linalg.norm(tracked[inner] - dis_tracked[inner], axis=1)
    assert np.median(err) < 0.3


def test_static_grid_path_matches_dynamic(rng):
    """lk_track_video with pts=None (static-grid gather-free template
    extraction) must match the dynamic-pts path exactly."""
    import jax.numpy as jnp

    frames = np.stack(
        [_texture_image(rng, 240, 320) for _ in range(4)]
    ).astype(np.float32)
    step = 60
    pts = tracking.grid_points(320, 240, step)
    dyn = np.asarray(
        tracking.lk_track_video(jnp.asarray(frames), jnp.asarray(pts, jnp.float32))
    )
    sta = np.asarray(
        tracking.lk_track_video(jnp.asarray(frames), grid_step=step)
    )
    np.testing.assert_array_equal(dyn, sta)


def test_grid_points_matches_reference_order():
    pts = tracking.grid_points(640, 480, 200)
    # x-major from (200,200): (200,200),(200,400),(400,200),(400,400),(600,...)
    expect = [[200, 200], [200, 400], [400, 200], [400, 400], [600, 200], [600, 400]]
    np.testing.assert_array_equal(pts, expect)


def test_rolling_shutter_ts_uses_tracked_row():
    lens = lens_ops.Lens(ro=0.01, fx=500, fy=500, cx=320, cy=240)
    pts_a = np.array([[100.0, 0.0], [100.0, 480.0]])
    pts_b = np.array([[100.0, 240.0], [100.0, 0.0]])
    ts_a, ts_b = tracking.rolling_shutter_ts(lens, pts_a, pts_b, 1.0, 1.1, 480)
    np.testing.assert_allclose(ts_a, [1.0, 1.01])
    np.testing.assert_allclose(ts_b, [1.1 + 0.005, 1.1])


def test_lift_rays_unit_and_match_lens(rng):
    lens = lens_ops.Lens(ro=0.01, fx=500, fy=500, cx=320, cy=240, k1=0.02)
    pts = jnp.asarray(rng.uniform(50, 400, size=(20, 2)), jnp.float32)
    ra, rb = tracking.lift_rays(lens, pts, pts + 1.5)
    ra = np.asarray(ra)
    np.testing.assert_allclose(np.linalg.norm(ra, axis=1), 1.0, atol=1e-6)
    und = np.asarray(lens_ops.undistort_points(lens, pts))
    np.testing.assert_allclose(ra[:, 0] / ra[:, 2], und[:, 0], atol=1e-5)


def test_static_template_extraction_matches_dynamic(rng):
    """_extract_patches_static == _extract_patches at integer origins,
    including origins whose patch runs off the bottom edge (the
    level-2 bottom grid row at 2.7k does)."""
    from rssync_tpu.frontend.tracking import (
        _extract_patches,
        _extract_patches_static,
        _pad_lanes,
    )

    H, W, size = 120, 256, 15
    imgs = _pad_lanes(jnp.asarray(
        rng.integers(0, 255, (2, H, W)), jnp.uint8))
    origins = np.asarray(
        [[3, 0], [40, 57], [200, 110], [200, 112], [10, 105]], np.float64
    )  # last three run off the bottom (110+15, 112+15, 105+15 > 120)
    a = np.asarray(_extract_patches_static(imgs, origins, size))
    o = jnp.broadcast_to(
        jnp.asarray(origins, jnp.float32)[None], (2, len(origins), 2))
    b = np.asarray(_extract_patches(imgs, o, size))
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_strip_fetch_gating_and_values(rng):
    """The strip fetch keeps the image dtype, reads the same values as
    the per-row-clamped row-block gather (also from a full clip through
    per-pair frame indices), and is gated off for frames too small for
    a whole strip and for dtypes other than u8 and f32."""
    from rssync_tpu.frontend.tracking import (
        LANE,
        STRIP_ROWS,
        _gather_blocks,
        _gather_strips,
        _pad_lanes,
        _strip_path_ok,
    )

    H, W, B, N = 96, 300, 3, 17
    imgs = _pad_lanes(
        jnp.asarray(rng.integers(0, 255, (B, H, W)), jnp.uint8))
    NB = imgs.shape[-1] // LANE
    oyq = jnp.asarray(
        rng.integers(0, (H - STRIP_ROWS) // 8 + 1, (B, N)), jnp.int32)
    obx = jnp.asarray(rng.integers(0, NB - 1, (B, N)), jnp.int32)
    a = np.asarray(_gather_strips(imgs, oyq, obx))
    b = np.asarray(_gather_blocks(imgs, oyq * 8, obx, STRIP_ROWS))
    assert a.dtype == np.uint8
    assert a.shape == (B, N, STRIP_ROWS, 2 * LANE)
    np.testing.assert_array_equal(a.astype(np.float32), b)
    fidx = jnp.asarray([2, 0, 2], jnp.int32)
    c = np.asarray(_gather_strips(imgs, oyq, obx, fidx=fidx))
    np.testing.assert_array_equal(
        c, np.asarray(_gather_strips(imgs[fidx], oyq, obx)))

    assert _strip_path_ok(imgs)
    assert _strip_path_ok(imgs.astype(jnp.float32))
    assert not _strip_path_ok(imgs.astype(jnp.int16))
    assert not _strip_path_ok(imgs[:, : STRIP_ROWS - 1])
    assert not _strip_path_ok(imgs[:, :, : 2 * LANE - 1])


def test_strip_path_matches_legacy_gather_path(rng):
    """Full-tracker equivalence: the strip-fetch search path (row
    residual folded into taps) tracks identically to the legacy
    per-row-clamped gather path on frames big enough for both —
    including points whose search windows overhang the frame TOP
    (ADVICE r3: the old roff lower clip shifted those windows
    in-bounds instead of edge-replicating, diverging up to ~1.9 px;
    _tap2's position clamp now replicates exactly like the legacy
    per-row clamp)."""
    from rssync_tpu.frontend import tracking as T

    H, W = 160, 384
    frames = jnp.asarray(rng.integers(0, 255, (3, H, W)), jnp.uint8)
    pts = np.asarray(
        [[60.0, 40.0], [200.0, 80.0], [300.0, 120.0], [120.0, 130.0],
         [64.0, 2.0], [180.0, 5.0], [256.0, 0.0]])  # last 3: top edge
    base = np.asarray(T.lk_track_video(frames, pts))

    orig = T._strip_path_ok
    try:
        T._strip_path_ok = lambda img: False
        T._lk_track_video_jit.clear_cache()
        legacy = np.asarray(T.lk_track_video(frames, pts))
    finally:
        T._strip_path_ok = orig
        T._lk_track_video_jit.clear_cache()
    np.testing.assert_allclose(base, legacy, atol=2e-3)


def test_padded_pyramid_matches_pad_after_build(rng):
    """build_pyramid_sparse with storage padding folded into the
    weights (_down_mat_stored) must equal building unpadded and
    edge-padding afterwards — exactly, for u8 (one-hot/banded weights
    and u8 pixels are exact in bf16)."""
    from rssync_tpu.frontend.tracking import (
        _lvl_size,
        _pad_lanes,
        build_pyramid_sparse,
    )

    H, W, levels = 250, 333, 6
    need = [0, 2, 4, 5]
    fine = {0, 2}
    imgs = jnp.asarray(rng.integers(0, 255, (2, H, W)), jnp.uint8)

    plain = build_pyramid_sparse(imgs, levels, need)
    plan = {l: ("fine" if l in fine else "lane") for l in need}
    padded_src = _pad_lanes(imgs, True)
    folded = build_pyramid_sparse(padded_src, levels, need, (H, W), plan)

    for l in need:
        want = _pad_lanes(plain[l], l in fine)
        got = folded[l]
        assert got.shape == want.shape, l
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert got.shape[-2] >= _lvl_size(H, 0, l)


def test_prepadded_frames_match_device_pad(rng):
    """pad_frames_host + logical_hw (host-side storage padding; skips
    the on-device u8 pad pass)
    must be bit-identical to the device-pad path for both the chunked
    and the per-block tracker entry points."""
    from rssync_tpu.frontend import tracking as T

    H, W = 260, 400
    frames = rng.integers(0, 255, (9, H, W)).astype(np.uint8)
    fp = T.pad_frames_host(frames)
    assert fp.shape[1] % 8 == 0 and fp.shape[2] % 128 == 0
    # edge-replicated padding
    np.testing.assert_array_equal(fp[:, H:, :W], np.repeat(
        frames[:, -1:, :], fp.shape[1] - H, axis=1))
    np.testing.assert_array_equal(fp[:, :, W:], np.repeat(
        fp[:, :, W - 1 : W], fp.shape[2] - W, axis=2))

    a = np.asarray(T.lk_track_video(jnp.asarray(frames), grid_step=80))
    b = np.asarray(T.lk_track_video(
        jnp.asarray(fp), grid_step=80, logical_hw=(H, W)))
    np.testing.assert_array_equal(a, b)

    c = np.asarray(T.lk_track_video_chunked(
        jnp.asarray(frames), chunk=4, grid_step=80))
    d = np.asarray(T.lk_track_video_chunked(
        jnp.asarray(fp), chunk=4, grid_step=80, logical_hw=(H, W)))
    np.testing.assert_array_equal(c, d)
    np.testing.assert_array_equal(a, c)


def test_hybrid_chunked_matches_block(rng):
    """The hybrid chunk structure (per-frame passes — small-level
    pyramid + level-0 templates — hoisted out of the chunk loop,
    level-0 search reads at per-pair frame indices) must be
    bit-identical to the per-chunk block structure: the hoisted
    pyramid is per-frame math, templates read the same storage-padded
    frames, and the fidx strip fetch indexes the same rows the sliced
    block would hold."""
    from rssync_tpu.frontend import tracking as T

    H, W = 260, 400
    frames = rng.integers(0, 255, (9, H, W)).astype(np.uint8)
    a = np.asarray(T.lk_track_video_chunked(
        jnp.asarray(frames), chunk=4, grid_step=80, hybrid=False))
    b = np.asarray(T.lk_track_video_chunked(
        jnp.asarray(frames), chunk=4, grid_step=80, hybrid=True))
    np.testing.assert_array_equal(a, b)


def test_stack_pad_host_matches_stack_then_pad(rng):
    """The one-copy block assembly (stack_pad_host) must be
    bit-identical to the old stack -> concat-tail -> pad_frames_host
    construction, including the short-tail repeat and the
    corner-replication order of the edge pads."""
    from rssync_tpu.frontend.tracking import (
        LK_ITERS,
        LK_RADIUS,
        _fine_plan,
        _stored_dims,
        auto_levels,
        pad_frames_host,
        stack_pad_host,
    )

    H, W = 123, 201
    lv = auto_levels(H, W)
    fine0 = 0 in {l for l, *_ in _fine_plan(lv, LK_ITERS, LK_RADIUS)}
    Hp, Wp = _stored_dims(H, W, "fine" if fine0 else "lane")
    grays = [
        rng.integers(0, 255, (H, W)).astype(np.uint8) for _ in range(4)
    ]
    for n_total in (4, 7):
        old = np.stack(grays)
        if n_total > len(grays):
            old = np.concatenate(
                [old, np.repeat(old[-1:], n_total - len(grays), axis=0)]
            )
        old = pad_frames_host(old, lv)
        new = stack_pad_host(grays, n_total, H, W, Hp, Wp)
        assert new.shape == old.shape == (n_total, Hp, Wp)
        np.testing.assert_array_equal(old, new)


def test_staged_blocks_during_warm_match_blocking_order(tmp_path, rng,
                                                        monkeypatch):
    """While the tracker executable compiles, track_frames STAGES
    uploaded blocks instead of blocking each dispatch on the warm
    event (uploads would idle for the whole compile otherwise).
    Emitted track results must be bit-identical whether the warm
    finishes instantly (dispatch per block) or slowly (blocks
    accumulate in `staged`, then flush)."""
    cv2 = pytest.importorskip("cv2")
    import threading
    import time as _time

    H, W, T = 120, 160, 22
    path = str(tmp_path / "warm.mp4")
    wr = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (W, H), False
    )
    assert wr.isOpened()
    base = _texture_image(np.random.default_rng(3), H, W).astype(np.uint8)
    for t in range(T):
        wr.write(np.roll(base, t * 2, axis=1))
    wr.release()

    lens = lens_ops.Lens(ro=0.01, fx=100.0, fy=100.0, cx=W / 2, cy=H / 2)

    class Recorder:
        def __init__(self):
            self.calls = []

        def set_track_result(self, idx, ts_a, ts_b, rays_a, rays_b):
            self.calls.append((
                idx, np.array(ts_a), np.array(ts_b),
                np.array(rays_a), np.array(rays_b),
            ))

    orig = tracking.lk_track_video

    def run(slow_warm):
        rec = Recorder()
        if slow_warm:
            def delayed(*a, **k):
                if threading.current_thread().name == "tracker-warm":
                    _time.sleep(1.5)
                return orig(*a, **k)

            monkeypatch.setattr(tracking, "lk_track_video", delayed)
        else:
            monkeypatch.setattr(tracking, "lk_track_video", orig)
        tracking.track_frames(
            rec, lens, path, 0, T - 1, grid_step=40, block=4,
        )
        return rec.calls

    fast = run(slow_warm=False)
    # cap staged at 2 so the run also exercises the blocking
    # warmed.wait() inside the flush loop (staged full mid-compile)
    monkeypatch.setenv("RSSYNC_TRACK_MAX_STAGED", "2")
    slow = run(slow_warm=True)
    assert len(fast) == len(slow) == T - 1  # pairs for frames [0, T-1]
    for f, s in zip(fast, slow):
        assert f[0] == s[0]
        for a, b in zip(f[1:], s[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_decode_pool_matches_serial(tmp_path):
    """The multiprocess DecodePool must yield bit-identical frames,
    indices, and timestamps to a serial cv2 decode over the same
    window-scoped spans (the pool shards GOP-amortized chunks across
    decoder processes; tiny chunk/slot sizes here exercise the
    interleaving and ring backpressure)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    H, W, T = 120, 160, 40
    path = str(tmp_path / "pool.mp4")
    wr = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (W, H), False
    )
    assert wr.isOpened()
    base = rng.integers(0, 255, (H, W)).astype(np.uint8)
    for t in range(T):
        wr.write(np.roll(base, t * 3, axis=1))
    wr.release()

    from rssync_tpu.frontend.decode_pool import DecodePool
    from rssync_tpu.frontend.tracking import VideoSource

    spans = [(2, 13), (20, 37)]
    src = VideoSource(path)
    serial = {}
    for b, e in spans:
        for fr in src.frames(b, e):
            serial[fr.index] = (fr.timestamp, fr.gray)
    src.cap.release()

    with DecodePool(
        path, spans, src.height, src.width, src._raw,
        n_workers=2, chunk=4, slots=3,
    ) as pool:
        got = 0
        for si in range(len(spans)):
            for idx, ts, gray in pool.span_frames(si):
                ref_ts, ref_gray = serial[idx]
                assert ts == ref_ts
                np.testing.assert_array_equal(gray, ref_gray)
                got += 1
    assert got == sum(e - b for b, e in spans)


def _stress_clip(tmp_path, T=96, H=96, W=128):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(11)
    path = str(tmp_path / "stress.mp4")
    wr = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (W, H), False
    )
    assert wr.isOpened()
    base = rng.integers(0, 255, (H, W)).astype(np.uint8)
    for t in range(T):
        wr.write(np.roll(base, t * 5, axis=1))
    wr.release()
    from rssync_tpu.frontend.tracking import VideoSource

    src = VideoSource(path)
    serial = {}
    for fr in src.frames(0, T):
        serial[fr.index] = (fr.timestamp, fr.gray)
    src.cap.release()
    return path, src, serial, T


@pytest.mark.slow
def test_decode_pool_four_worker_stress(tmp_path):
    """Real concurrency (the 1-core dev box only ever degraded to the
    decode-ahead thread before): 4 worker PROCESSES, a 2-slot ring,
    tiny chunks, randomized per-worker decode delays (fault-injected
    slow codec) and a deliberately slow consumer — exercising ring
    exhaustion, out-of-order worker completion, and consumer
    backpressure at once. Output must stay bit-identical and
    in order."""
    import time

    from rssync_tpu.frontend.decode_pool import DecodePool

    path, src, serial, T = _stress_clip(tmp_path)
    spans = [(0, 41), (50, T)]
    with DecodePool(
        path, spans, src.height, src.width, src._raw,
        n_workers=4, chunk=3, slots=2, worker_delay_s=0.004,
    ) as pool:
        got = 0
        for si in range(len(spans)):
            for idx, ts, gray in pool.span_frames(si):
                ref_ts, ref_gray = serial[idx]
                assert ts == ref_ts
                np.testing.assert_array_equal(gray, ref_gray)
                if got % 16 == 0:
                    time.sleep(0.05)  # slow consumer: force ring-full
                got += 1
    assert got == sum(e - b for b, e in spans)


@pytest.mark.slow
def test_decode_pool_worker_death_raises(tmp_path):
    """A killed worker must surface as a RuntimeError at the consumer,
    never an indefinite hang (the pre-fix _next_frame blocked forever
    on the silent queue)."""
    from rssync_tpu.frontend.decode_pool import DecodePool

    path, src, serial, T = _stress_clip(tmp_path)
    with DecodePool(
        path, [(0, T)], src.height, src.width, src._raw,
        n_workers=3, chunk=4, slots=2, worker_delay_s=0.02,
    ) as pool:
        it = pool.span_frames(0)
        next(it)  # pool is live
        victim = pool._procs[1]
        victim.terminate()
        victim.join(timeout=10.0)
        with pytest.raises(RuntimeError, match="died|failed|early"):
            for _ in it:
                pass


@pytest.mark.slow
def test_probe_workers_measures(tmp_path):
    """probe_workers must pick a candidate by measured burst
    throughput and cache it; with an injected advantage for 1 worker
    impossible to fake, the chosen count must still decode the whole
    clip correctly through _range_feeds."""
    from rssync_tpu.frontend import decode_pool as dp

    path, src, serial, T = _stress_clip(tmp_path)
    dp._PROBE_CACHE.clear()
    k = dp.probe_workers(
        path, src.height, src.width, src._raw, max_frames=T,
        burst=24, candidates=[1, 2, 4],
    )
    assert k in (1, 2, 4)
    # cached: identical second call, no re-measurement
    assert dp.probe_workers(
        path, src.height, src.width, src._raw, max_frames=T,
        burst=24, candidates=[1, 2, 4],
    ) == k
    # too few frames to amortize: falls back to the heuristic
    assert dp.probe_workers(
        path, src.height, src.width, src._raw, max_frames=4
    ) == dp.available_workers(None)
