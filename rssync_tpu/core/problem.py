"""Device-resident sync-problem tensors and the epipolar residual builder.

JAX rebuild of `OptData`/`FrameData` + `opt_compute_problem`
(ref: src/core/core_private.hpp:8-22, core_private.cpp:15-32).

The reference stores per-frame ragged ray matrices in a hash map and
loops over features; here a sync window is one padded, fixed-shape
pytree of arrays (frames x features) so the whole window — and a whole
batch of windows — is a single XLA computation.

Two load-bearing layout decisions:

1. **Timestamp precision**: instead of the reference's
   `at = (ts - quats_start + delay) * sample_rate` in f64
   (core_private.cpp:18-19), spline positions are pre-split on the
   host into an int32 base index `i0` (exact) plus an f32 fraction
   `f0`; the device evaluates at `i0 + (f0 + delay * sample_rate)` so
   only small numbers ever live in f32 (see ops/spline.py).

2. **Structure-of-arrays**: rays, quaternions and residual rows keep
   their small structure axis (3 or 4) LEADING and the big
   (frames, features) axes trailing, so that the minor dimension of
   every hot-path tensor is a long one (features or frames) and never
   a size-3/4 axis that a tiled layout would pad many times over. All
   hot-path tensors here are 2-D+ with batch dims minor.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from rssync_tpu.ops.spline import fit_natural_cubic, pack_table


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SplineTable:
    """Fitted gyro-orientation spline, device side.

    coeffs: (16, n_knots) packed per ops/spline.py::pack_table — rows
    4c + r = coefficient c (y, b, c, d) of quaternion row r (w,x,y,z),
    knots along the last axis (gather-friendly).
    coeffs_padded: (16, n_knots + 2*WIDE_PAD) — the same table with
    WIDE_PAD edge-replicated columns on both ends, so wide-band slices
    never clamp (replication reproduces the clamped-gather boundary
    semantics exactly; the quadratic extrapolation branches key on the
    unclamped index).
    sample_rate: () f32 — knots per second.
    """

    coeffs: jnp.ndarray
    coeffs_padded: jnp.ndarray
    sample_rate: jnp.ndarray

    @property
    def n_knots(self) -> int:
        return self.coeffs.shape[-1]


#: maximum knot-band width for the per-frame spline slice (see
#: compute_problem): covers rolling-shutter spans up to BAND-4 knots,
#: i.e. readout_time * gyro_rate <= 12 (a GoPro at 200 Hz uses ~2.2).
#: Each window carries its own (static) EXACT band width span+3: the
#: eval position is idx - band_start = (i0 - base) +
#: (floor(f0 + shift) - floor(shift)) + 1 with i0 - base in [0, span]
#: and the floor term in {0, 1} (f0 in [0, 1], incl. the f32-rounded
#: endpoint), so rel spans [1, span + 2] and span+3 knots always
#: cover it; boundary clamps only shrink rel. The band width sets the
#: dominant select cost of the banded eval (exact band: 5 at the GoPro
#: operating point, bitwise-identical costs to wider bands)
BAND = 16

#: wide-band machinery (see make_wide_bands): per-frame WIDE-knot slabs
#: extracted ONCE per engine call; each delay then takes a single
#: BAND-wide sub-slice at a frame-independent offset. Valid while
#: |delay - center| * sample_rate <= WIDE_SMAX.
WIDE = 128
WIDE_PAD = 128  # edge-replicated columns padded onto each table end
WIDE_SMAX = (WIDE - BAND - 6) // 2  # 53 knots of delay swing (band=16)


def wide_smax(band: int) -> int:
    """Delay swing (knots) the wide slabs cover for a given banded
    width. `WIDE_SMAX` is the band=16 (most conservative) value —
    callers checking feasibility before windows exist use that."""
    return (WIDE - band - 6) // 2


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TrackWindow:
    """One sync window: padded (F frames x N features) track tensors.

    rays_a/rays_b: (3, F, N) unit observation rays (xyz leading).
    i0_a/i0_b:     (F, N) int32 spline base index at delay = 0.
    f0_a/f0_b:     (F, N) f32 fractional spline position at delay = 0.
    base_a/base_b: (F,) int32 per-frame minimum of i0 (band origin for
                   the gather-free banded spline eval).
    feat_mask:     (F, N) f32 1.0 for valid features else 0.0.
    frame_mask:    (F,)  f32 1.0 for valid frames else 0.0.
    counts:        (F,)  int32 number of valid features per frame.
    """

    rays_a: jnp.ndarray
    rays_b: jnp.ndarray
    i0_a: jnp.ndarray
    i0_b: jnp.ndarray
    f0_a: jnp.ndarray
    f0_b: jnp.ndarray
    base_a: jnp.ndarray
    base_b: jnp.ndarray
    feat_mask: jnp.ndarray
    frame_mask: jnp.ndarray
    counts: jnp.ndarray
    #: static (compile-time) banded-eval width: the exact per-window
    #: minimum span+3 (see the BAND note above)
    band: int = dataclasses.field(
        default=BAND, metadata=dict(static=True)
    )

    @property
    def num_frames(self) -> int:
        return self.i0_a.shape[-2]

    @property
    def num_features(self) -> int:
        return self.i0_a.shape[-1]


def make_spline_table(
    quats: np.ndarray, sample_rate: float, dtype=jnp.float32
) -> SplineTable:
    """Fit the orientation spline on host (f64) and ship packed f32
    coefficients. quats: (n, 4) wxyz samples on a uniform grid.
    Equivalent of ndspline::make over the 4 rows (ref: ndspline.cpp:13-19).
    """
    quats = np.asarray(quats, dtype=np.float64)
    coeffs = fit_natural_cubic(quats.T)  # (n, 4, 4)
    packed = pack_table(coeffs)  # (16, n)
    padded = np.concatenate(
        [
            np.repeat(packed[:, :1], WIDE_PAD, axis=1),
            packed,
            np.repeat(packed[:, -1:], WIDE_PAD, axis=1),
        ],
        axis=1,
    )
    return SplineTable(
        coeffs=jnp.asarray(packed, dtype=dtype),
        coeffs_padded=jnp.asarray(padded, dtype=dtype),
        sample_rate=jnp.asarray(sample_rate, dtype=dtype),
    )


def make_spline_tables_batched(
    quats: np.ndarray, sample_rate: float, dtype=jnp.float32
) -> SplineTable:
    """Fit V spline tables at once: quats (V, n, 4) on one uniform
    grid -> SplineTable with a leading V axis on every leaf (vmap-able;
    guess-orient fits its 48 orientation variants in one Thomas solve
    over 4V rows)."""
    quats = np.asarray(quats, np.float64)
    V, n, R = quats.shape
    rows = quats.transpose(0, 2, 1).reshape(V * R, n)
    coeffs = fit_natural_cubic(rows)  # (n, V*R, 4)
    # pack per variant: row c*R + r holds coefficient c of spline row r
    packed = np.ascontiguousarray(
        coeffs.reshape(n, V, R, 4).transpose(1, 3, 2, 0).reshape(V, 4 * R, n)
    )
    padded = np.concatenate(
        [
            np.repeat(packed[..., :1], WIDE_PAD, axis=-1),
            packed,
            np.repeat(packed[..., -1:], WIDE_PAD, axis=-1),
        ],
        axis=-1,
    )
    rate = np.full((V,), sample_rate)
    return SplineTable(
        coeffs=jnp.asarray(packed, dtype=dtype),
        coeffs_padded=jnp.asarray(padded, dtype=dtype),
        sample_rate=jnp.asarray(rate, dtype=dtype),
    )


def build_track_window(
    frames_ts_a: Sequence[np.ndarray],
    frames_ts_b: Sequence[np.ndarray],
    frames_rays_a: Sequence[np.ndarray],
    frames_rays_b: Sequence[np.ndarray],
    quats_start: float,
    sample_rate: float,
    max_frames: int | None = None,
    max_features: int | None = None,
    dtype=jnp.float32,
) -> TrackWindow:
    """Assemble padded window tensors from per-frame ragged track data.

    Host-side (numpy, f64 for the timestamp split). The i-th entries of
    the four sequences describe one frame's correspondences: timestamps
    in seconds (already rolling-shutter corrected per ray), rays as
    (n, 3) unit vectors.
    """
    F = len(frames_ts_a)
    Fp = max_frames or F
    N = max((len(t) for t in frames_ts_a), default=1)
    Np = max_features or max(N, 1)

    rays_a = np.zeros((3, Fp, Np), dtype=np.float64)
    rays_b = np.zeros((3, Fp, Np), dtype=np.float64)
    i0_a = np.zeros((Fp, Np), dtype=np.int32)
    i0_b = np.zeros((Fp, Np), dtype=np.int32)
    f0_a = np.zeros((Fp, Np), dtype=np.float64)
    f0_b = np.zeros((Fp, Np), dtype=np.float64)
    feat_mask = np.zeros((Fp, Np), dtype=np.float64)
    frame_mask = np.zeros((Fp,), dtype=np.float64)
    counts = np.zeros((Fp,), dtype=np.int32)

    base_a = np.zeros((Fp,), dtype=np.int32)
    base_b = np.zeros((Fp,), dtype=np.int32)

    span_max = 0
    for f in range(F):
        n = len(frames_ts_a[f])
        if n == 0:
            continue
        pos_a = (np.asarray(frames_ts_a[f], np.float64) - quats_start) * sample_rate
        pos_b = (np.asarray(frames_ts_b[f], np.float64) - quats_start) * sample_rate
        ia = np.floor(pos_a).astype(np.int32)
        ib = np.floor(pos_b).astype(np.int32)
        i0_a[f, :n] = ia
        i0_b[f, :n] = ib
        # pad slots inherit the frame minimum so banded eval offsets
        # stay in range for masked entries
        i0_a[f, n:] = ia.min()
        i0_b[f, n:] = ib.min()
        f0_a[f, :n] = pos_a - ia
        f0_b[f, :n] = pos_b - ib
        base_a[f] = ia.min()
        base_b[f] = ib.min()
        for name, span in (("a", ia.max() - ia.min()), ("b", ib.max() - ib.min())):
            if span + 4 > BAND:
                raise ValueError(
                    f"rolling-shutter knot span {span} of frame {f} side "
                    f"{name} exceeds the banded-eval width {BAND}; "
                    "readout_time * gyro_rate is unusually large"
                )
            span_max = max(span_max, int(span))
        rays_a[:, f, :n] = np.asarray(frames_rays_a[f], np.float64).T
        rays_b[:, f, :n] = np.asarray(frames_rays_b[f], np.float64).T
        feat_mask[f, :n] = 1.0
        frame_mask[f] = 1.0
        counts[f] = n

    return TrackWindow(
        rays_a=jnp.asarray(rays_a, dtype),
        rays_b=jnp.asarray(rays_b, dtype),
        i0_a=jnp.asarray(i0_a),
        i0_b=jnp.asarray(i0_b),
        f0_a=jnp.asarray(f0_a, dtype),
        f0_b=jnp.asarray(f0_b, dtype),
        base_a=jnp.asarray(base_a),
        base_b=jnp.asarray(base_b),
        feat_mask=jnp.asarray(feat_mask, dtype),
        frame_mask=jnp.asarray(frame_mask, dtype),
        counts=jnp.asarray(counts),
        band=span_max + 3,  # exact minimum (see BAND note); the
        #   span+4 > BAND check above already bounds it under BAND
    )


def _conj_rotate_soa(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """rotate_point(conj(q), v) in SoA: q (4, ...) wxyz (unit),
    v (3, ...) -> (3, ...).

    conj(q) = (w, -u); rotation of v by (w, -u):
      v' = v (w^2 - |u|^2) + 2 (-u) ((-u).v) + 2 w ((-u) x v)
         = v (w^2 - |u|^2) + 2 u (u.v) - 2 w (u x v)
    """
    w = q[0]
    ux, uy, uz = q[1], q[2], q[3]
    vx, vy, vz = v[0], v[1], v[2]
    uv = ux * vx + uy * vy + uz * vz
    s = w * w - (ux * ux + uy * uy + uz * uz)
    cx = uy * vz - uz * vy
    cy = uz * vx - ux * vz
    cz = ux * vy - uy * vx
    return jnp.stack(
        [
            vx * s + 2.0 * ux * uv - 2.0 * w * cx,
            vy * s + 2.0 * uy * uv - 2.0 * w * cy,
            vz * s + 2.0 * uz * uv - 2.0 * w * cz,
        ]
    )


def cross_soa(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product over leading xyz axis: (3, ...) x (3, ...) -> (3, ...)."""
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def dot_soa(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dot over the leading structure axis: (C, ...) . (C, ...) -> (...)."""
    return jnp.sum(a * b, axis=0)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class WideBands:
    """Per-frame WIDE-knot coefficient slabs for one window, extracted
    once per engine call (see make_wide_bands)."""

    band_a: jnp.ndarray   # (F, 16, WIDE)
    band_b: jnp.ndarray
    start_a: jnp.ndarray  # (F,) slab origin in unpadded knot coords
    start_b: jnp.ndarray
    center_floor: jnp.ndarray  # () int32, floor(center_delay * rate)


def make_wide_bands(table: SplineTable, win: TrackWindow, center_delay) -> WideBands:
    """Extract per-frame coefficient slabs centered on `center_delay`.

    Rationale: the narrow banded eval re-slices a BAND-knot slab per
    (delay, frame) — at PreSync scale that is ~70k dynamic-slice ops
    per call at ~1.5 us each, the dominant cost. These slabs are wide
    enough for every delay within |delay - center| * rate <= WIDE_SMAX,
    so each delay evaluation needs only ONE slab sub-slice at a
    frame-independent offset. Slices come from the edge-padded table
    so per-frame starts never clamp (clamping would break the
    frame-independence of the offset).
    """
    cf = jnp.floor(center_delay * table.sample_rate).astype(jnp.int32)
    smax = wide_smax(win.band)

    def side(base):
        start_p = base + WIDE_PAD - 1 - smax + cf  # padded coords
        band = jax.vmap(
            lambda s: jax.lax.dynamic_slice(
                table.coeffs_padded, (0, s), (16, WIDE)
            )
        )(start_p)
        return band, start_p - WIDE_PAD  # origin in unpadded coords

    band_a, start_a = side(win.base_a)
    band_b, start_b = side(win.base_b)
    return WideBands(band_a, band_b, start_a, start_b, cf)


def _select_and_horner(sub, sub_start, xi, h_in, n):
    """Shared banded-eval core: per-ray coefficient select from a
    (F, 16, band) slab + Horner + boundary branches.

    Each ray selects its 16 coefficients with fused elementwise
    compares (band x 16 FMAs, no per-element gathers — the window's
    static `band` width sets this dominant cost). Boundary semantics identical to
    ops.spline.eval_spline_packed."""
    band = sub.shape[-1]
    idx = jnp.clip(xi, 0, n - 1)
    rel = jnp.clip(idx - sub_start[..., None], 0, band - 1)  # (F, N)
    coefs = []
    for c in range(16):
        acc = jnp.zeros_like(h_in)
        for j in range(band):
            acc = acc + jnp.where(rel == j, sub[:, c, j][..., None], 0.0)
        coefs.append(acc)
    yk = jnp.stack(coefs[0:4])
    bk = jnp.stack(coefs[4:8])
    ck = jnp.stack(coefs[8:12])
    dk = jnp.stack(coefs[12:16])

    below = xi < 0
    above = xi > n - 2
    h_lo = xi.astype(h_in.dtype) + h_in
    h_hi = (xi - (n - 1) - (xi >= n).astype(xi.dtype)).astype(
        h_in.dtype) + h_in  # ref quirk: idx=min(floor(x), n), so h
    #   measures from knot n (one past the end) once x >= n —
    #   discontinuous at x == n (minispline.cpp:49-53); replicated
    h = jnp.where(below, h_lo, jnp.where(above, h_hi, h_in))[None]
    cubic = ((dk * h + ck) * h + bk) * h + yk
    quad = (ck * h + bk) * h + yk
    return jnp.where((below | above)[None], quad, cubic)


def _banded_quats(
    coeffs: jnp.ndarray, i0: jnp.ndarray, f0: jnp.ndarray,
    base: jnp.ndarray, shift, band_w: int,
) -> jnp.ndarray:
    """Narrow banded eval (fallback when no WideBands are available,
    e.g. unbounded delay search): one band_w-knot dynamic_slice per
    frame per call. coeffs: (16, n); i0/f0: (F, N); base: (F,)
    per-frame min i0; shift: scalar delay * sample_rate.
    Returns (4, F, N) quat rows."""
    n = coeffs.shape[1]
    p = f0 + shift
    pf = jnp.floor(p)
    xi = i0 + pf.astype(jnp.int32)
    h_in = p - pf

    sfloor = jnp.floor(shift).astype(jnp.int32)
    band_start = jnp.clip(base + sfloor - 1, 0, n - band_w)  # (F,)
    band = jax.vmap(
        lambda s: jax.lax.dynamic_slice(coeffs, (0, s), (16, band_w))
    )(band_start)  # (F, 16, band_w)
    return _select_and_horner(band, band_start, xi, h_in, n)


def _wide_quats(
    table: SplineTable, bands_side, start_side, center_floor,
    i0, f0, shift, band_w: int,
) -> jnp.ndarray:
    """Wide-band eval: ONE sub-slice of the pre-extracted slabs per
    delay (frame-independent offset)."""
    n = table.n_knots
    F = bands_side.shape[0]
    p = f0 + shift
    pf = jnp.floor(p)
    xi = i0 + pf.astype(jnp.int32)
    h_in = p - pf

    sfloor = jnp.floor(shift).astype(jnp.int32)
    sub_off = jnp.clip(
        sfloor - center_floor + wide_smax(band_w), 0, WIDE - band_w
    )
    sub = jax.lax.dynamic_slice(
        bands_side, (0, 0, sub_off), (F, 16, band_w)
    )
    sub_start = start_side + sub_off  # (F,)
    return _select_and_horner(sub, sub_start, xi, h_in, n)


def compute_problem(
    table: SplineTable, win: TrackWindow, gyro_delay,
    bands: WideBands | None = None,
) -> jnp.ndarray:
    """Epipolar residual rows for every (frame, feature) at one delay.

    Returns P: (3, F, N) where column (f, i) = cross(ar, br) with
    ar = conj(q(t_a_i + delay)) rotating ray_a_i and likewise br — the
    pure-translation epipolar constraint rows satisfying P^T M ~= 0 at
    the correct delay (ref: src/core/core_private.cpp:15-32). Padded
    entries are zeroed.

    Fully batched and gather-free: banded spline eval (wide-band slabs
    when `bands` is given — callers must guarantee
    |delay - bands.center| * rate <= WIDE_SMAX), quaternion
    normalize/rotate as scalar-component elementwise math, one cross
    product.
    vmap-able over leading delay/window axes.
    """
    shift = gyro_delay * table.sample_rate
    if bands is None:
        q_a = _banded_quats(
            table.coeffs, win.i0_a, win.f0_a, win.base_a, shift, win.band
        )
        q_b = _banded_quats(
            table.coeffs, win.i0_b, win.f0_b, win.base_b, shift, win.band
        )
    else:
        q_a = _wide_quats(
            table, bands.band_a, bands.start_a, bands.center_floor,
            win.i0_a, win.f0_a, shift, win.band,
        )
        q_b = _wide_quats(
            table, bands.band_b, bands.start_b, bands.center_floor,
            win.i0_b, win.f0_b, shift, win.band,
        )
    q_a = q_a * jax.lax.rsqrt(jnp.maximum(dot_soa(q_a, q_a), 1e-30))
    q_b = q_b * jax.lax.rsqrt(jnp.maximum(dot_soa(q_b, q_b), 1e-30))
    ar = _conj_rotate_soa(q_a, win.rays_a)
    br = _conj_rotate_soa(q_b, win.rays_b)
    return cross_soa(ar, br) * win.feat_mask[None]


def problem_rows_aos(P: jnp.ndarray) -> jnp.ndarray:
    """(3, F, N) -> (F, N, 3) for tests/debug interop with the
    reference's row-major view. Not for hot paths (layout padding)."""
    return jnp.moveaxis(P, 0, -1)
