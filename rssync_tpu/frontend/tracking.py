"""Feature tracking front-end: host video decode + on-device feature
tracking of a fixed grid, with rolling-shutter timestamp assignment
and fisheye ray lifting.

Rebuild of `track_frames` (ref: src/core_testcode.cpp:97-162). The
reference runs OpenCV DIS dense optical flow per frame pair on the
host and samples it at a fixed grid (step 200 px starting at
(200, 200)); dense flow over 5.5 MPx is wildly more work than the
~130 tracked points need.

Design (v2):
  1. coarse motion, dense + global (no per-point work at all):
     a global-translation SAD argmin at a ~16 px pyramid level, then
     a (2D+1)^2 shifted-SAD cost volume at a ~64 px level — every op
     is a full-image shift/subtract/box-filter (elementwise) — with
     parabolic subpixel refinement; the flow field is bilinearly
     sampled at the feature grid by one small matmul.
  2. fine refinement: 2-3 finest pyramid levels of iterative
     Lucas-Kanade. All per-point windows are fetched with ONE
     jnp.take row-block gather per level (the image is viewed as
     (H*W/128, 128) lane blocks; a per-point window needs S rows x 2
     consecutive blocks), and every shifted/fractional window sample
     inside the iterations is two batched matmuls against 2-tap
     linear-interpolation matrices (the bilinear blend IS the
     matmul weights).

  Rationale: a per-point `dynamic_slice` lowers to one small gather
  per point; the row-block gather moves all points in one op, and the
  interpolation matmuls replace (2M+1) masked select-rounds per
  iteration. Neither choice has been timed on the H100 yet.

The host decode path and the downstream undistort + rolling-shutter
timestamping + unit-ray lifting are unchanged. A `method="dis"` path
(host cv2 DIS at the same grid) is kept for cross-validation against
the reference's tracker choice (SURVEY §7 step 6).
"""

from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Iterator, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from rssync_tpu.ops import lens as lens_ops

LK_RADIUS = 10  # 21x21 window
LK_ITERS = 10  # API default; v2 schedules fewer per level (see _fine_plan)

#: fine-level margins: the iterate may wander +-(margin-1) px from the
#: incoming guess within one level. The entry level's margin absorbs
#: the coarse-stage init error (<= ~0.7 px at the volume level).
MARGIN_ENTRY = 8
MARGIN_FINE = 3

#: local cost-volume search radius (px at the volume level)
VOL_D = 4
#: box-filter half-width for the volume SAD (5x5)
VOL_BOX = 2

LANE = 128

#: search-strip geometry: the strip fetch quantizes each window's top
#: row down to a multiple of 8 and copies STRIP_ROWS rows; the <=7-row
#: residual is folded into the sampling taps. 40 covers the largest
#: fine-level window (S=31) + residual.
STRIP_ROWS = 40
#: extra bottom rows on fine-level images (edge-replicated) so strips
#: for windows that overhang the bottom edge stay in-bounds, matching
#: the legacy per-row clamp for overhangs up to this depth
STRIP_PAD = 24

# NOTE: the tracker-warm gate is per-invocation (the `warm_gate`
# parameter of track_frames), created by the caller — a module-global
# Event stayed set across runs, letting a second run's engine warm
# jump the compile queue ahead of that run's tracker compiles (and
# cross-talked between concurrent pipelines).


def auto_levels(height: int, width: int) -> int:
    """Pyramid depth so the coarsest level is ~12-24 px across (the
    global-SAD stage runs there; capacity scales with depth)."""
    m = min(height, width)
    return max(1, int(math.floor(math.log2(m / 12))) + 1)


def auto_grid_step(width: int) -> int:
    """The reference hardcodes step=200 px for 2704-wide GoPro frames
    (ref: core_testcode.cpp:127); scale that density with resolution
    (exactly 200 at 2704) with a floor for small frames."""
    return max(40, round(200 * width / 2704))


def grid_points(width: int, height: int, step: int | None = None) -> np.ndarray:
    """The reference's sampling grid: x-major from (step, step)
    (ref: core_testcode.cpp:125-132)."""
    if step is None:
        step = auto_grid_step(width)
    pts = [
        [float(i), float(j)]
        for i in range(step, width, step)
        for j in range(step, height, step)
    ]
    return np.asarray(pts, np.float64)


# ---------------------------------------------------------------------------
# pyramid


def _blur5(img: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Separable 5-tap Gaussian [1 4 6 4 1]/16 with edge padding over
    one of the last two (spatial) axes; leading axes are batch."""
    ax = img.ndim - 2 + axis
    pad = [(0, 0)] * img.ndim
    pad[ax] = (2, 2)
    p = jnp.pad(img, pad, mode="edge")
    n = img.shape[ax]

    def sl(off):
        idx = [slice(None)] * img.ndim
        idx[ax] = slice(off, off + n)
        return p[tuple(idx)]

    return (sl(0) + 4.0 * sl(1) + 6.0 * sl(2) + 4.0 * sl(3) + sl(4)) / 16.0


def _avgpool2(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 average pool via reduce_window."""
    x = img.astype(jnp.float32)
    win = (1,) * (x.ndim - 2) + (2, 2)
    s = jax.lax.reduce_window(x, 0.0, jax.lax.add, win, win, "VALID")
    return s * 0.25


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """Gaussian blur + 2x decimation (anti-aliased pyramid level, like
    cv2.pyrDown). Plain 2x2 pooling aliases high-frequency texture and
    breaks coarse-level matching for large motions. Decimation via a
    1x1/stride-2 reduce_window (strided slices relayout poorly)."""
    img = _blur5(_blur5(img, 0), 1).astype(jnp.float32)
    win = (1,) * img.ndim
    st = (1,) * (img.ndim - 2) + (2, 2)
    return jax.lax.reduce_window(img, 0.0, jax.lax.add, win, st, "VALID")


def build_pyramid(img: jnp.ndarray, levels: int) -> list[jnp.ndarray]:
    """Image pyramid in the INPUT dtype (u8 from the decoder stays u8:
    4x fewer bytes than f32; deeper levels round back to u8). Level 1
    is a 2x2 average (the 5-tap blur at full res costs ~4x the rest of
    the pyramid; a box filter antialiases enough), deeper levels use
    the 5-tap Gaussian.

    This is the dense (every-level) builder, kept for API users and
    tests; the tracker itself uses `build_pyramid_sparse`, which only
    materializes the levels its schedule consumes."""
    store = img.dtype

    def cast(x):
        if jnp.issubdtype(store, jnp.integer):
            return jnp.clip(jnp.round(x), 0, 255).astype(store)
        return x.astype(store)

    pyr = [img]
    if levels > 1:
        pyr.append(cast(_avgpool2(img.astype(jnp.float32))))
    for _ in range(2, levels):
        pyr.append(cast(_downsample2(pyr[-1].astype(jnp.float32))))
    return pyr


def _pool_mat_np(n: int) -> np.ndarray:
    """(n//2, n) banded matrix of the 2x2 avgpool step along one axis
    (level 0 -> 1): rows average input elements 2r, 2r+1."""
    m = np.zeros((n // 2, n), np.float64)
    r = np.arange(n // 2)
    m[r, 2 * r] = 0.5
    m[r, 2 * r + 1] = 0.5
    return m


def _blurdec_mat_np(n: int) -> np.ndarray:
    """(ceil(n/2), n) banded matrix of one blur5+decimate step along
    one axis (levels >= 1): rows are the [1 4 6 4 1]/16 kernel
    centered at even input positions, edge-clamped — exactly
    `_downsample2`'s sampling (stride-2 VALID keeps ceil(n/2))."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0
    out = (n - 1) // 2 + 1
    m = np.zeros((out, n), np.float64)
    for r in range(out):
        for i in range(5):
            c = min(max(2 * r + i - 2, 0), n - 1)
            m[r, c] += k[i]
    return m


@lru_cache(maxsize=None)
def _down_mat(n: int, src_lvl: int, dst_lvl: int) -> np.ndarray:
    """Composed banded matrix taking a length-n level-`src_lvl` axis
    straight to level `dst_lvl` in ONE multiply (product of the
    per-level step matrices, composed on host in f64)."""
    m = None
    size = n
    for lvl in range(src_lvl, dst_lvl):
        step = _pool_mat_np(size) if lvl == 0 else _blurdec_mat_np(size)
        m = step if m is None else step @ m
        size = step.shape[0]
    return m.astype(np.float32)


def _lvl_size(n: int, src_lvl: int, dst_lvl: int) -> int:
    """Logical axis length after downsampling src_lvl -> dst_lvl."""
    for lvl in range(src_lvl, dst_lvl):
        n = n // 2 if lvl == 0 else (n - 1) // 2 + 1
    return n


@lru_cache(maxsize=None)
def _down_mat_stored(n: int, src_lvl: int, dst_lvl: int,
                     n_store: int, out_store: int) -> np.ndarray:
    """`_down_mat` with storage padding folded into the weights: zero
    columns for padded source entries (their values never contribute,
    exactly like computing from the unpadded level) and a replicated
    last row for edge-padded output entries (identical to
    edge-replicating after the multiply). Lets the pyramid emit
    already-padded levels with no separate jnp.pad passes."""
    m = _down_mat(n, src_lvl, dst_lvl)
    if n_store > n:
        m = np.pad(m, ((0, 0), (0, n_store - n)))
    if out_store > m.shape[0]:
        m = np.concatenate(
            [m, np.repeat(m[-1:], out_store - m.shape[0], axis=0)]
        )
    return m.astype(np.float32)


def _stored_dims(h: int, w: int, kind: str | None) -> tuple[int, int]:
    """Storage dims for a level: 'fine' = strip row pad + lane
    pad (matches _pad_lanes(img, True)); 'lane' = lane pad only;
    None = exact logical dims."""
    wp = -(-w // LANE) * LANE
    if kind == "fine":
        return -(-(h + STRIP_PAD) // 8) * 8, wp
    if kind == "lane":
        return h, wp
    return h, w


def _needed_levels(levels: int, iters: int, radius: int) -> list[int]:
    """The pyramid levels the tracker schedule actually consumes:
    the fine-plan levels plus the two coarse-init levels. On the 2.7k
    8-level operating point this is {0, 2, 5, 7} — half the pyramid
    (levels 1, 3, 4, 6) is pure intermediate and need never exist."""
    plan = _fine_plan(levels, iters, radius)
    need = {lvl for lvl, _it, _m, _r in plan}
    entry = plan[0][0]
    if levels > entry + 1:
        lvl_glob = levels - 1
        need |= {max(entry + 1, lvl_glob - 2), lvl_glob}
    return sorted(need)


def build_pyramid_sparse(
    img: jnp.ndarray, levels: int, need: list[int],
    logical_hw: tuple[int, int] | None = None,
    pad_plan: dict[int, str | None] | None = None,
) -> dict[int, jnp.ndarray]:
    """Needed-levels-only pyramid: each consumed level is computed
    from the PREVIOUS consumed level by two composed banded-matrix
    matmuls (rows then columns) — bf16 operands (u8 pixels are exact in
    bf16), f32 accumulation. The unconsumed intermediates are never
    built, and the downsample runs as matrix products instead of
    reduce_windows; the composed weights match the dense path's blur5/avgpool sampling
    exactly up to bf16 rounding of the band coefficients.

    With `logical_hw` (the unpadded level-0 dims; `img` may then carry
    storage padding) and `pad_plan` ({level: 'fine' | 'lane' | None},
    see _stored_dims), every level is emitted with its target storage
    padding folded into the downsample weights (_down_mat_stored) —
    zero separate pad passes, values identical to pad-after-build.

    Returns {level: (B, h_l, w_l) array} in the input dtype."""
    store = img.dtype
    H0, W0 = logical_hw if logical_hw is not None else img.shape[-2:]
    pad_plan = pad_plan or {}

    def cast(x):
        if jnp.issubdtype(store, jnp.integer):
            return jnp.clip(jnp.round(x), 0, 255).astype(store)
        return x.astype(store)

    pyr: dict[int, jnp.ndarray] = {}
    prev_lvl, prev = 0, img
    prev_hw = (H0, W0)
    for lvl in sorted(set(need)):
        if lvl == prev_lvl:
            pyr[lvl] = prev
        else:
            h, w = prev_hw
            hd = _lvl_size(h, prev_lvl, lvl)
            wd = _lvl_size(w, prev_lvl, lvl)
            hs, ws = _stored_dims(hd, wd, pad_plan.get(lvl))
            R = jnp.asarray(
                _down_mat_stored(h, prev_lvl, lvl, prev.shape[-2], hs),
                jnp.bfloat16,
            )
            C = jnp.asarray(
                _down_mat_stored(w, prev_lvl, lvl, prev.shape[-1], ws),
                jnp.bfloat16,
            )
            x = jnp.einsum(
                "rh,bhw,wc->brc", R, prev.astype(jnp.bfloat16), C.T,
                preferred_element_type=jnp.float32,
            )
            pyr[lvl] = cast(x)
            prev_hw = (hd, wd)
        prev_lvl, prev = lvl, pyr[lvl]
    return pyr


def _pad_lanes(img: jnp.ndarray, strip_rows: bool = False) -> jnp.ndarray:
    """Edge-pad width to a multiple of 128 so the image reshapes into
    (rows*blocks, 128) lane blocks for the row-block gather. With
    strip_rows=True (fine/search levels) additionally edge-pad the
    bottom by STRIP_PAD rows rounded up to the 8-row strip quantum, so
    window strips that overhang the bottom edge stay in-bounds for
    the strip fetch (same values as the legacy per-row clamp for
    overhangs up to STRIP_PAD)."""
    H, W = img.shape[-2], img.shape[-1]
    Wp = -(-W // LANE) * LANE
    Hp = -(-(H + STRIP_PAD) // 8) * 8 if strip_rows else H
    if Wp == W and Hp == H:
        return img
    cfg = [(0, 0)] * (img.ndim - 2) + [(0, Hp - H), (0, Wp - W)]
    return jnp.pad(img, cfg, mode="edge")


# ---------------------------------------------------------------------------
# batched window machinery (gather + interpolation matmuls)


def _gather_blocks(imgs: jnp.ndarray, oy: jnp.ndarray, obx: jnp.ndarray,
                   S: int, fidx: jnp.ndarray | None = None) -> jnp.ndarray:
    """Fetch S-row x 256-lane windows for every (pair, point) in ONE
    jnp.take.

    imgs: (B, H, Wp) with Wp % 128 == 0; oy: (B, N) int32 top row;
    obx: (B, N) int32 leftmost 128-lane block. Returns (B, N, S, 256)
    f32. Rows/blocks are clamped per-row (edge replication).
    fidx: optional (B,) int32 frame indices — imgs then holds the FULL
    clip (T, H, Wp) and row b reads frame fidx[b] (the hoisted chunked
    tracker reads per-chunk windows straight from full-clip arrays,
    no per-chunk frame copies)."""
    H, Wp = imgs.shape[-2:]
    NB = Wp // LANE
    src = imgs.reshape(imgs.shape[0] * H * NB, LANE)
    rows = jnp.clip(oy[..., None] + jnp.arange(S, dtype=jnp.int32), 0, H - 1)
    blk = jnp.clip(
        obx[..., None, None] + jnp.arange(2, dtype=jnp.int32), 0, NB - 1
    )  # (B, N, 1, 2)
    if fidx is None:
        fidx = jnp.arange(imgs.shape[0], dtype=jnp.int32)
    B = fidx.shape[0]
    base = fidx.astype(jnp.int32)[:, None, None] * H + rows  # (B, N, S)
    idx = base[..., None] * NB + blk  # (B, N, S, 2)
    out = jnp.take(src, idx.reshape(-1), axis=0)
    N = oy.shape[1]
    return out.reshape(B, N, S, 2 * LANE).astype(jnp.float32)


def _strip_path_ok(img: jnp.ndarray) -> bool:
    """Static predicate: the strip fetch handles this level (big enough
    for whole strips, u8 or f32). Small frames and exotic dtypes keep
    the legacy per-row-clamped gather."""
    return (
        img.shape[-2] >= STRIP_ROWS
        and img.shape[-1] >= 2 * LANE
        and img.dtype in (jnp.uint8, jnp.float32)
    )


def _gather_strips(imgs: jnp.ndarray, oyq: jnp.ndarray, obx: jnp.ndarray,
                   fidx: jnp.ndarray | None = None) -> jnp.ndarray:
    """(B, N, STRIP_ROWS, 256) strips at rows [8*oyq, 8*oyq+40), cols
    [128*obx, +256), in the image dtype: one row-block gather of
    128-byte rows, which XLA emits as a coalesced gather. Strips are
    pre-clamped in-bounds, so the per-row clip never engages."""
    with jax.named_scope("strip_fetch"):
        return _gather_blocks(
            imgs, oyq * 8, obx, STRIP_ROWS, fidx=fidx
        ).astype(imgs.dtype)


def _tap2(pos: jnp.ndarray, size: int, width: int,
          dtype=jnp.float32) -> jnp.ndarray:
    """2-tap linear-interpolation matrix: T[..., i, c] = max(0,
    1-|pos+i-c|), so T @ v samples v at fractional positions pos+i.
    Positions are clamped to [0, width-1], so out-of-range samples
    edge-replicate the buffer (identical weights for in-range
    positions) — this is what lets the strip path's roff/rem go
    negative for windows overhanging the frame top/left and still
    match the legacy per-row-clamp gather. pos: (...,) f32. Returns
    (..., size, width)."""
    p = pos[..., None, None] + jnp.arange(size, dtype=jnp.float32)[:, None]
    p = jnp.clip(p, 0.0, float(width - 1))
    c = jnp.arange(width, dtype=jnp.float32)
    return jnp.maximum(0.0, 1.0 - jnp.abs(p - c)).astype(dtype)


def _bmm(a: jnp.ndarray, b: jnp.ndarray, contract: tuple[int, int],
         precision=None) -> jnp.ndarray:
    """Batched matmul over the two leading (B, N) dims."""
    nb = a.ndim - 2
    return jax.lax.dot_general(
        a, b,
        (((contract[0] + nb,), (contract[1] + nb,)),
         (tuple(range(nb)), tuple(range(nb)))),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def _sample_windows(wide: jnp.ndarray, fy: jnp.ndarray, fx: jnp.ndarray,
                    rows: int, cols: int, precision=None) -> jnp.ndarray:
    """Bilinear windows from gathered blocks: wide (B, N, S, 256),
    fy/fx (B, N) fractional offsets of the window origin inside the
    gathered region. Returns (B, N, rows, cols)."""
    Ry = _tap2(fy, rows, wide.shape[2])
    Cx = _tap2(fx, cols, wide.shape[3])
    part = _bmm(Ry, wide, (1, 0), precision)  # (B, N, rows, 256)
    return _bmm(part, Cx, (1, 1), precision)  # (B, N, rows, cols)


def _extract_patches(imgs: jnp.ndarray, pts: jnp.ndarray, size: int,
                     precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """(B, N, size, size) f32 bilinear patches with top-left corner at
    `pts` (fractional xy, per pair). imgs: (B, H, Wp) lane-padded."""
    base = jnp.floor(pts)
    frac = (pts - base).astype(jnp.float32)
    oy = base[..., 1].astype(jnp.int32)
    ox = base[..., 0].astype(jnp.int32)
    # block clamp + possibly-negative remainder: left-edge overhangs
    # edge-replicate through the clamped taps (see _lk_level)
    obx = jnp.clip(ox // LANE, 0, max(imgs.shape[-1] // LANE - 2, 0))
    rem = (ox - obx * LANE).astype(jnp.float32)
    wide = _gather_blocks(imgs, oy, obx, size + 1)
    return _sample_windows(
        wide, frac[..., 1], rem + frac[..., 0], size, size, precision
    )


def _extract_patches_static(imgs: jnp.ndarray, origins: np.ndarray,
                            size: int) -> jnp.ndarray:
    """(B, N, size, size) f32 patches at compile-time-constant INTEGER
    origins — no gather and no per-iteration interpolation matmuls.
    The tracker's template origins are grid points minus an integer
    offset, so on the fixed-grid path this replaces `_extract_patches`
    exactly (integer origins make its bilinear taps one-hot).

    Rectangular grids (the reference grid: every distinct y paired
    with the same x set) take the strip+matmul path: one contiguous
    (B, size, W) row strip per distinct y, then a single constant
    one-hot column-selector matmul lifts all x windows of all strips
    at once (u8 pixels and one-hot weights are exact in bf16, f32
    accumulation), and a static permutation restores point order.
    Replaces N per-point slice+stack ops and their op overhead.
    Irregular origin sets keep the per-point slice path. Out-of-range
    columns/rows are edge-replicated like the dynamic path's clamp."""
    H, W = imgs.shape[-2], imgs.shape[-1]
    xs = origins[:, 0].astype(int)
    ys = origins[:, 1].astype(int)
    uy, iy_of = np.unique(ys, return_inverse=True)
    ux, ix_of = np.unique(xs, return_inverse=True)

    def strip_for(y):
        y0, y1 = max(0, min(y, H)), max(0, min(y + size, H))
        strip = imgs[:, y0:y1, :]
        if (y0 - y) or (y + size - y1):  # edge-replicate, like the
            strip = jnp.pad(             # dynamic path's row clamp
                strip, ((0, 0), (y0 - y, y + size - y1), (0, 0)),
                mode="edge",
            )
        return strip

    rectangular = len(xs) == len(uy) * len(ux) and len(
        {(int(x), int(y)) for x, y in zip(xs, ys)}
    ) == len(xs)
    if rectangular:
        strips = jnp.stack([strip_for(y) for y in uy], axis=1)
        # (B, n_y, size, W) -> all x windows in one one-hot matmul
        cols = np.clip(
            ux[:, None] + np.arange(size)[None, :], 0, W - 1
        ).ravel()  # (n_x*size,) selected source columns
        sel = np.zeros((W, len(cols)), np.float32)
        sel[cols, np.arange(len(cols))] = 1.0
        if imgs.dtype == jnp.uint8:  # u8 exact in one bf16 pass
            lhs, rhs = strips.astype(jnp.bfloat16), jnp.asarray(
                sel, jnp.bfloat16)
            prec = None
        else:  # float pixels: 6-pass HIGHEST keeps the select exact
            lhs, rhs = strips.astype(jnp.float32), jnp.asarray(sel)
            prec = jax.lax.Precision.HIGHEST
        out = jnp.einsum(
            "bysw,wq->bysq", lhs, rhs,
            preferred_element_type=jnp.float32,
            precision=prec,
        ).reshape(imgs.shape[0], len(uy), size, len(ux), size)
        # (B, yi, r, xj, c) -> (B, N, r, c) in caller point order
        flat = out.transpose(0, 1, 3, 2, 4).reshape(
            imgs.shape[0], len(uy) * len(ux), size, size
        )
        perm = iy_of * len(ux) + ix_of  # point n -> (yi, xj) slot
        return jnp.take(flat, jnp.asarray(perm), axis=1)

    out: list = [None] * len(xs)
    for y in uy:
        strip = strip_for(y)
        for i in np.nonzero(ys == y)[0]:
            x = xs[i]
            x0, x1 = max(0, x), min(W, x + size)
            p = strip[:, :, x0:x1]
            if (x0 - x) or (x + size - x1):
                p = jnp.pad(
                    p, ((0, 0), (0, 0), (x0 - x, x + size - x1)),
                    mode="edge",
                )
            out[i] = p
    return jnp.stack(out, axis=1).astype(jnp.float32)


def _lk_templates(img_a, pts_level, radius: int):
    """Template patches + gradients + Gauss-Newton normal-matrix terms
    for every frame in img_a at pts_level — the img_a half of an LK
    level, split out so the hoisted chunked tracker can compute it
    ONCE for the whole clip (per-chunk work then only touches img_b).

    img_a: (B, H, Wp) lane-padded level images. pts_level: (N, 2) or
    (B, N, 2); a host np.ndarray of integers takes the static-template
    fast path. Returns a dict of (B, N, ...) arrays."""
    w = 2 * radius + 1
    B = img_a.shape[0]
    static_grid = (
        isinstance(pts_level, np.ndarray)
        and pts_level.ndim == 2
        and np.all(pts_level == np.round(pts_level))
    )
    if static_grid:
        patch_a = _extract_patches_static(
            img_a, pts_level - (radius + 1), w + 2
        )  # (B, N, w+2, w+2)
    else:
        p = jnp.asarray(pts_level, jnp.float32)
        if p.ndim == 2:
            p = jnp.broadcast_to(p[None], (B, *p.shape))
        # template patch (w+2)^2 for central-difference gradients
        patch_a = _extract_patches(
            img_a, p - (radius + 1), w + 2,
            precision=jax.lax.Precision.HIGHEST,
        )
    ix = 0.5 * (patch_a[..., 1:-1, 2:] - patch_a[..., 1:-1, :-2])
    iy = 0.5 * (patch_a[..., 2:, 1:-1] - patch_a[..., :-2, 1:-1])
    t = patch_a[..., 1:-1, 1:-1]
    gxx = jnp.sum(ix * ix, axis=(-2, -1))
    gxy = jnp.sum(ix * iy, axis=(-2, -1))
    gyy = jnp.sum(iy * iy, axis=(-2, -1))
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-6
    det_safe = jnp.where(inv_ok, det, 1.0)
    return {
        "t": t, "ix": ix, "iy": iy, "gxx": gxx, "gxy": gxy, "gyy": gyy,
        "det_safe": det_safe, "inv_ok": inv_ok,
    }


def _lk_level(img_a, img_b, pts_level, guess, radius: int, iters: int,
              margin: int, precision=None):
    """One pyramid level of iterative LK for all (pair, point).

    img_a/img_b: (B, H, Wp) lane-padded level images. pts_level:
    (N, 2) or (B, N, 2) point positions at this level's scale — a
    host np.ndarray of integers takes the static-template fast path.
    guess: (B, N, 2) incoming displacement. Returns (B, N, 2).

    Structure: template patch + gradients once (static slices on the
    fixed-grid path, gathered bilinear otherwise); ONE row-block
    gather of each point's search region from img_b; then `iters`
    Gauss-Newton steps where the shifted fractional window is two
    interpolation matmuls against the resident region (no further
    reads of the image)."""
    tmpl = _lk_templates(img_a, pts_level, radius)
    return _lk_iterate(
        img_b, pts_level, guess, tmpl, radius, iters, margin, precision
    )


def _lk_iterate(img_b, pts_level, guess, tmpl, radius: int, iters: int,
                margin: int, precision=None, fidx=None):
    """The img_b half of an LK level: fetch each point's search region
    and run `iters` Gauss-Newton steps against precomputed templates
    (`tmpl` from _lk_templates; its B axis must match guess's). With
    fidx (B,) int32, img_b holds the FULL clip and pair b searches
    frame fidx[b] — zero per-chunk frame copies."""
    w = 2 * radius + 1
    B = guess.shape[0]
    t, ix, iy = tmpl["t"], tmpl["ix"], tmpl["iy"]
    gxx, gxy, gyy = tmpl["gxx"], tmpl["gxy"], tmpl["gyy"]
    det_safe, inv_ok = tmpl["det_safe"], tmpl["inv_ok"]
    pts_level = jnp.asarray(pts_level, jnp.float32)
    if pts_level.ndim == 2:
        pts_level = jnp.broadcast_to(
            pts_level[None], (B, *pts_level.shape)
        )

    # resident search region around the incoming guess: rows exact at
    # the integer anchor, the 2-block (256-lane) column superset
    # narrowed to the window's true column range by one exact
    # interpolation matmul (iterations then read a (S, Sc) buffer
    # instead of (S, 256) — 6x less traffic per iteration)
    M = margin
    S = w + 2 * M + 2
    Sc = w + 2 * M + 1
    anchor = jnp.floor(pts_level + guess)
    origin = anchor - (radius + M)
    oy = origin[..., 1].astype(jnp.int32)
    ox = origin[..., 0].astype(jnp.int32)
    if _strip_path_ok(img_b) and S <= STRIP_ROWS - 8:
        # strip fetch: top row quantized down to the 8-row quantum,
        # strip clamped fully in-bounds (fine levels carry STRIP_PAD
        # edge-replicated bottom rows, so sane windows never clamp at
        # the bottom); the row residual rides the sampling taps below.
        # roff/rem may go NEGATIVE for windows overhanging the frame
        # top/left — _tap2 clamps sample positions to the buffer, which
        # edge-replicates exactly like the legacy per-row-clamp gather
        # (ADVICE r3: the old lower clip shifted the whole window
        # in-bounds, diverging up to ~1.9 px from the legacy path for
        # points near the frame top).
        Hp = img_b.shape[1]
        NB = img_b.shape[2] // LANE
        oyq = jnp.clip(oy // 8, 0, (Hp - STRIP_ROWS) // 8)
        obx = jnp.clip(ox // LANE, 0, NB - 2)
        roff = jnp.minimum(
            (oy - oyq * 8).astype(jnp.float32), float(STRIP_ROWS - S)
        )
        rem = jnp.minimum(
            (ox - obx * LANE).astype(jnp.float32), float(2 * LANE - Sc)
        )
        wide = _gather_strips(img_b, oyq, obx, fidx=fidx)  # (B, N, 40, 256)
    else:
        # clamp the block (not the remainder): negative rem positions
        # edge-replicate via the clamped taps, matching the strip path
        # (an unclamped negative obx would make _gather_blocks fetch
        # block 0 twice and alias columns)
        NB_l = img_b.shape[2] // LANE
        obx = jnp.clip(ox // LANE, 0, max(NB_l - 2, 0))
        rem = (ox - obx * LANE).astype(jnp.float32)  # integer-valued
        roff = jnp.zeros_like(rem)
        wide = _gather_blocks(img_b, oy, obx, S, fidx=fidx)  # (B, N, S, 256)
    if wide.dtype == jnp.uint8:
        # u8 pixels and one-hot taps are exact in bf16: the narrowing
        # select runs as a single bf16 pass, f32 accumulation
        Cr = _tap2(rem, Sc, 2 * LANE, jnp.bfloat16)
        buf = _bmm(wide.astype(jnp.bfloat16), Cr, (1, 1))
    else:
        Cr = _tap2(rem, Sc, 2 * LANE)  # one-hot (rem integral) — exact
        buf = _bmm(
            wide.astype(jnp.float32), Cr, (1, 1),
            jax.lax.Precision.HIGHEST,
        )  # (B, N, rows, Sc)
    g_frac = ((pts_level + guess) - anchor).astype(jnp.float32)  # (B, N, 2)

    def body(_, d_rel):
        # sample positions inside buf: rows roff + M + zy + [0..w),
        # cols M + zx + [0..w)
        z = jnp.clip(g_frac + d_rel, -(M - 1.0), M - 1.0)
        patch_b = _sample_windows(
            buf, roff + M + z[..., 1], M + z[..., 0], w, w, precision,
        )
        e = patch_b - t
        bx = jnp.sum(ix * e, axis=(-2, -1))
        by = jnp.sum(iy * e, axis=(-2, -1))
        du = (gyy * bx - gxy * by) / det_safe
        dv = (gxx * by - gxy * bx) / det_safe
        step = jnp.stack([du, dv], axis=-1)
        step = jnp.where(inv_ok[..., None], step, 0.0)
        return jnp.clip(d_rel - step, -(M - 1.0), M - 1.0)

    # fori_loop (not a Python unroll): smaller program, same math
    d_rel = jax.lax.fori_loop(0, iters, body, jnp.zeros_like(guess))
    return guess + d_rel


# ---------------------------------------------------------------------------
# coarse stage: global SAD shift + local cost volume


def _global_shift(a: jnp.ndarray, b: jnp.ndarray, D: int) -> jnp.ndarray:
    """Integer global translation per pair by full-image SAD argmin
    over (2D+1)^2 shifts at a tiny pyramid level. a, b: (B, h, w) f32.
    Returns (B, 2) f32 xy flow (a->b motion: b ~ a shifted BY flow)."""
    B, h, w = a.shape
    pb = jnp.pad(b, ((0, 0), (D, D), (D, D)), mode="edge")
    sads = jnp.stack(
        [
            jnp.mean(jnp.abs(a - pb[:, dy : dy + h, dx : dx + w]),
                     axis=(-2, -1))
            for dy in range(2 * D + 1)
            for dx in range(2 * D + 1)
        ],
        axis=-1,
    )  # (B, (2D+1)^2); shift (dy,dx) tests flow (dx-D, dy-D)
    best = jnp.argmin(sads, axis=-1)
    gy = best // (2 * D + 1) - D
    gx = best % (2 * D + 1) - D
    return jnp.stack([gx, gy], axis=-1).astype(jnp.float32)


def _coarse_init(pyr: list[jnp.ndarray], lvl_vol: int, lvl_glob: int,
                 pts: jnp.ndarray, D_glob: int) -> jnp.ndarray:
    """Per-point flow init (level-0 px) from the coarse stage.

    pyr: per-level (B+1-frame or pair) images; here each entry is a
    tuple (a, b) of (B, h, w) level images (u8 or float). pts: (N, 2)
    level-0 xy. Returns (B, N, 2) flow in level-0 px."""
    a_g, b_g = pyr[lvl_glob]
    g = _global_shift(
        a_g.astype(jnp.float32), b_g.astype(jnp.float32), D_glob
    )  # (B, 2) @ lvl_glob px

    a, b = pyr[lvl_vol]
    B, h, w = a.shape
    scale_gl = float(2 ** (lvl_glob - lvl_vol))
    gi = jnp.round(g * scale_gl).astype(jnp.int32)  # (B, 2) @ lvl_vol
    max_shift = int(D_glob * scale_gl)

    # un-shift b by the global flow: value at (y,x) <- b[y+gy, x+gx]
    pb = jnp.pad(
        b, ((0, 0), (max_shift, max_shift), (max_shift, max_shift)),
        mode="edge",
    )

    def unshift(bi, gxy):
        return jax.lax.dynamic_slice(
            bi, (max_shift + gxy[1], max_shift + gxy[0]), (h, w)
        )

    b0 = jax.vmap(unshift)(pb, gi)

    # SAD cost volume over +-D with a (2*VOL_BOX+1)^2 box filter.
    # u8 pixels run the volume in int16 — exact (|diff| <= 255, 5x5
    # box sums <= 6375 < 2^15) at half the f32 traffic
    if jnp.issubdtype(a.dtype, jnp.integer):
        av = a.astype(jnp.int16)
        b0v = b0.astype(jnp.int16)
    else:
        av = a.astype(jnp.float32)
        b0v = b0.astype(jnp.float32)
    D = VOL_D
    K = 2 * D + 1
    pb0 = jnp.pad(b0v, ((0, 0), (D, D), (D, D)), mode="edge")
    vol = jnp.stack(
        [
            jnp.abs(av - pb0[:, dy : dy + h, dx : dx + w])
            for dy in range(K)
            for dx in range(K)
        ],
        axis=1,
    )  # (B, K*K, h, w)
    vp = jnp.pad(
        vol, ((0, 0), (0, 0), (VOL_BOX, VOL_BOX), (VOL_BOX, VOL_BOX)),
        mode="edge",
    )
    r = sum(vp[:, :, i : i + h, :] for i in range(2 * VOL_BOX + 1))
    cost = sum(r[:, :, :, i : i + w] for i in range(2 * VOL_BOX + 1))

    best = jnp.argmin(cost, axis=1)  # (B, h, w) in [0, K*K)
    # clamp the argmin one cell into the interior so parabola
    # neighbors exist, then read the 5-point stencil with weighted
    # reductions (take_along_axis over the volume axis hits XLA's
    # slow elementwise-gather path)
    by = jnp.clip(best // K, 1, K - 2)
    bx = jnp.clip(best % K, 1, K - 2)
    onehot = (
        jnp.arange(K * K, dtype=jnp.int32)[None, :, None, None]
        == (by * K + bx)[:, None]
    ).astype(cost.dtype)

    def at(off):
        return jnp.sum(
            cost * jnp.roll(onehot, off, axis=1), axis=1
        ).astype(jnp.float32)

    c0 = at(0)

    def parab(cm, cp):
        denom = cm - 2.0 * c0 + cp
        safe = jnp.where(jnp.abs(denom) > 1e-9, denom, 1.0)
        sub = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (cm - cp) / safe, 0.0)
        return jnp.clip(sub, -0.6, 0.6)

    sx = parab(at(-1), at(1))
    sy = parab(at(-K), at(K))
    flow = jnp.stack(
        [bx.astype(jnp.float32) - D + sx, by.astype(jnp.float32) - D + sy],
        axis=-1,
    )  # (B, h, w, 2) @ lvl_vol px
    flow = flow + gi[:, None, None, :].astype(jnp.float32)

    # bilinear-sample the flow at the grid points via one matmul; with
    # a host (static) grid the sampling matrix is a compile-time
    # constant — zero device ops to build it
    scale = float(2**lvl_vol)
    xp = np if isinstance(pts, np.ndarray) else jnp
    p = pts / scale
    px = xp.clip(p[:, 0], 0.0, w - 1.001)
    py = xp.clip(p[:, 1], 0.0, h - 1.001)
    x0 = xp.floor(px)
    y0 = xp.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = x0.astype(xp.int32)
    y0i = y0.astype(xp.int32)
    q = xp.arange(h * w, dtype=xp.int32)[None, :]

    def oh(yi, xi):
        return (q == (yi * w + xi)[:, None]).astype(xp.float32)

    Wmat = (
        oh(y0i, x0i) * (1 - fx) * (1 - fy)
        + oh(y0i, x0i + 1) * fx * (1 - fy)
        + oh(y0i + 1, x0i) * (1 - fx) * fy
        + oh(y0i + 1, x0i + 1) * fx * fy
    )  # (N, h*w)
    Wmat = jnp.asarray(Wmat, jnp.float32)
    flat = flow.reshape(B, h * w, 2)
    sampled = jnp.einsum(
        "nq,bqc->bnc", Wmat, flat,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return sampled * scale  # level-0 px


# ---------------------------------------------------------------------------
# full tracker core


def _fine_plan(
    levels: int, iters: int, radius: int
) -> list[tuple[int, int, int, int]]:
    """[(level, iters, margin, radius)] finest-last. Entry level gets
    the wide margin (absorbs coarse-init error); the finest level gets
    the most iterations (subpixel accuracy).

    On deep pyramids (>= 7 levels, i.e. >= ~1500 px frames) the
    intermediate level is SKIPPED and the entry level uses a small
    window: the entry refinement leaves <= ~0.5 px of error at its own
    scale, i.e. <= ~2 px at level 0, inside the level-0 margin, at
    identical accuracy with fewer iterations. Small frames keep the
    conservative 3-level schedule (features are relatively sparser and
    the short-window entry measurably costs sub-ms sync accuracy
    there)."""
    n_fine = min(3, levels)
    if n_fine >= 3 and levels >= 7:
        return [
            (2, 2, MARGIN_ENTRY, min(radius, 6)),
            (0, min(iters, 4), MARGIN_FINE + 1, radius),
        ]
    if n_fine >= 3:
        return [
            (2, 3, MARGIN_ENTRY, radius),
            (1, 2, MARGIN_FINE, radius),
            (0, min(iters, 5), MARGIN_FINE, radius),
        ]
    if n_fine == 2:
        return [
            (1, 3, MARGIN_ENTRY, radius),
            (0, min(iters, 5), MARGIN_FINE, radius),
        ]
    return [(0, min(iters, 8), MARGIN_ENTRY, radius)]


def _lk_core(pyr_pairs: dict[int, tuple[jnp.ndarray, jnp.ndarray]],
             pts: jnp.ndarray, levels: int, radius: int,
             iters: int) -> jnp.ndarray:
    """Shared tracker body over per-level (img_a, img_b) batches
    (keyed by level; only the levels in `_needed_levels` exist)."""
    plan = _fine_plan(levels, iters, radius)
    entry = plan[0][0]
    B = pyr_pairs[entry][0].shape[0]

    if levels > entry + 1:
        lvl_glob = levels - 1
        lvl_vol = max(entry + 1, lvl_glob - 2)
        pairs = {lvl: pyr_pairs[lvl] for lvl in {lvl_glob, lvl_vol}}
        hg = pyr_pairs[lvl_glob][0].shape[-2:]
        D_glob = max(2, min(hg) // 3)
        d = _coarse_init(pairs, lvl_vol, lvl_glob, pts, D_glob)  # (B, N, 2)
    else:
        d = jnp.zeros((B,) + pts.shape, jnp.float32)

    for lvl, it_l, m_l, r_l in plan:
        scale = float(2**lvl)
        d = _lk_level(
            pyr_pairs[lvl][0], pyr_pairs[lvl][1], pts / scale, d / scale,
            r_l, it_l, m_l, precision=jax.lax.Precision.HIGHEST,
        ) * scale
    return pts[None] + d


def _lk_pairs_core(imgs_a: jnp.ndarray, imgs_b: jnp.ndarray,
                   pts: jnp.ndarray, levels: int, radius: int,
                   iters: int) -> jnp.ndarray:
    """Track pts from imgs_a[i] to imgs_b[i]: (B, H, W) x2 + (N, 2)
    -> (B, N, 2) tracked positions."""
    need = _needed_levels(levels, iters, radius)
    fine = {l for l, _i, _m, _r in _fine_plan(levels, iters, radius)}
    plan = {l: "fine" if l in fine else "lane" for l in need}
    hw = imgs_a.shape[-2:]
    imgs_a = _pad_lanes(imgs_a, 0 in fine)
    imgs_b = _pad_lanes(imgs_b, 0 in fine)
    pyr_a = build_pyramid_sparse(imgs_a, levels, need, hw, plan)
    pyr_b = build_pyramid_sparse(imgs_b, levels, need, hw, plan)
    pairs = {l: (pyr_a[l], pyr_b[l]) for l in need}
    return _lk_core(pairs, pts, levels, radius, iters)


def _lk_video_core(frames: jnp.ndarray, pts: jnp.ndarray, levels: int,
                   radius: int, iters: int,
                   logical_hw: tuple[int, int] | None = None) -> jnp.ndarray:
    """Track consecutive pairs of a frame block with ONE shared
    pyramid per frame (each interior frame serves two pairs).
    logical_hw: pass the unpadded (H, W) when `frames` already carries
    the level-0 storage padding (the chunked path pads once for the
    whole clip); otherwise frames are padded here."""
    need = _needed_levels(levels, iters, radius)
    fine = {l for l, _i, _m, _r in _fine_plan(levels, iters, radius)}
    plan = {l: "fine" if l in fine else "lane" for l in need}
    if logical_hw is None:
        logical_hw = frames.shape[-2:]
        frames = _pad_lanes(frames, 0 in fine)
    pyr = build_pyramid_sparse(frames, levels, need, logical_hw, plan)
    pairs = {l: (pyr[l][:-1], pyr[l][1:]) for l in need}
    return _lk_core(pairs, pts, levels, radius, iters)


# ---------------------------------------------------------------------------
# public API


def lk_track(
    img_a: jnp.ndarray,
    img_b: jnp.ndarray,
    pts: jnp.ndarray,
    levels: int | None = None,
    radius: int = LK_RADIUS,
    iters: int = LK_ITERS,
) -> jnp.ndarray:
    """Track points from img_a to img_b. pts: (N, 2) xy pixels.
    Returns tracked (N, 2) positions in img_b. levels=None auto-scales
    pyramid depth to the image size."""
    if levels is None:
        levels = auto_levels(img_a.shape[0], img_a.shape[1])
    return _lk_track_pairs_jit(
        img_a[None], img_b[None], pts, levels, radius, iters
    )[0]


def lk_track_pairs(
    imgs_a: jnp.ndarray,
    imgs_b: jnp.ndarray,
    pts: jnp.ndarray,
    levels: int | None = None,
    radius: int = LK_RADIUS,
    iters: int = LK_ITERS,
) -> jnp.ndarray:
    """Batched tracking of independent pairs: (B, H, W) x2 -> (B, N, 2)."""
    if levels is None:
        levels = auto_levels(imgs_a.shape[1], imgs_a.shape[2])
    return _lk_track_pairs_jit(imgs_a, imgs_b, pts, levels, radius, iters)


@partial(jax.jit, static_argnames=("levels", "radius", "iters"))
def _lk_track_pairs_jit(imgs_a, imgs_b, pts, levels, radius, iters):
    return _lk_pairs_core(
        imgs_a, imgs_b, jnp.asarray(pts, jnp.float32), levels, radius, iters
    )


def lk_track_video(
    frames: jnp.ndarray,
    pts: jnp.ndarray | None = None,
    levels: int | None = None,
    radius: int = LK_RADIUS,
    iters: int = LK_ITERS,
    grid_step: int | None = None,
    logical_hw: tuple[int, int] | None = None,
) -> jnp.ndarray:
    """Track the shared grid across all consecutive pairs of a frame
    block: (B, H, W) -> (B-1, N, 2). pts=None uses the reference
    feature grid (grid_step; auto from the resolution). logical_hw:
    the unpadded (H, W) when frames are pre-padded (pad_frames_host)."""
    H, W = logical_hw if logical_hw is not None else frames.shape[1:3]
    if levels is None:
        levels = auto_levels(H, W)
    if pts is None:
        step = grid_step or auto_grid_step(W)
        pts = grid_points(W, H, step)
    return _lk_track_video_jit(
        frames, _static_pts(pts), levels, radius, iters,
        logical_hw if logical_hw is not None else None,
    )


def _static_pts(pts) -> tuple:
    """Hashable form of the (host) point grid so jits can specialize
    on it: integer static grids unlock the static-template and
    constant-sampling-matrix paths (no device gathers for templates)."""
    return tuple(map(tuple, np.asarray(pts, np.float32).tolist()))


@partial(jax.jit, static_argnames=(
    "pts_static", "levels", "radius", "iters", "logical_hw"))
def _lk_track_video_jit(frames, pts_static, levels, radius, iters,
                        logical_hw=None):
    pts = np.asarray(pts_static, np.float32)
    if logical_hw is not None:
        fine0 = 0 in {l for l, *_ in _fine_plan(levels, iters, radius)}
        exp = _stored_dims(*logical_hw, "fine" if fine0 else "lane")
        if frames.shape[1:3] != exp:
            raise ValueError(
                f"pre-padded frames {frames.shape[1:3]} != expected {exp} "
                f"for logical {logical_hw}"
            )
    return _lk_video_core(frames, pts, levels, radius, iters,
                          logical_hw=logical_hw)


def pad_frames_host(frames: np.ndarray, levels: int | None = None,
                    radius: int = LK_RADIUS,
                    iters: int = LK_ITERS) -> np.ndarray:
    """Edge-pad a (T, H, W) frame block to the tracker's level-0
    storage dims ON THE HOST (numpy). Feeding pre-padded frames +
    logical_hw to lk_track_video_chunked skips the on-device pad pass,
    a full extra pass over the clip in device memory; the host memcpy
    hides under the decode-ahead overlap."""
    T, H, W = frames.shape
    if levels is None:
        levels = auto_levels(H, W)
    fine0 = 0 in {l for l, *_ in _fine_plan(levels, iters, radius)}
    Hp, Wp = _stored_dims(H, W, "fine" if fine0 else "lane")
    if (Hp, Wp) == (H, W):
        return frames
    out = np.empty((T, Hp, Wp), frames.dtype)
    out[:, :H, :W] = frames
    out[:, H:, :W] = frames[:, -1:, :]
    out[:, :, W:] = out[:, :, W - 1 : W]
    return out


def stack_pad_host(grays: list, n_total: int, H: int, W: int,
                   Hp: int, Wp: int) -> np.ndarray:
    """Assemble a (n_total, Hp, Wp) storage-padded u8 block from a
    list of (H, W) frames in ONE host copy — bit-identical to
    `pad_frames_host(np.stack(grays + [last] * tail))` but without the
    intermediate stack/concat copies (the block assembly runs on the
    tracking critical path; on a 1-core host the extra 93 MB memcpy
    per 2.7k block was 0.5-6 s of exposed wall)."""
    k = len(grays)
    out = np.empty((n_total, Hp, Wp), np.uint8)
    for i, g in enumerate(grays):
        out[i, :H, :W] = g
        out[i, H:, :W] = g[-1:, :]
    out[:k, :, W:] = out[:k, :, W - 1 : W]
    if k < n_total:
        out[k:] = out[k - 1]
    return out


def lk_track_video_chunked(
    frames: jnp.ndarray,
    pts: jnp.ndarray | None = None,
    chunk: int = 16,
    levels: int | None = None,
    radius: int = LK_RADIUS,
    iters: int = LK_ITERS,
    grid_step: int | None = None,
    logical_hw: tuple[int, int] | None = None,
    hybrid: bool | None = None,
) -> jnp.ndarray:
    """Track (T, H, W) consecutive frames -> (T-1, N, 2) in ONE
    dispatch: `lax.map` over chunk-sized blocks inside the jit (one
    launch per clip block instead of one per chunk).
    Requires (T-1) % chunk == 0 (callers pad by repeating the last
    frame; repeated frames track to zero flow).

    logical_hw: pass the unpadded (H, W) when `frames` already carry
    the level-0 storage padding (see pad_frames_host) — skips the
    expensive on-device pad pass.

    hybrid: per-frame passes (small-level pyramid, level-0 templates)
    hoisted out of the chunk loop so the full-res u8 block is never
    copied (level-0 search reads take the strip fetch at per-pair frame
    indices). It lost its A/B against the block structure on the
    previous accelerator and has not been timed on the H100, so the
    default stays False; the flag and its bit-parity test are kept
    because they pin the fidx full-clip strip-fetch path. Falls back to the block structure
    where the level-0 plan can't serve it."""
    H, W = logical_hw if logical_hw is not None else frames.shape[1:3]
    if levels is None:
        levels = auto_levels(H, W)
    T = frames.shape[0]
    if (T - 1) % chunk:
        raise ValueError(f"(T-1)={T - 1} must be a multiple of chunk={chunk}")
    if pts is None:
        step = grid_step or auto_grid_step(W)
        pts = grid_points(W, H, step)
    return _lk_track_video_chunked_jit(
        frames, _static_pts(pts), chunk, levels, radius, iters, (H, W),
        hybrid,
    )


@partial(jax.jit, static_argnames=(
    "pts_static", "chunk", "levels", "radius", "iters", "logical_hw",
    "hybrid"))
def _lk_track_video_chunked_jit(frames, pts_static, chunk, levels, radius,
                                iters, logical_hw=None, hybrid=None):
    """Chunked tracker over a device-resident clip. Two structures:

    block (default): each `lax.map` iteration
    slices its (chunk+1)-frame block and runs the full pipeline on it.

    hybrid (opt-in): the per-FRAME passes — the small-level pyramid
    ({2, 5, 7} on the 2.7k operating point) and the level-0 templates
    — run ONCE over the whole clip; the chunk loop slices only the
    1/16-size level arrays and reads level-0 search strips via the
    strip fetch at per-pair frame indices (_lk_iterate's fidx path), so
    the full-res u8 block is never copied. The hoisted full-clip passes
    round-trip device memory where the per-chunk passes fuse with their
    consumers; on the H100 the trade is not measured. Kept opt-in: its
    bit-parity test pins the fidx full-clip strip-fetch path. Storage
    padding runs on the host (pad_frames_host + logical_hw) so that no
    full-clip u8 pass runs on device."""
    T = frames.shape[0]
    H, W = logical_hw if logical_hw is not None else frames.shape[1:3]
    n_chunks = (T - 1) // chunk
    starts = jnp.arange(n_chunks) * chunk
    pts = np.asarray(pts_static, np.float32)

    plan = _fine_plan(levels, iters, radius)
    fine0 = 0 in {l for l, *_ in plan}
    if (H, W) == frames.shape[1:3]:
        # level-0 storage padding once for the whole clip; per-chunk
        # level padding is folded into the pyramid weights
        frames_p = _pad_lanes(frames, fine0)
    else:  # pre-padded on host (pad_frames_host): must match exactly
        exp = _stored_dims(H, W, "fine" if fine0 else "lane")
        if frames.shape[1:3] != exp:
            raise ValueError(
                f"pre-padded frames {frames.shape[1:3]} != expected {exp} "
                f"for logical {(H, W)}"
            )
        frames_p = frames
    Hp, Wp = frames_p.shape[-2:]

    hybrid = bool(hybrid) and (
        fine0
        and plan[-1][0] == 0
        and _strip_path_ok(frames_p)
        and bool(np.all(pts == np.round(pts)))
    )

    if not hybrid:
        def one(start):
            blk = jax.lax.dynamic_slice(
                frames_p, (start, 0, 0), (chunk + 1, Hp, Wp))
            return _lk_video_core(blk, pts, levels, radius, iters,
                                  logical_hw=(H, W))

        out = jax.lax.map(one, starts)  # (n_chunks, chunk, N, 2)
        return out.reshape(T - 1, pts.shape[0], 2)

    need = _needed_levels(levels, iters, radius)
    fine = {l for l, *_ in plan}
    lvl_plan = {l: "fine" if l in fine else "lane" for l in need}
    small = [l for l in need if l > 0]
    # hoisted per-frame passes (outputs small or row-sparse)
    pyr_small = build_pyramid_sparse(frames_p, levels, small, (H, W),
                                     lvl_plan)
    tmpl0 = _lk_templates(frames_p, pts, plan[-1][3])
    entry = plan[0][0]
    lvl_glob = levels - 1
    lvl_vol = max(entry + 1, lvl_glob - 2)

    def one(start):
        pairs = {}
        for l in small:
            shp = pyr_small[l].shape
            blk = jax.lax.dynamic_slice(
                pyr_small[l], (start, 0, 0), (chunk + 1, shp[1], shp[2]))
            pairs[l] = (blk[:-1], blk[1:])
        if levels > entry + 1:
            cpairs = {lvl: pairs[lvl] for lvl in {lvl_glob, lvl_vol}}
            hg = pairs[lvl_glob][0].shape[-2:]
            D_glob = max(2, min(hg) // 3)
            d = _coarse_init(cpairs, lvl_vol, lvl_glob, pts, D_glob)
        else:
            d = jnp.zeros((chunk,) + pts.shape, jnp.float32)
        for lvl, it_l, m_l, r_l in plan:
            scale = float(2**lvl)
            if lvl > 0:
                d = _lk_level(
                    pairs[lvl][0], pairs[lvl][1], pts / scale, d / scale,
                    r_l, it_l, m_l, precision=jax.lax.Precision.HIGHEST,
                ) * scale
            else:
                tm = jax.tree_util.tree_map(
                    lambda a: jax.lax.dynamic_slice_in_dim(
                        a, start, chunk, 0),
                    tmpl0,
                )
                fidx = start + 1 + jnp.arange(chunk, dtype=jnp.int32)
                d = _lk_iterate(
                    frames_p, pts, d, tm, r_l, it_l, m_l,
                    precision=jax.lax.Precision.HIGHEST, fidx=fidx,
                )
        return pts[None] + d

    out = jax.lax.map(one, starts)  # (n_chunks, chunk, N, 2)
    return out.reshape(T - 1, pts.shape[0], 2)


# ---------------------------------------------------------------------------
# fused post-processing: undistort + RS timestamps + ray lifting


@partial(jax.jit, static_argnames=("lens",))
def lift_rays(lens: lens_ops.Lens, pts_a: jnp.ndarray, pts_b: jnp.ndarray):
    """Undistort both endpoints and lift to unit rays
    normalize([x, y, 1]) (ref: core_testcode.cpp:147-152). Device side."""
    ua = lens_ops.undistort_points(lens, pts_a)
    ub = lens_ops.undistort_points(lens, pts_b)
    return lens_ops.rays_from_normalized(ua), lens_ops.rays_from_normalized(ub)


def rolling_shutter_ts(
    lens: lens_ops.Lens,
    pts_a: np.ndarray,
    pts_b: np.ndarray,
    ts_frame_a: float,
    ts_frame_b: float,
    rows: int,
):
    """Per-ray rolling-shutter timestamps from each endpoint's own row —
    including the *tracked* row for frame B
    (ref: core_testcode.cpp:144-145). Host f64: frame timestamps are
    ~minutes-scale and must keep sub-µs resolution."""
    ts_a = ts_frame_a + lens.ro * (np.asarray(pts_a, np.float64)[:, 1] / rows)
    ts_b = ts_frame_b + lens.ro * (np.asarray(pts_b, np.float64)[:, 1] / rows)
    return ts_a, ts_b


# ---------------------------------------------------------------------------
# host video decode


@dataclass
class Frame:
    index: int
    timestamp: float  # seconds
    gray: np.ndarray  # (H, W) uint8


def _probe_raw_luma(cv2, path: str, height: int) -> bool:
    """Check whether CONVERT_RGB=0 yields a usable luma plane for this
    stream (yuv420p-family): the ffmpeg backend then skips the YUV->BGR
    conversion entirely and `read()` returns either the bare Y plane
    (H, W) or the full I420 buffer (H*3/2, W), with no BGR decode +
    cvtColor."""
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            return False
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        ok, img = cap.read()
        return bool(
            ok
            and img is not None
            and img.ndim == 2
            and img.shape[0] in (height, height * 3 // 2)
        )
    finally:
        cap.release()


class VideoSource:
    """cv2-backed host decoder (the reference's VideoCapture usage,
    ref: core_testcode.cpp:99-122), with a raw-luma fast path: where
    the reference decodes to BGR and converts to gray
    (core_testcode.cpp:118-121), yuv420p streams here skip both
    conversions and read the Y plane directly."""

    #: forward gaps up to this many frames skip via grab() (decode
    #: without convert/copy) instead of a container seek. A seek costs
    #: a keyframe-to-position decode — on sparse-keyframe streams
    #: (cv2's own mp4v writer emits very few) that re-decodes
    #: potentially the WHOLE prefix per seek, which made window-scoped
    #: decode quadratic in the clip length. grab() is a bounded
    #: ~decode-cost per frame; 512
    #: covers window-scoped gaps (<= syncpoint_distance) while keeping
    #: the worst case vs a cheap seek (dense-keyframe streams) small.
    GRAB_FWD = 512

    def __init__(self, path: str, raw_luma: bool = True):
        import cv2

        try:  # silence ffmpeg's per-frame yuv420p->8UC1 notice
            cv2.utils.logging.setLogLevel(
                cv2.utils.logging.LOG_LEVEL_ERROR
            )
        except AttributeError:
            pass
        self._cv2 = cv2
        self.path = path
        probe = cv2.VideoCapture(path)
        if not probe.isOpened():
            raise RuntimeError("video open failed")
        self.fps = probe.get(cv2.CAP_PROP_FPS)
        self.width = int(probe.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(probe.get(cv2.CAP_PROP_FRAME_HEIGHT))
        probe.release()
        self._raw = raw_luma and _probe_raw_luma(cv2, path, self.height)
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise RuntimeError("video open failed")
        if self._raw:
            self.cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        self._pos = 0  # next frame read() returns

    def _gray(self, img) -> np.ndarray:
        if self._raw:
            if img.shape[0] == self.height:
                return img.copy()
            return img[: self.height].copy()
        return self._cv2.cvtColor(img, self._cv2.COLOR_BGR2GRAY)

    def seek(self, frame: int) -> None:
        """Position so the next read() returns `frame`. No-op when
        already there; short forward gaps grab() through (see
        GRAB_FWD); otherwise a real container seek."""
        if frame == self._pos:
            return
        if self._pos < frame <= self._pos + self.GRAB_FWD:
            for _ in range(frame - self._pos):
                if not self.cap.grab():
                    raise RuntimeError("grab failed during forward skip")
            self._pos = frame
            return
        self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, frame)
        if self.cap.get(self._cv2.CAP_PROP_POS_FRAMES) != frame:
            raise RuntimeError("Seek failed")
        self._pos = frame

    def frames(self, start: int, stop: int) -> Iterator[Frame]:
        self.seek(start)
        for idx in range(start, stop):
            ok, img = self.cap.read()
            if not ok:
                raise RuntimeError("frame read failed")
            self._pos = idx + 1
            ts = self.cap.get(self._cv2.CAP_PROP_POS_MSEC) / 1000.0
            yield Frame(index=idx, timestamp=ts, gray=self._gray(img))


class FrameFeed:
    """Decode-ahead frame feed: worker threads decode chunks of
    [start, stop) into a bounded ordered buffer, so host decode
    overlaps device tracking instead of serializing with it (the
    reference decodes inline in its tracking loop,
    ref: core_testcode.cpp:99-122).

    n_workers defaults to 1 — a single sequential reader (chunk seeks
    are then position no-ops, see VideoSource.seek) whose only job is
    the decode-ahead overlap. PARALLEL decode is the multiprocess
    DecodePool's job (decode_pool.py): thread workers >1 interleave
    chunk seeks, which on sparse-keyframe streams re-decode from a
    keyframe per chunk and lose outright. Consumption is strictly in
    frame order; at most `ahead` chunks are buffered beyond the
    consumer (bounds host memory to ~ahead*CHUNK frames)."""

    CHUNK = 32

    def __init__(
        self,
        path: str,
        start: int,
        stop: int,
        n_workers: int | None = None,
        ahead: int = 16,
        raw_luma: bool = True,
    ):
        import threading

        if n_workers is None:
            n_workers = 1
        src0 = VideoSource(path, raw_luma=raw_luma)
        self.fps = src0.fps
        self.width = src0.width
        self.height = src0.height
        bounds = list(range(start, stop, self.CHUNK)) + [stop]
        self._chunks = list(zip(bounds[:-1], bounds[1:]))
        n_workers = max(1, min(n_workers, len(self._chunks)))
        self._ahead = max(n_workers + 1, ahead)
        self._results: dict[int, object] = {}
        self._next_emit = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stopped = False
        self._threads = []
        self._sources = [src0] + [
            VideoSource(path, raw_luma=raw_luma) for _ in range(n_workers - 1)
        ]
        for w in range(n_workers):
            t = threading.Thread(
                target=self._worker, args=(w, n_workers, self._sources[w]),
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _worker(self, w: int, n: int, src: VideoSource) -> None:
        ci = w
        try:
            for ci in range(w, len(self._chunks), n):
                with self._cv:
                    while (
                        ci >= self._next_emit + self._ahead
                        and not self._stopped
                    ):
                        self._cv.wait(timeout=1.0)
                    if self._stopped:
                        return
                c0, c1 = self._chunks[ci]
                frames = list(src.frames(c0, c1))
                with self._cv:
                    self._results[ci] = frames
                    self._cv.notify_all()
        except Exception as e:  # surface in the consumer
            with self._cv:
                self._results[ci] = e
                self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def __iter__(self) -> Iterator[Frame]:
        try:
            for ci in range(len(self._chunks)):
                with self._cv:
                    while ci not in self._results:
                        self._cv.wait(timeout=1.0)
                        if self._stopped and ci not in self._results:
                            return
                    item = self._results.pop(ci)
                    self._next_emit = ci + 1
                    self._cv.notify_all()
                if isinstance(item, Exception):
                    raise item
                yield from item
        finally:
            self.close()


def _range_feeds(
    video_path: str,
    ranges: Sequence[tuple[int, int]],
    raw_luma: bool = True,
    n_workers: int | None = None,
) -> Iterator[Iterator[Frame]]:
    """One frame iterator per PAIR range (decoding [pb, pe+1) each).

    Picks the decode backend by available parallelism: with >1 CPU a
    multiprocess DecodePool shards GOP-amortized chunks across decoder
    processes (parallel decode — the host bottleneck on real video);
    on a single core the decode-ahead FrameFeed thread (no spawn cost,
    still overlaps device tracking). Both yield bit-identical frames
    (tests/test_tracking.py pins pool-vs-serial equality)."""
    from rssync_tpu.frontend.decode_pool import (
        PROBE_MIN_FRAMES,
        DecodePool,
        available_workers,
        probe_workers,
    )

    n = available_workers(n_workers)
    if n <= 1 or len(ranges) == 0:
        for pb, pe in ranges:
            yield iter(FrameFeed(video_path, pb, pe + 1, raw_luma=raw_luma))
        return
    probe = VideoSource(video_path, raw_luma=raw_luma)
    raw, h, w = probe._raw, probe.height, probe.width
    probe.cap.release()
    # replace the min(4, cores) guess with a measured-throughput
    # choice when enough frames are at stake to amortize the probe
    total = sum(pe + 1 - pb for pb, pe in ranges)
    if n_workers is None and total >= PROBE_MIN_FRAMES:
        n = probe_workers(video_path, h, w, raw, total)
        if n <= 1:  # the probe found parallel decode no faster here
            for pb, pe in ranges:
                yield iter(
                    FrameFeed(video_path, pb, pe + 1, raw_luma=raw_luma)
                )
            return
    pool = DecodePool(
        video_path, [(pb, pe + 1) for pb, pe in ranges], h, w, raw, n
    )
    try:
        for i in range(len(ranges)):
            yield (
                Frame(index=idx, timestamp=ts, gray=g)
                for idx, ts, g in pool.span_frames(i)
            )
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# full tracking stage


#: frames per device tracking launch
TRACK_BLOCK = 16

#: pair ranges closer than this many frames merge into one decode run
#: (re-seeking costs a keyframe-to-position decode of up to a GOP)
RANGE_MERGE_GAP = 16


def _merge_pair_ranges(
    ranges, frame_begin: int, frame_end: int
) -> list[tuple[int, int]]:
    """Clip (begin, end)-exclusive PAIR ranges to [frame_begin,
    frame_end), sort, and merge overlapping/near-adjacent ones."""
    clipped = sorted(
        (max(frame_begin, int(b)), min(frame_end, int(e)))
        for b, e in ranges
    )
    out: list[list[int]] = []
    for b, e in clipped:
        if e <= b:
            continue
        if out and b <= out[-1][1] + RANGE_MERGE_GAP:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]


def emit_track_result(
    problem, lens: lens_ops.Lens, pts: np.ndarray, pts_j: jnp.ndarray,
    height: int, frame_idx: int, tracked, ts_cur: float, ts_nxt: float,
) -> None:
    """Feed one frame pair's tracked grid into `problem`: lift both
    endpoints to unit rays, apply rolling-shutter timestamps, call
    `set_track_result` (ref: core_testcode.cpp:140-157). Shared by the
    real tracking stage and the engine compile-warming path (which
    emits zero-flow tracks purely to reproduce the window SHAPES)."""
    rays_a, rays_b = lift_rays(
        lens, pts_j, jnp.asarray(tracked, jnp.float32)
    )
    ts_a, ts_b = rolling_shutter_ts(
        lens, pts, tracked, ts_cur, ts_nxt, height
    )
    problem.set_track_result(
        frame_idx,
        np.asarray(ts_a, np.float64),
        np.asarray(ts_b, np.float64),
        np.asarray(rays_a, np.float64),
        np.asarray(rays_b, np.float64),
    )


def track_frames(
    problem,
    lens: lens_ops.Lens,
    video_path: str,
    frame_begin: int,
    frame_end: int,
    grid_step: int | None = None,
    method: str = "lk",
    progress: bool = False,
    block: int = TRACK_BLOCK,
    ranges=None,
    warm_gate: threading.Event | None = None,
) -> None:
    """Track every consecutive frame pair in [frame_begin, frame_end)
    and feed `problem.set_track_result` (ref: core_testcode.cpp:97-162).

    method: "lk" (device tracker, default: frames decode on host in
    blocks — raw-luma, decode-ahead workers — ship as u8, and every
    block's pairs track in one launch) or "dis" (host cv2 DIS dense
    flow sampled at the grid — the reference's tracker, for
    cross-validation).

    ranges: optional (begin, end)-exclusive PAIR index ranges
    restricting tracking to the pairs the engine will read — the
    pipeline passes the union of its syncpoint windows, so host H.264
    decode (the dominant real-video cost) skips inter-window frames
    entirely. The reference decodes its whole frame_range inline
    (core_testcode.cpp:99-122) but equally never reads inter-window
    pairs, so recipe outputs are identical. None = every pair.

    warm_gate: optional Event set once the tracker-critical compiles
    (the LK executable + the drain's ray-lift) have finished. The
    pipeline's engine warm (recipe._start_engine_warm) waits on this
    gate so that its big batched PreSync/Sync compiles never compete
    with the compiles that gate the tracking pipeline's start. Per-invocation
    (caller-created) so concurrent or repeated runs never cross-talk.
    """
    warm_gate = warm_gate if warm_gate is not None else threading.Event()
    if ranges is None:
        ranges = [(frame_begin, frame_end)]
    ranges = _merge_pair_ranges(ranges, frame_begin, frame_end)
    probe = VideoSource(video_path)
    width, height = probe.width, probe.height
    probe.cap.release()
    pts = grid_points(width, height, grid_step)
    pts_j = jnp.asarray(pts, jnp.float32)

    def emit(frame_idx, tracked, ts_cur, ts_nxt):
        emit_track_result(
            problem, lens, pts, pts_j, height, frame_idx, tracked,
            ts_cur, ts_nxt,
        )

    if method == "dis":
        import cv2

        dis = cv2.DISOpticalFlow.create()
        src = VideoSource(video_path)
        for pb, pe in ranges:
            it = src.frames(pb, pe + 1)
            cur = next(it)
            for nxt in it:
                if progress:
                    print(f"processing frame {cur.index}", flush=True)
                flow = dis.calc(cur.gray, nxt.gray, None)
                ij = pts.astype(int)
                tracked = pts + flow[ij[:, 1], ij[:, 0]]
                emit(cur.index, tracked, cur.timestamp, nxt.timestamp)
                cur = nxt
        return
    if method != "lk":
        raise ValueError(f"unknown tracking method {method!r}")

    # software pipeline: dispatch block k and keep up to DEPTH blocks
    # in flight; decode (host, via the decode-ahead FrameFeed
    # workers), upload, and device tracking all overlap
    # instead of serializing per block
    DEPTH = 3
    MAX_STAGED = max(
        1, int(os.environ.get("RSSYNC_TRACK_MAX_STAGED", "12"))
    )
    pending: list[tuple[list[Frame], jnp.ndarray]] = []
    staged: list[tuple[list[Frame], jnp.ndarray]] = []
    step = grid_step or auto_grid_step(width)

    # RSSYNC_TRACK_TIMING=1: per-block wall-clock of each pipeline
    # stage (decode wait / host stack+pad / upload / dispatch / drain)
    # plus absolute @t offsets — the tracker trace hook for diagnosing
    # host-vs-upload-vs-device-vs-compile bottlenecks on real clips.
    timing = os.environ.get("RSSYNC_TRACK_TIMING", "") not in ("", "0")

    # warm the single tracker executable on device-GENERATED zeros (no
    # frame upload) while the first frames decode: the XLA compile
    # otherwise serializes behind the first block
    lv = auto_levels(height, width)
    fine0 = 0 in {l for l, *_ in _fine_plan(lv, LK_ITERS, LK_RADIUS)}
    Hp, Wp = _stored_dims(height, width, "fine" if fine0 else "lane")
    warmed = threading.Event()
    tstart = time.time()

    # the grid endpoint's rays are the same for every pair: lift once
    # per clip (emit_track_result recomputes them per pair — 2 device
    # round-trips x pairs). It runs before the warm thread starts, so
    # this tiny compile never waits behind the big LK compile.
    rays_a_np = np.asarray(
        lens_ops.rays_from_normalized(
            lens_ops.undistort_points(lens, pts_j)
        ),
        np.float64,
    )

    def _warm_tracker():
        try:
            z = jnp.zeros((block + 1, Hp, Wp), jnp.uint8)
            np.asarray(lk_track_video(
                z, grid_step=step, logical_hw=(height, width)))
        except Exception:  # noqa: BLE001 — the real call will surface it
            pass
        finally:
            warmed.set()
            if timing:
                print(
                    f"# tracker warm (compile) done @{time.time()-tstart:.0f}s",
                    flush=True,
                )
        try:
            # also warm the drain's batched undistort/ray-lift
            # executable (shape (block*N, 2) — distinct from the
            # rays_a executable above; cold it cost the first drain
            # ~18 s of exposed compile)
            np.asarray(lens_ops.rays_from_normalized(
                lens_ops.undistort_points(lens, jnp.zeros(
                    (block * pts_j.shape[0], 2), jnp.float32))))
        except Exception:  # noqa: BLE001
            pass
        finally:
            warm_gate.set()

    threading.Thread(
        target=_warm_tracker, daemon=True, name="tracker-warm"
    ).start()

    def drain(p):
        """Fetch one block's tracked grids and feed set_track_result.

        The tracked endpoints of ALL pairs lift to rays in ONE device
        call (padded tail rows included, so every block reuses one
        executable) — per-pair calls cost a device round-trip each.
        Elementwise undistort is bitwise-identical either way."""
        # wait for the warm thread's ray-lift compile: the first drain
        # can otherwise submit the IDENTICAL (block*N, 2) compile a
        # second time. warm_gate is always set (finally).
        warm_gate.wait()
        p_frames, fut = p
        tracked_all = np.asarray(fut)  # (block, N, 2) f32
        rb = lens_ops.rays_from_normalized(
            lens_ops.undistort_points(
                lens, jnp.asarray(tracked_all.reshape(-1, 2))
            )
        )
        rays_b = np.asarray(rb, np.float64).reshape(
            tracked_all.shape[0], -1, 3
        )
        for i in range(len(p_frames) - 1):
            ts_a, ts_b = rolling_shutter_ts(
                lens, pts, tracked_all[i],
                p_frames[i].timestamp, p_frames[i + 1].timestamp, height,
            )
            problem.set_track_result(
                p_frames[i].index,
                np.asarray(ts_a, np.float64),
                np.asarray(ts_b, np.float64),
                rays_a_np,
                rays_b[i],
            )

    for (pb, pe), it in zip(ranges, _range_feeds(video_path, ranges)):
        carry: Frame | None = None
        done = False
        while not done:
            t0 = time.time()
            frames = [carry] if carry is not None else []
            while len(frames) < block + 1:
                try:
                    frames.append(next(it))
                except StopIteration:
                    done = True
                    break
            if len(frames) < 2:
                break
            if progress:
                print(
                    f"processing frames "
                    f"{frames[0].index}..{frames[-1].index - 1}",
                    flush=True,
                )
            t1 = time.time()
            # storage-pad on the host (free under the decode overlap):
            # skips the on-device u8 pad pass. Short
            # tail blocks pad to the full block by repeating the last
            # frame (repeated frames track to zero flow and are never
            # emitted) so ONE executable serves every block. One-copy
            # assembly (see stack_pad_host).
            stack_np = stack_pad_host(
                [f.gray for f in frames], block + 1, height, width,
                Hp, Wp,
            )
            t2 = time.time()
            stack = jnp.asarray(stack_np)  # u8 upload (async)
            t3 = time.time()
            # While the tracker executable is still compiling (the
            # warm thread), a dispatch would block this thread inside
            # the jit call and a drain would block on the executable —
            # either way the uploads idle for the whole compile.
            # Instead STAGE the uploaded block (uploads need no
            # executable) and keep decoding/uploading, bounded by
            # MAX_STAGED (each staged 2.7k block holds ~93 MB device +
            # ~93 MB host). Dispatch and drain order are unchanged, so
            # outputs are bit-identical to the blocking order.
            staged.append((frames, stack))
            # timing accumulators: several staged blocks can flush in
            # one outer iteration, so warmwait/dispatch/drain sum over
            # every flushed block instead of reporting only the last
            warmwait_s = dispatch_s = drain_s = 0.0
            t_mark = t3
            while staged and (
                warmed.is_set() or len(staged) >= MAX_STAGED
            ):
                warmed.wait()
                s_frames, s_stack = staged.pop(0)
                t4 = time.time()
                warmwait_s += t4 - t_mark
                fut = lk_track_video(
                    s_stack, grid_step=step, logical_hw=(height, width),
                )  # async dispatch; not fetched yet
                t5 = time.time()
                dispatch_s += t5 - t4
                pending.append((s_frames, fut))
                if len(pending) >= DEPTH:
                    drain(pending.pop(0))
                t_mark = time.time()
                drain_s += t_mark - t5
            if timing:
                print(
                    f"# block {frames[0].index} @{t0-tstart:.0f}s: "
                    f"decode {t1-t0:.2f} "
                    f"stack {t2-t1:.2f} upload {t3-t2:.2f} "
                    f"warmwait {warmwait_s:.2f} dispatch {dispatch_s:.2f} "
                    f"drain {drain_s:.2f}",
                    flush=True,
                )
            carry = frames[-1]
    t0 = time.time()
    if staged:  # blocks still staged when the clip ended mid-warm-up
        warmed.wait()
        for s_frames, s_stack in staged:
            pending.append((s_frames, lk_track_video(
                s_stack, grid_step=step, logical_hw=(height, width),
            )))
        staged.clear()
    for p in pending:
        drain(p)
    if timing:
        print(f"# final drain {time.time()-t0:.2f}", flush=True)
