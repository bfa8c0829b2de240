"""Uniform-grid natural cubic splines, split host-fit / device-eval.

JAX rebuild of the reference's `spline` + `ndspline`
(ref: src/core_support/minispline.cpp:3-64, ndspline.cpp:13-27).

Design: the reference fits one scalar spline per quaternion row with a
custom tridiagonal elimination and evaluates with Horner + linear-ish
extrapolation. Fitting happens once per `SetGyroQuaternions` and is
O(n) — it stays on the **host in float64** (numpy Thomas solve over all
rows at once). Evaluation happens millions of times inside the vmapped
loss — it runs on **device** as a gather + Horner over a precomputed
coefficient table.

Precision scheme (the reason this module looks different from the
reference): f32 on the device cannot represent `(ts - quats_start + delay) *
sample_rate` (ref: src/core/core_private.cpp:18-19) for clips ~100 s
long at sub-microsecond resolution. We therefore split every evaluation
position into `i0` (int32 knot index at delay=0, computed on host in
f64) plus a small f32 residual `f0 + delay * sample_rate`; the device
only ever adds small f32 numbers, giving < 100 ns effective time
resolution regardless of clip length.

Boundary semantics replicate the reference exactly for x <= n
(ref: minispline.cpp:48-55): inside [0, n-1] the cubic; for x < 0 a
quadratic continuation of segment 0; for x > n-1 a quadratic
continuation of segment n-1 (whose c coefficient is 0, so effectively
linear). The reference additionally has a far-extrapolation quirk for
x >= n (its `h` is measured from min(floor(x), n) while coefficients
stay at n-1, producing a jump at x = n); all eval sites here REPLICATE
that discontinuity (golden-verified vs the compiled reference engine;
see golden/README.md and the `ref quirk` comments below).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def fit_natural_cubic(y: np.ndarray) -> np.ndarray:
    """Fit natural cubic splines to uniformly-indexed samples.

    y: (R, n) float64 — R independent rows sampled at x = 0..n-1.
    Returns coeffs (n, R, 4) float64 ordered (y, b, c, d) so that on
    segment i (x = i + h, 0 <= h < 1):

        f(x) = ((d_i * h + c_i) * h + b_i) * h + y_i

    Matches the linear system of ref minispline.cpp:3-46: natural
    boundary (c_0 = c_{n-1} = 0), interior rows
    (1/3) c_{i-1} + (4/3) c_i + (1/3) c_{i+1} = y_{i+1} - 2 y_i + y_{i-1},
    then d_i = (c_{i+1} - c_i)/3,
    b_i = (y_{i+1} - y_i) - (2 c_i + c_{i+1})/3 for i < n-1, and the
    end-segment continuation d_{n-1} = 0,
    b_{n-1} = 3 d_{n-2} + 2 c_{n-2} + b_{n-2}.
    """
    y = np.asarray(y, dtype=np.float64)
    if y.ndim == 1:
        y = y[None, :]
    R, n = y.shape
    if n < 3:
        # Degenerate: fall back to linear interpolation coefficients.
        c = np.zeros_like(y)
        d = np.zeros_like(y)
        b = np.zeros_like(y)
        if n == 2:
            b[:, 0] = y[:, 1] - y[:, 0]
            b[:, 1] = y[:, 1] - y[:, 0]
        return np.stack([y, b, c, d], axis=-1).transpose(1, 0, 2)

    # Thomas solve of the tridiagonal system, vectorized over rows.
    # Diagonals: lower = upper = 1/3 on interior rows, main = 4/3
    # interior and 2 at the ends (with 0 off-diagonals there).
    lo = np.full(n, 1.0 / 3.0)
    mid = np.full(n, 4.0 / 3.0)
    up = np.full(n, 1.0 / 3.0)
    lo[0] = lo[-1] = 0.0
    up[0] = up[-1] = 0.0
    mid[0] = mid[-1] = 2.0
    rhs = np.zeros((R, n))
    rhs[:, 1:-1] = y[:, 2:] - 2.0 * y[:, 1:-1] + y[:, :-2]

    cp = np.zeros(n)
    dp = np.zeros((R, n))
    cp[0] = up[0] / mid[0]
    dp[:, 0] = rhs[:, 0] / mid[0]
    for i in range(1, n):
        denom = mid[i] - lo[i] * cp[i - 1]
        cp[i] = up[i] / denom
        dp[:, i] = (rhs[:, i] - lo[i] * dp[:, i - 1]) / denom
    c = np.zeros((R, n))
    c[:, -1] = dp[:, -1]
    for i in range(n - 2, -1, -1):
        c[:, i] = dp[:, i] - cp[i] * c[:, i + 1]

    d = np.zeros((R, n))
    b = np.zeros((R, n))
    d[:, :-1] = (c[:, 1:] - c[:, :-1]) / 3.0
    b[:, :-1] = (y[:, 1:] - y[:, :-1]) - (2.0 * c[:, :-1] + c[:, 1:]) / 3.0
    d[:, -1] = 0.0
    b[:, -1] = 3.0 * d[:, -2] + 2.0 * c[:, -2] + b[:, -2]

    return np.stack([y, b, c, d], axis=-1).transpose(1, 0, 2)  # (n, R, 4)


def pack_table(coeffs: np.ndarray) -> np.ndarray:
    """Repack host-fit coefficients (n, R, 4) into the device layout
    (4*R, n): row R*c + r holds coefficient c (0=y,1=b,2=c,3=d) of
    spline row r, knots along the LAST axis.

    Layout rationale: gathers index the knot axis; with knots last,
    a gather yields (4R, ...batch) — small structure dims leading, big
    batch dims minor. The transposed layout would put a (batch, 4, 4)
    gather output's size-4 axes minor, which a tiled layout pads many
    times over."""
    n, R, _ = coeffs.shape
    return np.ascontiguousarray(coeffs.transpose(2, 1, 0).reshape(4 * R, n))


def eval_spline_packed(
    packed: jnp.ndarray, i0: jnp.ndarray, p: jnp.ndarray
) -> jnp.ndarray:
    """Evaluate R splines at x = i0 + p from the packed (4R, n) table.

    Returns (R, ...) — row axis LEADING (SoA). Same boundary semantics
    as eval_spline.
    """
    R4, n = packed.shape
    R = R4 // 4
    pf = jnp.floor(p)
    xi = i0 + pf.astype(jnp.int32)
    h_in = p - pf
    idx = jnp.clip(xi, 0, n - 1)
    # one 1-D gather per coefficient row: each output is exactly the
    # batch shape (no small trailing axis for the (8,128) tiling to
    # pad — a single (..., 16) gather materializes 8x larger)
    g = jnp.stack([jnp.take(packed[k], idx) for k in range(R4)])  # (4R, ...)
    yk, bk, ck, dk = g[:R], g[R : 2 * R], g[2 * R : 3 * R], g[3 * R :]

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


def eval_spline(
    coeffs: jnp.ndarray, i0: jnp.ndarray, p: jnp.ndarray
) -> jnp.ndarray:
    """Evaluate R splines at positions x = i0 + p. Device hot path.

    coeffs: (n, R, 4) — (y, b, c, d) per knot per row (f32 on device).
    i0:     (...,) int32 — integer base positions (host-precomputed).
    p:      (...,) float — small fractional offsets; the *effective*
            position is x = i0 + p but x itself is never formed in
            full precision: only floor(p) is folded into the index.
    Returns (..., R).

    Equivalent of ndspline::eval (ref: ndspline.cpp:21-27) with the
    boundary behavior of minispline.cpp:48-55 (see module docstring).
    """
    n = coeffs.shape[0]
    pf = jnp.floor(p)
    xi = i0 + pf.astype(jnp.int32)  # floor(x), exact
    h_in = p - pf  # in [0, 1), full f32 precision

    idx = jnp.clip(xi, 0, n - 1)
    cf = jnp.take(coeffs, idx, axis=0)  # (..., R, 4)
    yk, bk, ck, dk = cf[..., 0], cf[..., 1], cf[..., 2], cf[..., 3]

    below = xi < 0
    above = xi > n - 2  # x > n-1 (and the exact x == n-1 boundary,
    #                     where cubic(h=0) == quadratic(h=0) == y_{n-1})

    # h for the extrapolation branches: distance from the clamped end
    # knot. |xi - end| is a small int, so f32 is exact here.
    h_lo = (xi - 0).astype(h_in.dtype) + h_in  # = x, for x < 0
    h_hi = (xi - (n - 1) - (xi >= n).astype(xi.dtype)).astype(
        h_in.dtype) + h_in  # ref quirk: idx=min(floor(x), n), so h
    #   measures from knot n (one past the end) once x >= n —
    #   discontinuous at x == n (minispline.cpp:49-53); replicated
    h = jnp.where(below, h_lo, jnp.where(above, h_hi, h_in))[..., None]

    cubic = ((dk * h + ck) * h + bk) * h + yk
    quad = (ck * h + bk) * h + yk
    return jnp.where((below | above)[..., None], quad, cubic)


def rotational_deriv(
    coeffs: jnp.ndarray, i0: jnp.ndarray, p: jnp.ndarray
) -> jnp.ndarray:
    """Angular-velocity quaternion of a quaternion spline:
    2 * conj(q) * q' / |q|^2 (ref: ndspline::rderiv, ndspline.cpp:45-49).
    coeffs must hold exactly 4 rows (w, x, y, z). Returns (..., 4)
    whose vector part is the body angular rate in spline-index units.
    """
    from rssync_tpu.ops import quat as quat_ops

    q = eval_spline(coeffs, i0, p)
    dq = eval_spline_deriv(coeffs, i0, p)
    n2 = jnp.maximum(jnp.sum(q * q, axis=-1, keepdims=True), 1e-30)
    return 2.0 * quat_ops.mul(quat_ops.conj(q), dq) / n2


def rotational_deriv_numeric(
    coeffs: jnp.ndarray, i0: jnp.ndarray, p: jnp.ndarray, eps: float = 1e-7
) -> jnp.ndarray:
    """Numeric-difference variant (ref: ndspline::rderiv_numeric,
    ndspline.cpp:37-43): conj(normalize(q(t))) * normalize(q(t+eps)) /
    eps with the scalar part zeroed. NOTE: the reference formula lacks
    the factor 2 of `rotational_deriv`, so this returns HALF the body
    angular rate — replicated as-is (both are unused by the engine)."""
    from rssync_tpu.ops import quat as quat_ops

    q_l = quat_ops.normalize(eval_spline(coeffs, i0, p))
    q_r = quat_ops.normalize(eval_spline(coeffs, i0, p + eps))
    out = quat_ops.mul(quat_ops.conj(q_l), q_r) / eps
    return out.at[..., 0].set(0.0)


def eval_spline_deriv(
    coeffs: jnp.ndarray, i0: jnp.ndarray, p: jnp.ndarray
) -> jnp.ndarray:
    """d/dx of eval_spline (ref: minispline.cpp:57-64, ndspline.cpp:29-35)."""
    n = coeffs.shape[0]
    pf = jnp.floor(p)
    xi = i0 + pf.astype(jnp.int32)
    h_in = p - pf
    idx = jnp.clip(xi, 0, n - 1)
    cf = jnp.take(coeffs, idx, axis=0)
    bk, ck, dk = cf[..., 1], cf[..., 2], cf[..., 3]
    below = xi < 0
    above = xi > n - 2
    h_lo = (xi - 0).astype(h_in.dtype) + h_in
    h_hi = (xi - (n - 1) - (xi >= n).astype(xi.dtype)).astype(
        h_in.dtype) + h_in  # ref quirk: idx=min(floor(x), n), so h
    #   measures from knot n (one past the end) once x >= n —
    #   discontinuous at x == n (minispline.cpp:49-53); replicated
    h = jnp.where(below, h_lo, jnp.where(above, h_hi, h_in))[..., None]
    cubic = (3.0 * dk * h + 2.0 * ck) * h + bk
    quad = 2.0 * ck * h + bk
    return jnp.where((below | above)[..., None], quad, cubic)
