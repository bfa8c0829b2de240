"""Fisheye (Kannala-Brandt / OpenCV-fisheye) lens model, batched.

JAX rebuild of the reference's inverse-distortion Newton solver
(ref: src/core_testcode.cpp:56-95). The reference undistorts one pixel
at a time with 9 Newton iterations and a bisection safeguard; here the
whole feature grid is one vmapped fixed-unroll computation, and the
safeguard's data-dependent `while` becomes a fixed-count halving loop
(each halving moves the iterate geometrically toward the previous
in-range theta, so 40 steps are more than any double-precision case
can need).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp


@dataclass(frozen=True)
class Lens:
    """Lens parameters (ref: src/core_testcode.cpp:56-61).

    ro: rolling-shutter readout time in seconds (full frame).
    fx, fy, cx, cy: pinhole intrinsics in pixels.
    k1..k4: Kannala-Brandt theta-polynomial distortion coefficients.
    """

    ro: float = 0.0
    fx: float = 1.0
    fy: float = 1.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.ro, self.fx, self.fy, self.cx, self.cy,
             self.k1, self.k2, self.k3, self.k4],
            dtype=np.float64,
        )


def distort_theta(theta, k1, k2, k3, k4):
    """Forward distortion polynomial theta_d(theta) =
    theta + k1 th^3 + k2 th^5 + k3 th^7 + k4 th^9."""
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def undistort_points(lens: Lens, points: jnp.ndarray,
                     num_iterations: int = 9) -> jnp.ndarray:
    """Invert the fisheye model for pixel coordinates -> normalized
    image plane coordinates (x/z, y/z).

    points: (..., 2) pixel coordinates. Returns (..., 2).

    Replicates ref src/core_testcode.cpp:63-95: normalize by
    intrinsics, then 9 Newton iterations on theta starting at pi/4 with
    a bisection safeguard keeping theta in (0, pi/2), then scale by
    tan(theta)/theta_d. Two deliberate details:

    * the reference's early-out `|point| < 1e-8 -> (0,0)` tests the RAW
      pixel coordinates (a quirk — it only fires for the image corner);
      replicated as-is for parity.
    * the reference's Newton derivative has `8*k4*theta^8` where the
      true derivative term is `9*k4*theta^8` (core_testcode.cpp:80-81).
      Newton still converges to the same root (the residual, not the
      derivative, defines the fixed point), so we use the correct 9.
    """
    pts = jnp.asarray(points)
    dtype = pts.dtype
    x_ = (pts[..., 0] - lens.cx) / lens.fx
    y_ = (pts[..., 1] - lens.cy) / lens.fy
    theta_d = jnp.sqrt(x_ * x_ + y_ * y_)

    k1, k2, k3, k4 = (dtype.type(k) if hasattr(dtype, "type") else k
                      for k in (lens.k1, lens.k2, lens.k3, lens.k4))

    half_pi = jnp.asarray(np.pi / 2.0, dtype)
    theta = jnp.full_like(theta_d, np.pi / 4.0)
    for _ in range(num_iterations):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        cur = distort_theta(theta, k1, k2, k3, k4)
        dcur = 1.0 + 3.0 * k1 * t2 + 5.0 * k2 * t4 + 7.0 * k3 * t6 + 9.0 * k4 * t8
        new_theta = theta - (cur - theta_d) / dcur
        # Bisection safeguard: halve back toward the (in-range) previous
        # iterate while outside (0, pi/2). Fixed unroll of the
        # data-dependent while at core_testcode.cpp:85-87.
        for _ in range(40):
            bad = (new_theta >= half_pi) | (new_theta <= 0.0)
            new_theta = jnp.where(bad, 0.5 * (new_theta + theta), new_theta)
        theta = new_theta

    r = jnp.tan(theta)
    inv_cos = 1.0 / jnp.cos(theta)
    s = jnp.where(theta_d < 1e-9, inv_cos, r / jnp.maximum(theta_d, 1e-30))

    out = jnp.stack([x_ * s, y_ * s], axis=-1)
    # Raw-pixel-norm early-out quirk, replicated (core_testcode.cpp:64).
    raw_zero = jnp.linalg.norm(pts, axis=-1, keepdims=True) < 1e-8
    return jnp.where(raw_zero, jnp.zeros_like(out), out)


def distort_points(lens: Lens, xy: jnp.ndarray) -> jnp.ndarray:
    """Forward model: normalized image plane (x/z, y/z) -> pixels.
    Used by tests to verify undistort round-trips, and by synthetic
    scene generation. Not present in the reference (it only inverts)."""
    xy = jnp.asarray(xy)
    r = jnp.sqrt(jnp.sum(xy * xy, axis=-1))
    theta = jnp.arctan(r)
    td = distort_theta(theta, lens.k1, lens.k2, lens.k3, lens.k4)
    scale = jnp.where(r < 1e-12, 1.0, td / jnp.maximum(r, 1e-30))
    u = xy[..., 0] * scale * lens.fx + lens.cx
    v = xy[..., 1] * scale * lens.fy + lens.cy
    return jnp.stack([u, v], axis=-1)


def rays_from_normalized(xy: jnp.ndarray) -> jnp.ndarray:
    """Lift normalized image-plane points to unit rays
    normalize([x, y, 1]) (ref: core_testcode.cpp:147-152)."""
    ones = jnp.ones_like(xy[..., :1])
    v = jnp.concatenate([xy, ones], axis=-1)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)
