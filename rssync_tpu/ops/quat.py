"""Batched quaternion algebra.

JAX equivalent of the reference quaternion library
(ref: src/core_support/quat.cpp:5-101). Quaternions are arrays of shape
(..., 4) in (w, x, y, z) order; 3-vectors are (..., 3). Every function
broadcasts over leading axes and is safe under jit/vmap/grad: the
small-angle branches of the reference become `jnp.where` selections with
guarded denominators so gradients stay finite.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-30


def from_axis_angle(aa: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle (rotation vector) -> unit quaternion.

    Matches the Ceres-style small-angle guard of the reference
    (ref: src/core_support/quat.cpp:5-17): for theta^2 > 0 the exact
    formula, otherwise the first-order expansion k = 1/2.
    """
    aa = jnp.asarray(aa)
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    half = 0.5 * theta
    k = jnp.where(theta2 > 0.0, jnp.sin(half) / theta, 0.5)
    w = jnp.where(theta2 > 0.0, jnp.cos(half), jnp.ones_like(theta))
    return jnp.concatenate([w, aa * k], axis=-1)


def to_axis_angle(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion -> axis-angle (ref: src/core_support/quat.cpp:19-31)."""
    q = jnp.asarray(q)
    w = q[..., :1]
    xyz = q[..., 1:]
    sin2 = jnp.sum(xyz * xyz, axis=-1, keepdims=True)
    sin_t = jnp.sqrt(jnp.maximum(sin2, _EPS))
    # atan2 branch: take the representation with |angle| <= pi.
    two_theta = 2.0 * jnp.where(
        w < 0.0, jnp.arctan2(-sin_t, -w), jnp.arctan2(sin_t, w)
    )
    k = jnp.where(sin2 > 0.0, two_theta / sin_t, 2.0)
    return xyz * k


def mul(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product p*q (ref: src/core_support/quat.cpp:33-38)."""
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
        ],
        axis=-1,
    )


def conj(q: jnp.ndarray) -> jnp.ndarray:
    """Conjugate (ref: src/core_support/quat.cpp:40-43)."""
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def rotate_point(q: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Rotate 3-vector p by quaternion q: vec(q * (0,p) * q^-1).

    (ref: src/core_support/quat.cpp:45-47). Expanded to the standard
    rotation-matrix-free form (2 cross products) — cheaper elementwise
    than two Hamilton products and exactly equal for unit q. For
    non-unit q the reference computes q*(0,p)*conj(q) which scales the
    result by |q|^2; we replicate that scaling.
    """
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, p)
    return (
        p * (w * w - jnp.sum(u * u, axis=-1, keepdims=True))
        + 2.0 * u * jnp.sum(u * p, axis=-1, keepdims=True)
        + 2.0 * w * uv
    )


def normalize(q: jnp.ndarray, eps: float = 1e-30) -> jnp.ndarray:
    """q / |q| with guarded denominator."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def slerp(p: jnp.ndarray, q: jnp.ndarray, t) -> jnp.ndarray:
    """Spherical linear interpolation with antipodal flip and
    small-angle lerp fallback (ref: src/core_support/quat.cpp:55-74).

    `t` broadcasts against the leading axes of p/q.
    """
    t = jnp.asarray(t)[..., None] if jnp.ndim(t) == jnp.ndim(p) - 1 else jnp.asarray(t)
    d = jnp.sum(p * q, axis=-1, keepdims=True)
    q = jnp.where(d < 0.0, -q, q)
    d = jnp.abs(d)
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    big = theta > 1e-9
    safe_sin = jnp.where(big, sin_theta, 1.0)
    m1 = jnp.where(big, jnp.sin((1.0 - t) * theta) / safe_sin, 1.0 - t)
    m2 = jnp.where(big, jnp.sin(t * theta) / safe_sin, t)
    return m1 * p + m2 * q


def _double(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    return 2.0 * jnp.sum(p * q, axis=-1, keepdims=True) * q - p


def _bisect(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (p + q)


def squad(p0, p1, p2, p3, t) -> jnp.ndarray:
    """Cubic quaternion interpolation between p1 and p2, slerp-based
    de Casteljau (ref: src/core_support/quat.cpp:76-87; unused by the
    reference engine but part of the public math surface)."""
    a0 = _bisect(_double(p0, p1), p2)
    a1 = _bisect(_double(p1, p2), p3)
    b1 = _double(a1, p2)
    i0, i1, i2, i3 = p1, (a0 + 2.0 * p1) / 3.0, (b1 + 2.0 * p2) / 3.0, p2
    j0 = slerp(i0, i1, t)
    j1 = slerp(i1, i2, t)
    j2 = slerp(i2, i3, t)
    return slerp(slerp(j0, j1, t), slerp(j1, j2, t), t)


def _lerp(p, q, t):
    return p * (1.0 - t) + q * t


def quad(p0, p1, p2, p3, t) -> jnp.ndarray:
    """Lerp-based Bezier variant of squad (ref: src/core_support/quat.cpp:91-101)."""
    t = jnp.asarray(t)[..., None] if jnp.ndim(t) == jnp.ndim(p1) - 1 else jnp.asarray(t)
    a0 = _bisect(_double(p0, p1), p2)
    a1 = _bisect(_double(p1, p2), p3)
    b1 = _double(a1, p2)
    a0 = (a0 + 2.0 * p1) / 3.0
    b1 = (b1 + 2.0 * p2) / 3.0
    j0 = _lerp(p1, a0, t)
    j1 = _lerp(a0, b1, t)
    j2 = _lerp(b1, p2, t)
    return _lerp(_lerp(j0, j1, t), _lerp(j1, j2, t), t)
