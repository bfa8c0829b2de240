"""RANSAC-style translation-direction guesser, vmapped over hypotheses.

JAX rebuild of `opt_guess_translational_motion`
(ref: src/core/core_private.cpp:34-59): hypotheses are cross products
of two distinct random rows of the *raw* residual matrix P; each is
scored by the 25th-percentile squared residual of the *row-normalized*
P against the hypothesis (the code uses n_rows/4 — the thesis says
median, the code quartile; we follow the code per SURVEY §2.1); the
best of `iters` hypotheses wins.

Differences by design:
* deterministic keyed `jax.random` instead of the reference's
  `std::random_device`-seeded thread-local MT19937
  (ref: src/core_support/inline_utils.hpp:13-17) — runs reproduce.
* distinct pairs come from an arithmetic shift instead of a rejection
  loop: r1 drawn from [0, count-2] then incremented when r1 >= r0.
  Exactly uniform over distinct ordered pairs, fixed shape.
* all `iters` hypotheses are evaluated in one batched computation
  (sort over the feature axis) instead of a sequential loop.
* P is SoA: (3, N) with features along the minor (lane) axis — see
  core/problem.py layout note.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rssync_tpu.core.problem import cross_soa
from rssync_tpu.ops.pallas_score import BISECT_ROUNDS, MARKOV_C, score_quartile


def sample_pairs(key: jax.Array, iters: int, count) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Draw `iters` ordered pairs of distinct row indices in [0, count).

    `count` may be a traced int32 scalar (valid rows of a padded frame).
    Degenerate frames (count < 2) produce indices clamped into range;
    callers mask those frames out downstream.
    """
    k0, k1 = jax.random.split(key)
    c = jnp.maximum(count, 2)
    r0 = jax.random.randint(k0, (iters,), 0, c)
    r1 = jax.random.randint(k1, (iters,), 0, c - 1)
    r1 = r1 + (r1 >= r0)
    return r0, r1


def guess_motion_from_pairs(
    P: jnp.ndarray, count, r0: jnp.ndarray, r1: jnp.ndarray
) -> jnp.ndarray:
    """Pick the best translation-direction hypothesis given sampled pairs.

    P: (3, N) residual rows SoA (padded columns zero). count: () int32.
    r0/r1: (iters,) row indices. Returns (3,) unit direction.
    """
    N = P.shape[-1]
    # row-normalized copy for scoring (ref :36-37, safe_normalize:
    # rows with norm < 1e-12 stay unnormalized)
    Pn2 = jnp.sum(P * P, axis=0)  # (N,)
    inv = jnp.where(Pn2 < 1e-24, 1.0, jax.lax.rsqrt(jnp.maximum(Pn2, 1e-30)))
    nP = P * inv[None]

    # hypotheses from RAW rows (ref :42-43)
    v = cross_soa(P[:, r0], P[:, r1])  # (3, iters)
    vn2 = jnp.sum(v * v, axis=0)
    vinv = jnp.where(vn2 < 1e-24, 1.0, jax.lax.rsqrt(jnp.maximum(vn2, 1e-30)))
    v = v * vinv[None]

    res = jnp.einsum(
        "ci,cn->in", v, nP, precision=jax.lax.Precision.HIGHEST
    )  # (iters, N)
    res2 = res * res
    valid = (jnp.arange(N) < count)[None, :]
    # quartile of the VALID rows (ref :51-52 with n_rows == count):
    # k-th smallest via value bisection instead of a full sort of the
    # feature axis. The compare buffer is bf16 (same 8-bit exponent as
    # f32 — the ~1e-12..1 squared-residual range is representable;
    # half the bytes of each re-read) and BISECT_ROUNDS halvings of
    # the Markov bracket resolve the quantile far below the
    # hypothesis-RNG noise that already decides near-tied hypotheses.
    k = jnp.maximum(count, 1) // 4
    res2m = jnp.where(valid, res2, jnp.inf).astype(jnp.bfloat16)
    lo = jnp.zeros((res2.shape[0],), res2.dtype)
    # Markov upper bracket: > half the valid values sit at or below
    # 2*mean, so it always brackets the quartile and is far tighter
    # than max on these heavy-tailed residuals (ops/pallas_score.py,
    # kept numerically identical here)
    masked = jnp.where(valid, res2, 0.0)
    mu = jnp.sum(masked, axis=-1) / jnp.maximum(count, 1)
    hi = jnp.minimum(jnp.max(masked, axis=-1), MARKOV_C * mu)

    def bisect(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum(res2m <= mid[:, None].astype(jnp.bfloat16), axis=-1)
        ge = cnt >= k + 1
        return jnp.where(ge, lo, mid), jnp.where(ge, mid, hi)

    lo, hi = jax.lax.fori_loop(0, BISECT_ROUNDS, bisect, (lo, hi))
    med = hi  # upper bound brackets the k-th smallest
    best = jnp.argmin(med)
    v_best = v[:, best]
    # Degenerate-frame guard (deviation from the reference, which keeps
    # the unnormalized tiny cross product — harmless in f64, fatal in
    # f32: ||M||^4 underflows in the loss gradient). When every
    # hypothesis is near-zero (all P rows ~ 0, i.e. the delay is
    # already perfect for a pure-rotation frame), any unit direction
    # fits the zero residuals equally well; pick +z.
    tiny = jnp.sum(v_best * v_best) < 1e-12
    fallback = jnp.asarray([0.0, 0.0, 1.0], v_best.dtype)
    return jnp.where(tiny, fallback, v_best)


def guess_motion(
    P: jnp.ndarray, count, key: jax.Array, iters: int
) -> jnp.ndarray:
    """Full guesser: sample pairs then score
    (ref: core_private.cpp:34-59). iters is static (20 in PreSync,
    200 in Sync's GuessMotion)."""
    r0, r1 = sample_pairs(key, iters, count)
    return guess_motion_from_pairs(P, count, r0, r1)


def guess_motion_window(
    P: jnp.ndarray, counts, key: jax.Array, iters: int,
    impl: str | None = None,
) -> jnp.ndarray:
    """Whole-window guesser: every frame's RANSAC in one batched
    computation. P: (3, F, N) SoA; counts: (F,). Returns (F, 3).

    Pair draws are identical to `vmap(guess_motion)` over the same
    per-frame key split. Hypothesis rows are selected with exact
    one-hot matmuls (0/1 weights at HIGHEST precision — bitwise equal
    to fancy indexing). Scoring goes through
    ops/pallas_score.score_quartile (`impl`: None = the backend's
    choice, "triton" or "xla").
    """
    F = P.shape[1]
    keys = jax.random.split(key, F)
    r0, r1 = jax.vmap(lambda k, c: sample_pairs(k, iters, c))(
        keys, counts
    )  # (F, iters) each
    return guess_motion_rows(P, counts, r0, r1, impl)


def guess_motion_window_batched(
    P: jnp.ndarray, counts: jnp.ndarray, keys: jnp.ndarray, iters: int,
    impl: str | None = None,
) -> jnp.ndarray:
    """A BATCH of whole-window guessers: P (B, 3, F, N), counts
    (B, F), keys (B, 2) — per-batch key splits identical to
    `vmap(guess_motion_window)` over the batch axis (PreSync flattens
    delay-chunk x windows into B). Same math; the scoring kernel takes
    the batch axis directly (one launch over B x F rows). Returns
    (B, F, 3)."""
    B, _, F, N = P.shape

    def prelude(P1, c1, k1):
        kf = jax.random.split(k1, F)
        r0, r1 = jax.vmap(lambda k, c: sample_pairs(k, iters, c))(kf, c1)
        Pn2 = jnp.sum(P1 * P1, axis=0)
        inv = jnp.where(
            Pn2 < 1e-24, 1.0, jax.lax.rsqrt(jnp.maximum(Pn2, 1e-30))
        )
        nP = P1 * inv[None]

        def onehot(r):
            return (
                jnp.arange(N)[None, None, :] == r[..., None]
            ).astype(P1.dtype)

        A = jnp.einsum(
            "cfn,fin->cfi", P1, onehot(r0),
            precision=jax.lax.Precision.HIGHEST,
        )
        Bm = jnp.einsum(
            "cfn,fin->cfi", P1, onehot(r1),
            precision=jax.lax.Precision.HIGHEST,
        )
        v = cross_soa(A, Bm)
        vn2 = jnp.sum(v * v, axis=0)
        vinv = jnp.where(
            vn2 < 1e-24, 1.0, jax.lax.rsqrt(jnp.maximum(vn2, 1e-30))
        )
        return nP, v * vinv[None]

    nP, v = jax.vmap(prelude)(P, counts, keys)
    med = score_quartile(nP, v, counts, impl)  # (B, F, I)

    best = jnp.argmin(med, axis=-1)  # (B, F)
    sel = (jnp.arange(iters)[None, None, :] == best[..., None]).astype(
        P.dtype)
    vb = jnp.einsum(  # exact one-hot select
        "bcfi,bfi->bfc", v, sel, precision=jax.lax.Precision.HIGHEST)
    tiny = jnp.sum(vb * vb, axis=-1) < 1e-12
    fallback = jnp.asarray([0.0, 0.0, 1.0], vb.dtype)
    return jnp.where(tiny[..., None], fallback[None, None], vb)


def guess_motion_rows(
    P: jnp.ndarray, counts, r0: jnp.ndarray, r1: jnp.ndarray,
    impl: str | None = None,
) -> jnp.ndarray:
    """Row-batched guesser core: each of the F rows of P (3, F, N) is
    an independent RANSAC problem with its own pre-drawn pairs. The
    row axis may be any flattening of batch axes."""
    N = P.shape[2]
    iters = r0.shape[-1]

    Pn2 = jnp.sum(P * P, axis=0)  # (F, N)
    inv = jnp.where(Pn2 < 1e-24, 1.0, jax.lax.rsqrt(jnp.maximum(Pn2, 1e-30)))
    nP = P * inv[None]

    def onehot(r):
        return (jnp.arange(N)[None, None, :] == r[..., None]).astype(P.dtype)

    A = jnp.einsum(
        "cfn,fin->cfi", P, onehot(r0),
        precision=jax.lax.Precision.HIGHEST,
    )
    Bm = jnp.einsum(
        "cfn,fin->cfi", P, onehot(r1),
        precision=jax.lax.Precision.HIGHEST,
    )
    v = cross_soa(A, Bm)  # (3, F, iters)
    vn2 = jnp.sum(v * v, axis=0)
    vinv = jnp.where(vn2 < 1e-24, 1.0, jax.lax.rsqrt(jnp.maximum(vn2, 1e-30)))
    v = v * vinv[None]

    med = score_quartile(nP, v, counts, impl)  # (F, iters)

    best = jnp.argmin(med, axis=-1)  # (F,)
    sel = (jnp.arange(iters)[None, :] == best[:, None]).astype(P.dtype)
    vb = jnp.einsum(  # exact one-hot select
        "cfi,fi->fc", v, sel, precision=jax.lax.Precision.HIGHEST)
    tiny = jnp.sum(vb * vb, axis=-1) < 1e-12
    fallback = jnp.asarray([0.0, 0.0, 1.0], vb.dtype)
    return jnp.where(tiny[:, None], fallback[None], vb)
