"""Parity tests for the Pallas (Triton) RANSAC-scoring kernel in
interpreter mode on the CPU against the plain XLA bisection, for the
backend choice between them, and for the whole-window guesser against
the original per-frame vmap path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rssync_tpu.core.ransac import (
    guess_motion,
    guess_motion_window,
    sample_pairs,
)
from rssync_tpu.ops.pallas_score import (
    score_quartile,
    score_quartile_triton,
    score_quartile_xla,
)

def _problem(rng, F=7, N=40, I=20):
    P = rng.normal(size=(3, F, N)).astype(np.float32) * 0.1
    counts = rng.integers(5, N + 1, size=(F,)).astype(np.int32)
    for f in range(F):
        P[:, f, counts[f]:] = 0.0
    Pn2 = np.sum(P * P, axis=0)
    inv = np.where(Pn2 < 1e-24, 1.0, 1.0 / np.sqrt(np.maximum(Pn2, 1e-30)))
    nP = (P * inv[None]).astype(np.float32)
    v = rng.normal(size=(3, F, I)).astype(np.float32)
    v /= np.maximum(np.linalg.norm(v, axis=0, keepdims=True), 1e-12)
    return jnp.asarray(P), jnp.asarray(nP), jnp.asarray(v), jnp.asarray(counts)


def test_kernel_matches_xla_scoring(rng):
    _, nP, v, counts = _problem(rng)
    a = np.asarray(score_quartile_triton(nP, v, counts, interpret=True))
    b = np.asarray(score_quartile_xla(nP, v, counts))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_kernel_matches_xla_scoring_tiled(rng):
    """200 hypotheses span several hypothesis blocks, the last one
    partial (Sync's GuessMotion shape); hyp_block=8 forces more of
    them than the default."""
    _, nP, v, counts = _problem(rng, F=37, N=24, I=200)
    a = np.asarray(score_quartile_triton(
        nP, v, counts, interpret=True, hyp_block=8))
    b = np.asarray(score_quartile_xla(nP, v, counts))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_kernel_matches_vmapped(rng):
    """A leading batch axis is flattened with the frame axis into the
    kernel's row axis: same values as vmapping the XLA path."""
    B = 3
    packs = [_problem(rng) for _ in range(B)]
    nP = jnp.stack([p[1] for p in packs])
    v = jnp.stack([p[2] for p in packs])
    counts = jnp.stack([p[3] for p in packs])
    a = np.asarray(score_quartile_triton(nP, v, counts, interpret=True))
    b = np.asarray(
        jax.vmap(score_quartile_xla)(nP, v, counts)
    )
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_batched_kernel_matches_vmapped(rng):
    """The batched call equals the per-problem kernel bit for bit (the
    row index is the only thing batching changes) and the XLA path."""
    B = 5
    packs = [_problem(rng) for _ in range(B)]
    nP = jnp.stack([p[1] for p in packs])
    v = jnp.stack([p[2] for p in packs])
    counts = jnp.stack([p[3] for p in packs])
    a = np.asarray(score_quartile_triton(nP, v, counts, interpret=True))
    b = np.asarray(jax.vmap(score_quartile_xla)(nP, v, counts))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    c = np.stack([
        np.asarray(score_quartile_triton(
            nP[i], v[i], counts[i], interpret=True))
        for i in range(B)
    ])
    np.testing.assert_array_equal(a, c)


def test_batched_window_guesser_matches_vmapped(rng):
    """guess_motion_window_batched == vmap(guess_motion_window) for
    the same per-batch keys (the delay-blocked PreSync restructure
    must not change selected motions)."""
    from rssync_tpu.core.ransac import guess_motion_window_batched

    B = 4
    Ps, counts = [], []
    for _ in range(B):
        P, _, _, c = _problem(rng, F=9, N=33)
        Ps.append(P)
        counts.append(c)
    P = jnp.stack(Ps)
    counts = jnp.stack(counts)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    ref = jax.vmap(
        lambda p, c, k: guess_motion_window(p, c, k, 20, impl="xla")
    )(P, counts, keys)
    got = guess_motion_window_batched(P, counts, keys, 20, impl="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_window_guesser_matches_per_frame(rng):
    """guess_motion_window == vmap(guess_motion) for the same key
    split (the PreSync refactor must not change selected motions)."""
    P, _, _, counts = _problem(rng, F=9, N=33)
    key = jax.random.PRNGKey(7)
    F = P.shape[1]
    keys = jax.random.split(key, F)
    ref = jax.vmap(
        lambda p, c, k: guess_motion(p, c, k, 20), in_axes=(1, 0, 0)
    )(P, counts, keys)
    got = guess_motion_window(P, counts, key, 20, impl="xla")
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-7)


def test_window_guesser_pair_draws_match(rng):
    """The refactor keeps the exact per-frame pair draws."""
    key = jax.random.PRNGKey(3)
    counts = jnp.asarray([5, 9, 40], jnp.int32)
    keys = jax.random.split(key, 3)
    r0_ref, r1_ref = jax.vmap(
        lambda k, c: sample_pairs(k, 20, c))(keys, counts)
    r0, r1 = jax.vmap(lambda k, c: sample_pairs(k, 20, c))(keys, counts)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r0_ref))
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r1_ref))


@pytest.mark.parametrize("F,I,N", [(60, 20, 130), (8, 200, 130),
                                   (8, 200, 256)])
def test_kernel_real_widths(rng, F, I, N):
    """PreSync (I=20: one hypothesis block, 12 lanes masked) and Sync
    (I=200: seven blocks, the last partial) widths; N=130 is masked up
    to a 256-wide feature block. Tolerance: the Markov bracket's mean
    is a sum of up to N f32 terms taken in another order, at most
    (N-1) * 2^-24 relative (1.5e-5 at N=256); every bisection decision
    is bf16-grid exact on both paths."""
    _, nP, v, counts = _problem(rng, F=F, N=N, I=I)
    a = np.asarray(score_quartile_triton(nP, v, counts, interpret=True))
    b = np.asarray(score_quartile_xla(nP, v, counts))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=0)


def test_kernel_empty_and_single_feature_rows(rng):
    """counts 0 and 1: an empty row scores exactly 0 on both paths; a
    one-feature row's bracket starts at [0, x] with no mean to reorder,
    so it agrees to the last ulp of the residual itself."""
    _, nP, v, counts = _problem(rng, F=6, N=130, I=20)
    counts = counts.at[0].set(0).at[1].set(1)
    a = np.asarray(score_quartile_triton(nP, v, counts, interpret=True))
    b = np.asarray(score_quartile_xla(nP, v, counts))
    assert np.all(a[0] == 0.0) and np.all(b[0] == 0.0)
    np.testing.assert_allclose(a[1], b[1], rtol=3e-7, atol=0)
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=0)


def test_score_impl_follows_backend(rng, monkeypatch):
    """The kernel is the GPU backend's choice; every other backend
    takes the XLA bisection. An unknown name is an error."""
    from rssync_tpu.ops import pallas_score as PSC

    assert PSC.score_impl() == "xla"  # the suite runs on the CPU
    _, nP, v, counts = _problem(rng)
    np.testing.assert_array_equal(
        np.asarray(score_quartile(nP, v, counts)),
        np.asarray(score_quartile_xla(nP, v, counts)),
    )
    monkeypatch.setattr(PSC.jax, "default_backend", lambda: "gpu")
    assert PSC.score_impl() == "triton"
    with pytest.raises(ValueError, match="unknown scoring impl"):
        score_quartile(nP, v, counts, impl="cuda")


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
                      np.float64)


@pytest.mark.parametrize("F,I,N", [(9, 20, 33), (5, 200, 130)])
def test_xla_scoring_matches_numpy_oracle(rng, F, I, N):
    """The bisection brackets the (k+1)-th smallest bf16-rounded
    squared residual, k = max(count, 1) // 4 (the reference's n/4
    quartile): bf16(hi) is at or above it, and hi minus the final
    bracket width (Markov bracket / 2^BISECT_ROUNDS) is at or below
    it, up to one bf16 rounding step."""
    from rssync_tpu.ops.pallas_score import BISECT_ROUNDS, MARKOV_C

    _, nP, v, counts = _problem(rng, F=F, N=N, I=I)
    out = np.asarray(score_quartile_xla(nP, v, counts), np.float64)
    nP_np = np.asarray(nP)
    v_np = np.asarray(v)
    for f in range(F):
        c = int(counts[f])
        res = (v_np[0, f][:, None] * nP_np[0, f][None, :c]
               + v_np[1, f][:, None] * nP_np[1, f][None, :c]
               + v_np[2, f][:, None] * nP_np[2, f][None, :c])
        res2 = (res * res).astype(np.float64)
        q = np.sort(_bf16(res2), axis=-1)[:, max(c, 1) // 4]
        hi0 = np.minimum(res2.max(-1), MARKOV_C * res2.mean(-1))
        width = hi0 * (1 + 1e-5) / 2.0 ** BISECT_ROUNDS
        assert np.all(_bf16(out[f]) >= q)
        assert np.all((out[f] - width) * (1 - 2.0 ** -8) <= q)
