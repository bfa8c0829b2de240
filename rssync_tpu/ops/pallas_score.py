"""RANSAC hypothesis scoring: the quartile bracket of squared residuals
per hypothesis, by value bisection.

Two implementations of one contract, chosen by `score_impl()`:

* `score_quartile_xla` — plain JAX. Each of the BISECT_ROUNDS rounds
  re-reads the bf16 squared-residual volume (rows x hypotheses x
  features), so on the GPU every round is its own pass over device
  memory.
* `score_quartile_triton` — one Pallas kernel through Triton. A
  program owns one row (one frame of one batch problem) and a block of
  HYP_BLOCK hypotheses: it loads the row's three residual components
  (features masked up to the next power of two) and its hypothesis
  block once, forms the squared residuals in registers, and runs the
  Markov bracket and every bisection round without touching device
  memory again.

Numerics are shared deliberately: the compare buffer is quantized to
the bf16 grid (the kernel compares bf16-rounded values in f32, which is
the same predicate bit for bit), BISECT_ROUNDS rounds on the
Markov-bounded bracket, and `hi` is returned as the quantile bracket.
The two paths may differ in the accumulation order of the bracket's
mean (a few-ulp wobble of the returned endpoint) and in how the
compiler contracts the 3-term residual into FMAs, which can round a
residual on the other side of a bf16 boundary and flip one decision of
a near-tied hypothesis: a few results in 10^5 on the H100 (see
testing/gpu_parity.py::check_score_quartile).

Scoring replaces the reference's per-hypothesis sort + n/4 selection
(ref: src/core/core_private.cpp:34-59).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: bisection rounds. The initial upper bracket is min(max, MARKOV_C *
#: mean): by Markov's inequality strictly more than half the valid
#: values lie at or below 2*mean, so it always brackets the 25th
#: percentile; the extra 1.56% margin absorbs bf16 round-up of compared
#: elements. Residual distributions here are heavy-tailed (log1p
#: losses), so 2*mean sits far below max and 12 rounds on the Markov
#: bracket resolve the quantile finer than 14 rounds on [0, max] (10
#: rounds flipped a near-tie in test_presync_ransac_winner_is_defensible).
BISECT_ROUNDS = 12

#: Markov upper-bracket multiplier (2 + bf16 rounding margin)
MARKOV_C = 2.03125

#: hypotheses per kernel program (a power of two, as Triton requires)
#: and warps per program: the fastest of the block/warp pairs tried at
#: the PreSync and Sync widths on the H100 (PERF.md)
HYP_BLOCK = 16
NUM_WARPS = 1


def score_impl() -> str:
    """The scoring implementation for the default backend: the Triton
    kernel on the GPU, the plain XLA bisection everywhere else."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _score_kernel(nP_ref, v_ref, cnt_ref, out_ref, *, n_frames, n_feat,
                  n_hyp, feat_block, hyp_block):
    """One (row, hypothesis block) program. nP_ref (B, 3, F, N), v_ref
    (B, 3, F, I), cnt_ref (B, F), out_ref (B, F, I): whole arrays, the
    program indexes its own row."""
    r = pl.program_id(0)
    j = pl.program_id(1)
    b = r // n_frames
    f = r % n_frames

    iota_n = jnp.arange(feat_block, dtype=jnp.int32)
    in_n = iota_n < n_feat
    hyp = j * hyp_block + jnp.arange(hyp_block, dtype=jnp.int32)
    in_h = hyp < n_hyp

    def row(c):
        return plgpu.load(nP_ref.at[b, c, f, pl.ds(0, feat_block)],
                          mask=in_n, other=0.0)

    def hyps(c):
        return plgpu.load(v_ref.at[b, c, f, pl.ds(j * hyp_block, hyp_block)],
                          mask=in_h, other=0.0)

    res = (
        hyps(0)[:, None] * row(0)[None, :]
        + hyps(1)[:, None] * row(1)[None, :]
        + hyps(2)[:, None] * row(2)[None, :]
    )  # (hyp_block, feat_block)
    res2 = res * res

    cnt = cnt_ref[b, f]
    valid = (iota_n < cnt)[None, :]
    k1 = (jnp.maximum(cnt, 1) // 4 + 1).astype(jnp.float32)

    # bf16-grid compare in f32: bf16 -> f32 is exact, so the predicate
    # equals the XLA path's bf16 compare bit for bit
    res2m = jnp.where(valid, res2, jnp.inf).astype(
        jnp.bfloat16).astype(jnp.float32)
    masked = jnp.where(valid, res2, 0.0)
    mu = jnp.sum(masked, axis=-1) / jnp.maximum(cnt, 1).astype(jnp.float32)
    hi = jnp.minimum(jnp.max(masked, axis=-1), MARKOV_C * mu)
    lo = jnp.zeros_like(hi)

    def bisect(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        midq = mid.astype(jnp.bfloat16).astype(jnp.float32)
        c = jnp.sum((res2m <= midq[:, None]).astype(jnp.float32), axis=-1)
        ge = c >= k1
        return jnp.where(ge, lo, mid), jnp.where(ge, mid, hi)

    _, hi = jax.lax.fori_loop(0, BISECT_ROUNDS, bisect, (lo, hi))
    plgpu.store(out_ref.at[b, f, pl.ds(j * hyp_block, hyp_block)], hi,
                mask=in_h)


@partial(jax.jit, static_argnames=("interpret", "hyp_block"))
def score_quartile_triton(
    nP: jnp.ndarray, v: jnp.ndarray, counts: jnp.ndarray,
    interpret: bool = False, hyp_block: int = HYP_BLOCK,
) -> jnp.ndarray:
    """Quartile bracket of squared residuals per hypothesis.

    nP: ([B,] 3, F, N) row-normalized residual rows; v: ([B,] 3, F, I)
    unit hypothesis directions; counts: ([B,] F) int32 valid features.
    Returns ([B,] F, I) f32. One kernel launch over B*F rows x
    ceil(I / hyp_block) hypothesis blocks; no transposes or pads."""
    batched = nP.ndim == 4
    if not batched:
        nP, v, counts = nP[None], v[None], counts[None]
    B, _, F, N = nP.shape
    n_hyp = v.shape[-1]
    hb = min(hyp_block, _next_pow2(n_hyp))
    kernel = partial(
        _score_kernel, n_frames=F, n_feat=N, n_hyp=n_hyp,
        feat_block=_next_pow2(N), hyp_block=hb,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, F, n_hyp), jnp.float32),
        grid=(B * F, pl.cdiv(n_hyp, hb)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="score_quartile",
    )(nP, v, counts.astype(jnp.int32))
    return out if batched else out[0]


def score_quartile_xla(
    nP: jnp.ndarray, v: jnp.ndarray, counts: jnp.ndarray
) -> jnp.ndarray:
    """Plain-JAX scoring of one problem: nP (3, F, N), v (3, F, I),
    counts (F,) -> (F, I). Residuals use an explicit f32 FMA chain
    (the same form as the kernel) rather than an einsum, whose default
    precision may contract in reduced precision on an accelerator."""
    N = nP.shape[-1]

    def one_frame(nP_f, v_f, count):
        res = (
            v_f[0][:, None] * nP_f[0][None, :]
            + v_f[1][:, None] * nP_f[1][None, :]
            + v_f[2][:, None] * nP_f[2][None, :]
        )  # (I, N)
        res2 = res * res
        valid = (jnp.arange(N) < count)[None, :]
        k = jnp.maximum(count, 1) // 4
        res2m = jnp.where(valid, res2, jnp.inf).astype(jnp.bfloat16)
        lo = jnp.zeros((res2.shape[0],), res2.dtype)
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
        return hi

    return jax.vmap(one_frame, in_axes=(1, 1, 0))(nP, v, counts)


def score_quartile(
    nP: jnp.ndarray, v: jnp.ndarray, counts: jnp.ndarray,
    impl: str | None = None,
) -> jnp.ndarray:
    """Dispatch on `impl` ("triton" | "xla"; None = score_impl()).
    Shapes as score_quartile_triton, with or without the batch axis."""
    impl = impl or score_impl()
    if impl == "triton":
        return score_quartile_triton(nP, v, counts)
    if impl != "xla":
        raise ValueError(f"unknown scoring impl {impl!r}")
    if nP.ndim == 4:
        return jax.vmap(score_quartile_xla)(nP, v, counts)
    return score_quartile_xla(nP, v, counts)
