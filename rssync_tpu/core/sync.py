"""Sync: fine alternating optimization of per-frame translation
directions and the gyro delay.

JAX rebuild of `SyncProblemPrivate::Sync`
(ref: src/core/core_private.cpp:211-334) and its helpers
(`FrameState::Loss/GuessMotion/GuessK`, :92-133; `Backtrack`,
src/core_support/backtrack.cpp:3-13). Structure:

  init:   motion_vec per frame from 200-hypothesis RANSAC, var_k from
          GuessK — both at the initial delay (ref :218-223).
  loop (<= 400 outer iterations, ref :309):
    1. per-frame refinement of the 3-vector translation direction at
       the current delay (ref :262-296, ensmallen L_BFGS with
       MaxIterations=200, MinGradientNorm=1e-4). Default here: a few
       *IRLS* rounds — the robust loss is scale-invariant in M, so its
       stationary points on the unit sphere are exactly the
       fixed points of "smallest eigenvector of A = sum_n w_n P_n
       P_n^T with w_n = 1/(1+r_n^2)", solved batched over frames by
       adjugate inverse iteration on the 3x3 systems (documented
       deviation: same fixed points, branch-free, ~50x fewer
       sequential device steps than the reference's L-BFGS). The
       faithful batched L-BFGS survives as motion_opt="lbfgs".
    2. one Nesterov-momentum (beta=0.3) Armijo-backtracked gradient
       step on the delay (hypers 2e-4, 0.1, 1e-3, 10; ref :225-226,
       :298-305). All 10 trial step sizes are known in advance
       (t0 * decay^k), so the line search evaluates every trial in ONE
       batched call and selects the first Armijo-satisfying one —
       bit-identical selection to the reference's sequential decay
       loop. The uninitialized `delay_v` of the reference (:261, UB)
       is initialized to 0 per SURVEY §2.1.
    3. stop after 6 consecutive steps < 1e-4 or when the delay leaves
       search_center +- search_radius (ref :316-328).

The delay gradient is analytic (`jax.grad` through the spline) instead
of the reference's central difference with step 1e-6 (:96-97) — the
numeric-diff convention cannot survive f32, and parity is defined on
the final offset (SURVEY §7 hard-parts). Everything is one jitted
program per window shape; windows batch via vmap (see parallel/).

Observability: SyncResult carries per-outer-iteration (delay, step)
trace buffers — the batched-mode equivalent of the reference's
per-iteration stderr line (ref :330).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rssync_tpu.core.problem import SplineTable, TrackWindow, compute_problem
from rssync_tpu.core.ransac import guess_motion_window
from rssync_tpu.ops.robust import clamp_k, safe_norm

# --- reference hyperparameters ---------------------------------------------
SYNC_RANSAC_ITERS = 200        # GuessMotion hypotheses (ref :127)
LBFGS_MAX_ITERS = 200          # ens::L_BFGS MaxIterations (ref :265)
LBFGS_MIN_GRAD = 1e-4          # ens::L_BFGS MinGradientNorm (ref :266)
LBFGS_MEM = 5
BT_SUFFICIENT_DECREASE = 2e-4  # Backtrack hypers (ref :226)
BT_DECAY = 0.1
BT_INITIAL_STEP = 1e-3
BT_MAX_ITERS = 10
DELAY_MOMENTUM = 0.3           # delay_b (ref :260)
OUTER_MAX_ITERS = 400          # ref :309
CONVERGE_STEP = 1e-4           # ref :316
CONVERGE_COUNT = 5             # ref :321 (`> 5` -> 6 consecutive)

#: IRLS motion rounds per outer iteration (deviation from the
#: reference's run-to-convergence L-BFGS; the outer loop re-enters
#: with a warm M, so a few rounds per iteration track the same fixed
#: point — validated by the end-to-end accuracy tests)
MOTION_IRLS_ITERS = 3
#: inverse-iteration rounds per IRLS weight update
IRLS_INVIT_ROUNDS = 2


def frame_loss(P_f: jnp.ndarray, M_f: jnp.ndarray, var_k_f) -> jnp.ndarray:
    """Full robust loss of one frame:
    sum log1p((P M)^2 * k^2 / |M|^2) (ref :99-110 / :117-123).
    P_f is SoA (3, N); padded columns are zero and contribute
    log1p(0) = 0."""
    PM = jnp.einsum("cn,c->n", P_f, M_f, precision="highest")
    # floor keeps ||M||^4 representable in f32 inside the gradient;
    # M is ~unit in normal operation so the floor is never active then
    M2 = jnp.maximum(jnp.sum(M_f * M_f), 1e-12)
    return jnp.sum(jnp.log1p(PM * PM * (var_k_f * var_k_f) / M2))


def window_loss(
    table: SplineTable, win: TrackWindow, delay, M: jnp.ndarray,
    var_k: jnp.ndarray, bands=None,
) -> jnp.ndarray:
    """Sum of frame losses over the window at one delay (the parallel
    reduction of ref :242-254). Computed whole-window in SoA (no
    per-frame vmap needed)."""
    P = compute_problem(table, win, delay, bands)  # (3, F, N)
    PM = jnp.einsum("cfn,fc->fn", P, M, precision="highest")
    M2 = jnp.maximum(jnp.sum(M * M, axis=-1), 1e-12)  # (F,)
    losses = jnp.sum(
        jnp.log1p(PM * PM * ((var_k * var_k) / M2)[:, None]), axis=-1
    )
    return jnp.sum(losses * win.frame_mask)


# --- batched L-BFGS over frames --------------------------------------------


class _LBFGSState(NamedTuple):
    x: jnp.ndarray        # (B, 3)
    f: jnp.ndarray        # (B,)
    g: jnp.ndarray        # (B, 3)
    S: jnp.ndarray        # (B, mem, 3) newest first
    Y: jnp.ndarray        # (B, mem, 3)
    rho: jnp.ndarray      # (B, mem)
    hist: jnp.ndarray     # (B,) int32 valid history length
    done: jnp.ndarray     # (B,) bool


def _two_loop_direction(st: _LBFGSState) -> jnp.ndarray:
    """Classic L-BFGS two-loop recursion, batched. Falls back to
    steepest descent when no history."""
    mem = st.S.shape[1]
    valid = (jnp.arange(mem)[None, :] < st.hist[:, None]).astype(st.x.dtype)

    q = st.g
    alphas = []
    for i in range(mem):  # newest -> oldest
        a = st.rho[:, i] * jnp.sum(st.S[:, i] * q, axis=-1) * valid[:, i]
        q = q - a[:, None] * st.Y[:, i]
        alphas.append(a)

    y0y0 = jnp.sum(st.Y[:, 0] * st.Y[:, 0], axis=-1)
    s0y0 = jnp.sum(st.S[:, 0] * st.Y[:, 0], axis=-1)
    gamma = jnp.where(st.hist > 0, s0y0 / jnp.maximum(y0y0, 1e-30), 1.0)
    r = gamma[:, None] * q

    for i in range(mem - 1, -1, -1):  # oldest -> newest
        b = st.rho[:, i] * jnp.sum(st.Y[:, i] * r, axis=-1) * valid[:, i]
        r = r + ((alphas[i] - b) * valid[:, i])[:, None] * st.S[:, i]
    return -r


def batched_lbfgs(
    value_and_grad_fn,
    x0: jnp.ndarray,
    max_iters: int = LBFGS_MAX_ITERS,
    min_grad_norm: float = LBFGS_MIN_GRAD,
    mem: int = LBFGS_MEM,
    ls_trials: int = 50,
    armijo_c1: float = 1e-4,
    wolfe_c2: float = 0.9,
) -> jnp.ndarray:
    """Minimize B independent small problems simultaneously.

    value_and_grad_fn: (B, d) -> ((B,), (B, d)); must be safe on frozen
    (converged / masked) lanes. Mirrors the role of the reference's
    per-frame ensmallen L-BFGS (ref :262-296), batched: every frame of
    every window steps in lockstep, converged lanes freeze. The line
    search follows ensmallen's strong-Wolfe policy (c1 1e-4, c2 0.9,
    step width x2.1 while curvature is too negative, x0.5 on Armijo or
    strong-curvature failure, <= 50 trials — matching
    golden/shim/ensmallen_bits/lbfgs/lbfgs.hpp so golden Sync iterate
    trajectories are comparable).
    """
    B, d = x0.shape
    f0, g0 = value_and_grad_fn(x0)
    st = _LBFGSState(
        x=x0,
        f=f0,
        g=g0,
        S=jnp.zeros((B, mem, d), x0.dtype),
        Y=jnp.zeros((B, mem, d), x0.dtype),
        rho=jnp.zeros((B, mem), x0.dtype),
        hist=jnp.zeros((B,), jnp.int32),
        done=jnp.linalg.norm(g0, axis=-1) < min_grad_norm,
    )

    def body(st: _LBFGSState) -> _LBFGSState:
        d_dir = _two_loop_direction(st)
        gd = jnp.sum(st.g * d_dir, axis=-1)
        # non-descent direction -> steepest descent restart
        bad = gd >= 0.0
        d_dir = jnp.where(bad[:, None], -st.g, d_dir)
        gd = jnp.where(bad, -jnp.sum(st.g * st.g, axis=-1), gd)

        # strong-Wolfe search from t = 1 (ensmallen policy), early
        # exit once every live lane has accepted (typically the very
        # first trial)
        def ls_cond(carry):
            i, t, accepted, t_acc = carry
            return (i < ls_trials) & ~jnp.all(accepted)

        def ls_body(carry):
            i, t, accepted, t_acc = carry
            f_try, g_try = value_and_grad_fn(st.x + t[:, None] * d_dir)
            armijo_fail = f_try > st.f + armijo_c1 * t * gd
            gd_new = jnp.sum(g_try * d_dir, axis=-1)
            too_negative = gd_new < wolfe_c2 * gd          # -> widen x2.1
            overshoot = gd_new > -wolfe_c2 * gd            # -> shrink x0.5
            ok = ~armijo_fail & ~too_negative & ~overshoot & ~accepted
            t_acc = jnp.where(ok, t, t_acc)
            width = jnp.where(armijo_fail | overshoot, 0.5, 2.1)
            t_new = jnp.where(accepted | ok, t, t * width)
            # a lane whose step leaves [1e-20, 1e20] has failed: freeze
            # it with t_acc = 0 (outer loop then marks it done)
            out = (t_new < 1e-20) | (t_new > 1e20)
            accepted = accepted | ok | out
            return i + 1, t_new, accepted, t_acc

        t0 = jnp.ones((B,), x0.dtype)
        _, _, accepted, t_acc = jax.lax.while_loop(
            ls_cond, ls_body,
            (jnp.asarray(0, jnp.int32), t0, st.done, jnp.zeros(B, x0.dtype)),
        )
        step_t = jnp.where(accepted & ~st.done, t_acc, 0.0)

        x_new = st.x + step_t[:, None] * d_dir
        f_new, g_new = value_and_grad_fn(x_new)
        s = x_new - st.x
        y = g_new - st.g
        sy = jnp.sum(s * y, axis=-1)
        store = (sy > 1e-10) & ~st.done

        S = jnp.where(
            store[:, None, None], jnp.roll(st.S, 1, axis=1).at[:, 0].set(s), st.S
        )
        Y = jnp.where(
            store[:, None, None], jnp.roll(st.Y, 1, axis=1).at[:, 0].set(y), st.Y
        )
        rho = jnp.where(
            store[:, None],
            jnp.roll(st.rho, 1, axis=1).at[:, 0].set(1.0 / jnp.maximum(sy, 1e-30)),
            st.rho,
        )
        hist = jnp.where(store, jnp.minimum(st.hist + 1, mem), st.hist)

        frozen = st.done
        x_out = jnp.where(frozen[:, None], st.x, x_new)
        f_out = jnp.where(frozen, st.f, f_new)
        g_out = jnp.where(frozen[:, None], st.g, g_new)
        done = frozen | (jnp.linalg.norm(g_out, axis=-1) < min_grad_norm) | (
            step_t == 0.0
        )
        return _LBFGSState(x_out, f_out, g_out, S, Y, rho, hist, done)

    # while-loop with early exit: the reference's per-frame L-BFGS stops
    # at MinGradientNorm; running a fixed 200 iterations would waste
    # ~10x wall-clock on the device (typical convergence ~15 iters).
    def cond(carry):
        i, st = carry
        return (i < max_iters) & ~jnp.all(st.done)

    def wrapped(carry):
        i, st = carry
        return i + 1, body(st)

    _, st = jax.lax.while_loop(cond, wrapped, (jnp.asarray(0, jnp.int32), st))
    return st.x


# --- batched IRLS motion refinement ----------------------------------------


def _adjugate_apply_sym3(abcdef, v: jnp.ndarray) -> jnp.ndarray:
    """adj(A) @ v for batched symmetric 3x3 A given as its 6 unique
    entries (a, b, c, d, e, f) of shape (...,) — one inverse-iteration
    step up to scale (det division folds into the subsequent
    normalize). Scalar-component form: a (F, 3, 3) tensor puts two
    size-3 axes minor, and every entry read becomes a strided slice."""
    a, b, c, d, e, f = abcdef
    m00 = d * f - e * e
    m01 = c * e - b * f
    m02 = b * e - c * d
    m11 = a * f - c * c
    m12 = b * c - a * e
    m22 = a * d - b * b
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            m00 * x + m01 * y + m02 * z,
            m01 * x + m11 * y + m12 * z,
            m02 * x + m12 * y + m22 * z,
        ],
        axis=-1,
    )


def motion_irls(
    P: jnp.ndarray, M: jnp.ndarray, var_k: jnp.ndarray,
    iters: int = MOTION_IRLS_ITERS,
) -> jnp.ndarray:
    """Refine all frames' translation directions at once by IRLS.

    The per-frame robust loss sum_n log1p((P_n.M)^2 k^2 / |M|^2)
    (ref :99-110) is scale-invariant in M; on the unit sphere its
    stationary points satisfy A(M) M = lambda_min M with
    A = sum_n w_n P_n P_n^T, w_n = 1/(1 + r_n^2) — so the minimizer is
    a fixed point of "reweight, then take the smallest eigenvector".
    Each eigenvector solve is adjugate inverse iteration on a (shifted)
    3x3 — branch-free, batched over frames, no line search. Replaces
    the role of the reference's per-frame ensmellen L-BFGS
    (ref :262-296); same fixed points, different iterates (documented
    deviation, SURVEY §7 hard-parts).

    P: (3, F, N) SoA epipolar rows (padded columns zero — they get
    w = 1 but contribute 0 to A). M: (F, 3) warm start. var_k: (F,).
    Returns (F, 3) unit directions, sign-aligned with the warm start.
    """
    P0, P1, P2 = P[0], P[1], P[2]

    def body(M_cur, _):
        Mn = M_cur * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(M_cur * M_cur, axis=-1, keepdims=True), 1e-30)
        )
        u = jnp.einsum("cfn,fc->fn", P, Mn, precision="highest")
        w = 1.0 / (1.0 + u * u * (var_k * var_k)[:, None])
        # the 6 unique entries of A = sum_n w P P^T as plain (F,)
        # reductions rather than an einsum->(F,3,3) with two size-3
        # minor axes (see _adjugate_apply_sym3)
        wp0, wp1, wp2 = w * P0, w * P1, w * P2
        a = jnp.sum(wp0 * P0, axis=-1)
        b = jnp.sum(wp0 * P1, axis=-1)
        c = jnp.sum(wp0 * P2, axis=-1)
        d = jnp.sum(wp1 * P1, axis=-1)
        e = jnp.sum(wp1 * P2, axis=-1)
        f = jnp.sum(wp2 * P2, axis=-1)
        shift = 1e-6 * (a + d + f) / 3.0 + 1e-30
        B6 = (a + shift, b, c, d + shift, e, f + shift)
        v = Mn
        for _ in range(IRLS_INVIT_ROUNDS):
            v = _adjugate_apply_sym3(B6, v)
            v = v * jax.lax.rsqrt(
                jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-30)
            )
        # keep the antipodal sign stable across iterations
        flip = jnp.sum(v * Mn, axis=-1, keepdims=True) < 0.0
        return jnp.where(flip, -v, v), None

    M_out, _ = jax.lax.scan(body, M, None, length=iters)
    return M_out


# --- delay line search (Backtrack) -----------------------------------------


def _backtrack_step(f_only, x0, fval, grad):
    """One Backtrack::Step (ref: src/core_support/backtrack.cpp:3-13):
    returns -t * grad with t from Armijo backtracking.

    The reference tries t = t0 * decay^k sequentially and accepts the
    first k with sufficient decrease. Trials run in a while_loop that
    stops at the first acceptance — the common case accepts the very
    first trial, so a typical outer iteration pays 1 loss eval instead
    of BT_MAX_ITERS. Under vmap
    the loop runs until every lane has accepted, with per-lane
    first-accept masking — selection identical to the sequential
    reference. If no trial satisfies, t has decayed through all
    iterations (effectively zero step), exactly like the reference."""
    m = grad * grad
    t_fail = jnp.asarray(
        BT_INITIAL_STEP * BT_DECAY ** BT_MAX_ITERS, x0.dtype
    )

    def cond(carry):
        k, accepted, _ = carry
        return (k < BT_MAX_ITERS) & ~accepted

    def body(carry):
        k, accepted, t_acc = carry
        t = (BT_INITIAL_STEP
             * jnp.power(jnp.asarray(BT_DECAY, x0.dtype), k)).astype(x0.dtype)
        val = f_only(x0 - t * grad)
        ok = (fval - val) >= t * BT_SUFFICIENT_DECREASE * m
        take = ok & ~accepted
        return k + 1, accepted | ok, jnp.where(take, t, t_acc)

    _, _, t = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, x0.dtype), jnp.asarray(False), t_fail)
    )
    return -t * grad


# --- full Sync --------------------------------------------------------------


class SyncResult(NamedTuple):
    cost: jnp.ndarray
    delay: jnp.ndarray
    iterations: jnp.ndarray
    #: per-outer-iteration trace, length OUTER_MAX_ITERS (NaN beyond
    #: `iterations`) — the batched-mode replacement for the
    #: reference's per-iteration stderr line (ref :330)
    trace_delay: jnp.ndarray = None
    trace_step: jnp.ndarray = None


def init_motion(
    table: SplineTable, win: TrackWindow, delay, key: jax.Array,
    bands=None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """GuessMotion (200 RANSAC iters) + GuessK per frame at `delay`
    (ref :218-223, :125-133). Returns (M (F,3), var_k (F,))."""
    P = compute_problem(table, win, delay, bands)  # (3, F, N)
    M = guess_motion_window(P, win.counts, key, SYNC_RANSAC_ITERS)
    PM = jnp.einsum("cfn,fc->fn", P, M, precision="highest")
    var_k = clamp_k(1e2 / safe_norm(PM, axis=1))
    return M, var_k


@partial(jax.jit, static_argnames=("wide", "motion_opt", "delay_grad"))
def sync_window(
    table: SplineTable,
    win: TrackWindow,
    initial_delay,
    search_center,
    search_radius,
    key: jax.Array,
    wide: bool = False,
    motion_opt: str = "irls",
    delay_grad: str = "jvp",
) -> SyncResult:
    """Full Sync of one window (ref core_private.cpp:211-334).

    Returns (final simple-objective cost, final delay, outer
    iterations executed, per-iteration delay/step traces). vmap over a
    leading window axis for batched multi-syncpoint sync.

    wide=True (callers must ensure search_center +- search_radius
    stays within WIDE_SMAX knots) uses pre-extracted wide coefficient
    slabs so delay evaluations avoid per-frame band slicing.

    motion_opt: "irls" (default, see motion_irls) or "lbfgs" (the
    reference-faithful batched L-BFGS run to MinGradientNorm).

    delay_grad: "jvp" (default) computes the scalar delay gradient by
    forward-mode jax.jvp — one fused forward pass, no transposed
    spline-select chain in the loop body; "vjp" keeps
    value_and_grad. Same derivative up to float rounding.
    """
    from rssync_tpu.core.problem import make_wide_bands

    dtype = win.f0_a.dtype
    delay0 = jnp.asarray(initial_delay, dtype)
    bands = make_wide_bands(table, win, search_center) if wide else None
    M0, var_k = init_motion(table, win, delay0, key, bands)

    def delay_loss(delay, M):
        return window_loss(table, win, delay, M, var_k, bands)

    delay_vg = jax.value_and_grad(delay_loss, argnums=0)

    def motion_value_and_grad(P):
        def per_frame(p, m, k, fm):
            return frame_loss(p, m, k) * fm

        def vg(Ms):
            f, g = jax.vmap(
                jax.value_and_grad(per_frame, argnums=1),
                in_axes=(1, 0, 0, 0),
            )(P, Ms, var_k, win.frame_mask)
            return f, g

        return vg

    def refine_motion(P, M):
        if motion_opt == "irls":
            return motion_irls(P, M, var_k)
        return batched_lbfgs(motion_value_and_grad(P), M)

    def cond(state):
        i, delay, v, M, cc, done, tr_d, tr_s = state
        return (i < OUTER_MAX_ITERS) & ~done

    def body(state):
        i, delay, v, M, cc, done, tr_d, tr_s = state
        # 1. motion refinement at current delay (P hoisted)
        P = compute_problem(table, win, delay, bands)
        M = refine_motion(P, M)
        # 2. Nesterov-lookahead backtracked delay step (ref :298-305)
        x0 = delay - DELAY_MOMENTUM * v
        if delay_grad == "jvp":
            fval, grad = jax.jvp(
                lambda d: delay_loss(d, M), (x0,), (jnp.ones((), dtype),)
            )
        else:
            fval, grad = delay_vg(x0, M)
        step = _backtrack_step(lambda x: delay_loss(x, M), x0, fval, grad)
        v = DELAY_MOMENTUM * v + step
        delay = delay + v
        step_size = jnp.abs(step)
        cc = jnp.where(step_size < CONVERGE_STEP, cc + 1, 0)
        done = (cc > CONVERGE_COUNT) | (
            jnp.abs(delay - search_center) > search_radius
        )
        tr_d = tr_d.at[i].set(delay)
        tr_s = tr_s.at[i].set(step)
        return i + 1, delay, v, M, cc, done, tr_d, tr_s

    nan = jnp.full((OUTER_MAX_ITERS,), jnp.nan, dtype)
    state = (
        jnp.asarray(0, jnp.int32),
        delay0,
        jnp.zeros((), dtype),
        M0,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        nan,
        nan,
    )
    i, delay, v, M, cc, done, tr_d, tr_s = jax.lax.while_loop(
        cond, body, state
    )
    return SyncResult(
        cost=delay_loss(delay, M), delay=delay, iterations=i,
        trace_delay=tr_d, trace_step=tr_s,
    )
