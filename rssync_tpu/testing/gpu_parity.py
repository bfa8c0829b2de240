"""Compiled-kernel parity checks for the GPU.

The CPU suite runs the Pallas scoring kernel in interpreter mode only;
the Triton compiler has its own constraints (power-of-two blocks,
register and shared-memory limits) that the interpreter never sees.
These checks compile every kernel on the card at the widths the
pipeline uses and compare it with its plain reference:

1. `score_quartile_triton` vs `score_quartile_xla` at the PreSync
   shape (F=60, I=20, N=130), the Sync shapes (I=200, N=130 and
   N=256), vmapped over windows as Sync calls it, and a batch of
   DELAY_CHUNK x 30 problems as one PreSync chunk calls it. The check
   is the share of results that differ by more than a relative 2e-5.
   Both paths compare on the bf16 grid, but the compilers contract the
   3-term residual into FMAs differently and sum the Markov bracket's
   mean in another order, so a residual within one f32 ulp of a bf16
   rounding boundary can round the other way and flip one bisection
   decision of a near-tied hypothesis: a few results in 10^5 move by
   up to a bisection step (measured on the H100). Anything beyond
   1e-4 of the results is a real divergence.
2. One LK tracker run at 2704x2028: strip-fetch path vs the legacy
   per-row-clamped gather path on the same frames, within 2e-3 px
   (same math, different fetch), including points whose windows
   overhang the frame top.

`chip_smoke.py` runs them (phase b); `tests/test_gpu.py` wraps them as
`-m gpu` tests. `interpret=True` runs the same checks on the CPU at a
small size, as a rehearsal.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

#: relative difference beyond which a scoring result counts as changed
#: ((N-1) * 2^-24 is 1.5e-5 at N=256), and the share of changed results
#: the kernel may show against the XLA bisection (module docstring)
SCORE_RTOL = 2e-5
SCORE_CHANGED_MAX = 1e-4
#: tracker strip path vs legacy path, in pixels
LK_TOL_PX = 2e-3


def _scoring_problem(rng, lead: tuple, F: int, I: int, N: int):
    nP = rng.normal(size=(*lead, 3, F, N)).astype(np.float32)
    v = rng.normal(size=(*lead, 3, F, I))
    v /= np.linalg.norm(v, axis=-3, keepdims=True)
    counts = rng.integers(N // 2, N + 1, size=(*lead, F))
    return (jnp.asarray(nP), jnp.asarray(v, jnp.float32),
            jnp.asarray(counts, jnp.int32))


def _changed_share(a, b) -> tuple[float, float]:
    """(share of entries differing by > SCORE_RTOL relative, max
    relative difference)."""
    a = np.asarray(a)
    b = np.asarray(b)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
    rel = np.abs(a - b) / scale
    return float((rel > SCORE_RTOL).mean()), float(rel.max())


def score_cases(small: bool = False) -> dict:
    """name -> (mode, B, F, I, N) of each scoring check. mode "one" is
    a single (3, F, N) problem, "vmap" maps B windows through vmap (as
    Sync does), "batch" passes B problems to one batched call (as a
    PreSync chunk does)."""
    from rssync_tpu.core.presync import DELAY_CHUNK

    if small:
        return {
            "presync F=6 I=20 N=130": ("one", 1, 6, 20, 130),
            "sync I=200 N=130 vmap W=2": ("vmap", 2, 4, 200, 130),
            "presync chunk B=3": ("batch", 3, 4, 20, 33),
        }
    return {
        "presync F=60 I=20 N=130": ("one", 1, 60, 20, 130),
        "sync F=60 I=200 N=130": ("one", 1, 60, 200, 130),
        "sync F=60 I=200 N=256": ("one", 1, 60, 200, 256),
        "sync vmap W=30 F=60 I=200 N=130": ("vmap", 30, 60, 200, 130),
        f"presync chunk B={DELAY_CHUNK * 30} F=60 I=20 N=130": (
            "batch", DELAY_CHUNK * 30, 60, 20, 130),
    }


def check_score_quartile(interpret: bool = False) -> dict:
    """(changed share, max relative |triton - xla|) per scoring case."""
    from rssync_tpu.ops.pallas_score import (
        score_quartile_triton,
        score_quartile_xla,
    )

    rng = np.random.default_rng(7)
    out = {}
    for name, (mode, B, F, I, N) in score_cases(interpret).items():
        lead = () if mode == "one" else (B,)
        nP, v, counts = _scoring_problem(rng, lead, F, I, N)
        kern = partial(score_quartile_triton, interpret=interpret)
        ref = score_quartile_xla if mode == "one" else jax.vmap(
            score_quartile_xla)
        if mode == "vmap":
            kern = jax.vmap(kern)
        out[name] = _changed_share(kern(nP, v, counts), ref(nP, v, counts))
    return out


def check_lk_strip_vs_legacy(height: int = 2028, width: int = 2704) -> float:
    """Max |strip-path track - legacy-path track| in px on random u8
    frames of the given size (expected < LK_TOL_PX)."""
    from rssync_tpu.frontend import tracking as T

    rng = np.random.default_rng(9)
    frames = jnp.asarray(rng.integers(0, 255, (3, height, width)),
                         jnp.uint8)
    # interior points across the frame, and three whose windows
    # overhang the top edge
    fx = np.asarray([0.16, 0.52, 0.78, 0.31])
    fy = np.asarray([0.25, 0.5, 0.75, 0.81])
    pts = np.concatenate([
        np.stack([fx * width, fy * height], axis=-1).round(),
        [[64.0, 2.0], [round(width * 0.47), 5.0], [256.0, 0.0]],
    ])
    base = np.asarray(T.lk_track_video(frames, pts))
    orig = T._strip_path_ok
    try:
        T._strip_path_ok = lambda img: False
        T._lk_track_video_jit.clear_cache()
        legacy = np.asarray(T.lk_track_video(frames, pts))
    finally:
        T._strip_path_ok = orig
        T._lk_track_video_jit.clear_cache()
    return float(np.abs(base - legacy).max())


def run_parity(interpret: bool = False) -> dict:
    """All checks: {name: {"err", "tol", "ok"}}; for the scoring cases
    "err" is the changed share (its max relative difference is
    printed beside it in the name)."""
    res = {}
    for name, (share, worst) in check_score_quartile(interpret).items():
        res[f"score_quartile {name}: changed share (max rel diff "
            f"{worst:.3g})"] = (share, SCORE_CHANGED_MAX)
    hw = (160, 384) if interpret else (2028, 2704)
    res[f"lk strip vs legacy {hw[1]}x{hw[0]}: max |diff| px"] = (
        check_lk_strip_vs_legacy(*hw), LK_TOL_PX)
    return {
        name: {"err": err, "tol": tol,
               "ok": bool(np.isfinite(err) and err <= tol)}
        for name, (err, tol) in res.items()
    }
