"""Structured per-stage timing/observability.

The reference's observability is bare stderr progress lines (SURVEY
§5.1: per-frame tracking core_testcode.cpp:117, per-iteration Sync
trace core_private.cpp:330). The rebuild keeps those prints (behind
`progress=`) and adds what the reference lacks: a structured timing
registry per pipeline stage, queryable programmatically and printable
as a report, plus an optional JAX profiler trace hook.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


@dataclass
class Timings:
    """Collects wall-clock per named stage; nestable."""

    stages: dict = field(default_factory=lambda: defaultdict(StageStats))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name].add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["stage                         calls    total      mean"]
        for name, s in sorted(
            self.stages.items(), key=lambda kv: -kv[1].total_s
        ):
            mean = s.total_s / max(s.calls, 1)
            lines.append(
                f"{name:<28} {s.calls:>6} {s.total_s:>8.3f}s {mean:>8.4f}s"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            k: {"calls": v.calls, "total_s": v.total_s}
            for k, v in self.stages.items()
        }


@contextlib.contextmanager
def jax_profiler_trace(log_dir: str | None):
    """Optional XLA profiler capture around a region (view with
    tensorboard-plugin-profile). No-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


#: default persistent compile cache: a fixed directory inside the
#: checkout (listed in .gitignore), so that the cache key's path never
#: moves between runs
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """Where the persistent compile cache lives: JAX_COMPILATION_CACHE_DIR
    when it is set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache at compile_cache_dir()
    and return that directory. The engine's batched PreSync/Sync
    programs and the tracker are large compiles; with the cache they
    compile once per checkout, not once per process.

    Called by the CLI entry, bench.py and chip_smoke.py; library users
    opt in themselves. An explicitly configured cache directory is
    never overridden."""
    import jax

    if jax.config.jax_compilation_cache_dir:
        return jax.config.jax_compilation_cache_dir
    cache_dir = compile_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
