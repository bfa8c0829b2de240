"""The persistent compile cache's location (utils/timing.py)."""

import os


def test_compile_cache_env_var_wins(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there and
    nowhere else: not the checkout's default directory, not HOME."""
    import subprocess
    import sys

    from rssync_tpu.utils.timing import DEFAULT_CACHE_DIR

    cache = tmp_path / "cache"
    home = tmp_path / "home"
    before = (sorted(os.listdir(DEFAULT_CACHE_DIR))
              if os.path.isdir(DEFAULT_CACHE_DIR) else None)
    code = (
        "from rssync_tpu.utils.timing import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "import jax, jax.numpy as jnp\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.ones(5)).block_until_ready()\n"
        "print(d)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache), HOME=str(home))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300, check=True,
        cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert out.stdout.strip().splitlines()[-1] == str(cache)
    assert any(cache.iterdir())
    assert not home.exists()
    after = (sorted(os.listdir(DEFAULT_CACHE_DIR))
             if os.path.isdir(DEFAULT_CACHE_DIR) else None)
    assert after == before


def test_compile_cache_default_is_fixed_inside_repo(monkeypatch):
    """Without the variable the cache lives at <repo>/.jax_cache — a
    fixed path (part of the cache key), listed in .gitignore."""
    from rssync_tpu.utils import timing

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert timing.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    assert timing.compile_cache_dir() == timing.DEFAULT_CACHE_DIR
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert timing.compile_cache_dir() == "/elsewhere"
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
