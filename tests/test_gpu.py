"""Checks that need the card, and the CPU-side checks of chip_smoke.py.

The `gpu`-marked tests compile the kernels on a real GPU (the rest of
the suite pins the CPU backend and runs Pallas in interpreter mode).
They skip unless the session's backend is a GPU:

    RSSYNC_GPU_TESTS=1 python -m pytest tests -m gpu

RSSYNC_GPU_TESTS=1 stops conftest from pinning the CPU backend; `-m gpu`
deselects the CPU suite, whose sharding tests need 8 virtual devices.
chip_smoke.py runs the same checks (phase b).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from rssync_tpu.testing import gpu_parity as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (RSSYNC_GPU_TESTS=1 on a card)")


@pytest.mark.gpu
def test_compiled_score_kernel_parity(gpu):
    for name, (share, worst) in G.check_score_quartile().items():
        assert np.isfinite(worst)
        assert share <= G.SCORE_CHANGED_MAX, f"{name}: {share} changed"


@pytest.mark.gpu
def test_compiled_lk_strip_vs_legacy(gpu):
    err = G.check_lk_strip_vs_legacy()
    assert err <= G.LK_TOL_PX, f"strip vs legacy {err} px"


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    """No card (or a CPU-only JAX): non-zero exit, no result line."""
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """chip_smoke.py alone in a directory, without the package: it
    fails and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
