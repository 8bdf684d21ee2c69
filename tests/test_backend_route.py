"""The backend choice (ops/pallas.kernel_route), the compile-cache setup
(visualslam.configure_compile_cache) and chip_smoke.py's refusal to run
without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

import visualslam
from visualslam.ops.pallas import kernel_route

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,impl,want", [
    ("gpu", "auto", "compiled"),
    ("gpu", "pallas", "compiled"),
    ("gpu", "xla", None),
    ("cpu", "auto", None),
    ("cpu", "pallas", "interpret"),
    ("cpu", "xla", None),
    ("rocm", "auto", None),
])
def test_kernel_route(monkeypatch, backend, impl, want):
    """The interpreter runs only where it was asked for, on the CPU; a GPU
    always gets the compiled kernel unless XLA is asked for."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert kernel_route(impl) == want


@pytest.mark.parametrize("backend,impl", [("rocm", "pallas"),
                                          ("cpu", "fused")])
def test_kernel_route_rejects(monkeypatch, backend, impl):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(ValueError):
        kernel_route(impl)


def test_compile_cache_env_var_wins(monkeypatch):
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    got = visualslam.configure_compile_cache(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}, platforms="cuda")
    assert got == "/somewhere/cache"
    # JAX reads the variable itself; only the threshold is set here
    assert "jax_compilation_cache_dir" not in updates
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 2.0


def test_compile_cache_default_is_in_checkout(monkeypatch):
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    got = visualslam.configure_compile_cache({}, platforms="cuda,cpu")
    assert got == os.path.join(REPO, ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == got
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 2.0


def test_compile_cache_none_on_cpu(monkeypatch):
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    assert visualslam.configure_compile_cache({}, platforms="cpu") is None
    assert updates == {}


def test_chip_smoke_fails_without_gpu():
    """No accelerator: a non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr + r.stdout
