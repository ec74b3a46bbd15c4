"""Compile-cache placement (ppr_tpu.utils.cache)."""

import os
import subprocess
import sys

from ppr_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_default_is_fixed_and_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == cache.DEFAULT_DIR
    assert cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_sets_nothing_on_cpu(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_import_does_not_start_a_backend():
    """``import ppr_tpu`` (and its engines) leaves JAX's backends alone."""
    code = (
        "import ppr_tpu, ppr_tpu.service, ppr_tpu.serving\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, xla_bridge._backends\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=300)
