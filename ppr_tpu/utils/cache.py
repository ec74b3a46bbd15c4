"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise compiled programs go to ``.jax_cache/`` at the
root of the checkout: a fixed path, because the directory is part of what a
later process must find again."""

from __future__ import annotations

import os

#: fixed in-checkout default (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory compiled programs are kept in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> None:
    """Point JAX at :func:`cache_dir` (entry points call this once)."""
    import jax

    if jax.default_backend() == "cpu":
        # NEVER cache CPU executables: XLA:CPU AOT results carry exact
        # machine-feature sets (+prefer-no-scatter etc.) and loading an
        # entry compiled for a different feature profile intermittently
        # SIGILL/SIGABRTs the process. CPU compiles are fast anyway.
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
