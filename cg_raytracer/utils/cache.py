"""Persistent XLA compilation cache setup.

First compiles of a full render or train step take seconds to minutes; the
persistent cache lets every later process reuse the compiled executable.
Called from the CLI and benchmark entry points (not at package import, to avoid
surprising side effects for library users).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and nowhere
else.  Otherwise it lives in ``build/xla_cache`` of the checkout (listed in
.gitignore): a fixed path, because the path is part of the cache's key.
"""
from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "build", "xla_cache")


def compilation_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.normpath(
        DEFAULT_CACHE_DIR)


def enable_compilation_cache() -> None:
    import jax

    if jax.default_backend() == "cpu":
        # XLA:CPU cache entries are AOT executables whose recorded machine
        # features can mismatch the loading host ("could lead to execution
        # errors such as SIGILL", cpu_aot_loader.cc) — observed as
        # intermittent SIGABRTs on reload.  CPU compiles are fast anyway.
        return
    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
