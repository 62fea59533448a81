"""Persistent XLA compilation cache.

Nothing in a compiled decode program depends on the process, so the
executable is cached on disk and reused across processes and sweep points.
JAX keys entries on the serialized computation, compile options and
backend/runtime version, so any change to a program misses the cache and
recompiles.  The cache directory is part of the key, so it must not move
between runs: it is either what ``JAX_COMPILATION_CACHE_DIR`` says or one
fixed directory beside the package (``.jax_cache/`` at the checkout root,
git-ignored).

Enabled by the pipeline constructor and the decoder factories in
``decoders/select.py``, before their first compile (JAX decides once per
process, at its first compile, whether a cache is used); opt out with
``EXP_LDPC_TPU_NO_COMPILE_CACHE=1``.  On the CPU backend no default cache
is set: its executables are tied to the host's CPU features.
An explicit ``jax_compilation_cache_dir`` (environment or
``jax.config.update``) is always respected and nothing else is set.
"""
from __future__ import annotations

import os

__all__ = ["enable_compilation_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")
_done = False


def enable_compilation_cache(cache_dir: str | None = None) -> None:
    """Idempotently point JAX's persistent compilation cache at
    ``cache_dir`` (default :data:`DEFAULT_CACHE_DIR`) unless the user
    already configured one or opted out."""
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("EXP_LDPC_TPU_NO_COMPILE_CACHE"):
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX reads it itself
    import jax

    if jax.config.jax_compilation_cache_dir:
        return  # user already chose a cache location
    if jax.default_backend() == "cpu":
        return  # XLA:CPU executables are tied to the host's CPU features
    target = cache_dir or DEFAULT_CACHE_DIR
    os.makedirs(target, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", target)
