"""Process-wide JAX configuration for the encoder.

Persistent compilation cache: every fixed-buffer pipeline executable
(2048x2048 LF group etc.) is compiled once and kept on disk, so later
processes start hot.  The directory is JAX_COMPILATION_CACHE_DIR when
that is set (JAX reads it itself; nothing here overrides it), else one
fixed directory inside the checkout -- the path is part of what makes a
later process find the entries, so it never depends on a temp name, a
PID or the time."""

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")

_done = False


def cache_dir(environ=os.environ) -> str:
    """The compile-cache directory this process uses."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def ensure() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    # persist EVERYTHING: the default 1.0 s floor skips the small
    # fetch-slicer/concat executables, which every new process would
    # then compile again on its first encode
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
