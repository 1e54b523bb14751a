"""Persistent XLA compilation cache.

The walk engines compile into large programs (the queued hub walker
inlines ``unroll * flush_every`` round bodies into one ``while_loop``),
and a cold compile of the full pipeline costs tens of seconds per
process. The reference has no analogue (Numba caches its JIT output in
``__pycache__`` automatically); this is the JAX equivalent — compiled
executables persist across processes, so the second run of a pipeline
skips most of XLA.

Policy (``cache_dir_to_set``):

* ``JAX_COMPILATION_CACHE_DIR`` set (or ``jax_compilation_cache_dir``
  configured in code): JAX uses it, and nothing is set here.
* otherwise, on an accelerator: ``.jax_cache/`` at the root of the
  checkout (listed in ``.gitignore``). The path is part of the cache
  key, so it stays fixed.
* the CPU backend stays uncached: XLA:CPU entries are specialized to the
  compiling host's CPU features, and loading one written on a different
  host warns of (and risks) a SIGILL.

Enabled by the CLI, ``Base`` construction, and the benchmarks. Opt out
with ``PECANPY_TPU_COMPILE_CACHE=0``.
"""
import os
from typing import Optional

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)

_done = False


def cache_dir_to_set(backend: str, configured: Optional[str]) -> Optional[str]:
    """The directory to point JAX's cache at, or None to set nothing.

    ``configured`` is JAX's current ``jax_compilation_cache_dir`` (which
    JAX fills from ``JAX_COMPILATION_CACHE_DIR``).
    """
    if os.environ.get("PECANPY_TPU_COMPILE_CACHE", "1") == "0":
        return None
    if configured or backend == "cpu":
        return None
    return CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> None:
    """Idempotently apply the policy above (initializes the backend)."""
    global _done
    if _done:
        return
    _done = True
    import jax

    path = cache_dir_to_set(
        jax.default_backend(), jax.config.jax_compilation_cache_dir
    )
    if path is None:
        return
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return  # read-only checkout: run uncached
    jax.config.update("jax_compilation_cache_dir", path)
