"""The platform query that route choice reads, and the compile cache.

Every route decision that depends on the machine asks :func:`platform`
once, at plan time. The answer is JAX's default backend: ``"cpu"`` or
``"gpu"``; any other platform is refused, so no code path runs a route
that was written for another machine.
"""

from __future__ import annotations

import os
from pathlib import Path

PLATFORMS = ("cpu", "gpu")

# fixed in-checkout cache location (listed in .gitignore): the path is part
# of the cache key, so a directory that moved between runs would never hit
_DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def platform() -> str:
    """JAX's default backend, one of :data:`PLATFORMS`."""
    import jax

    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}; sblas runs on {PLATFORMS}")
    return p


def device_bytes_limit() -> int | None:
    """Memory the first device may allocate, or None where JAX does not
    report it (the CPU backend)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else int(stats["bytes_limit"])


def use_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` at the
    root of the checkout."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        _DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
