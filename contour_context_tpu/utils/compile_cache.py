"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, benchmarks, scripts, tests): if
`JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing here
overrides it; otherwise the cache lives at `<checkout>/.jax_cache`, a fixed
path, so reruns from the same checkout find what earlier runs compiled.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir(subdir: Optional[str] = None) -> str:
    """The directory the persistent cache should use.

    `subdir` (e.g. a machine fingerprint for CPU AOT entries) is appended
    to the in-checkout default only; an explicit environment setting is
    used as given."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return DEFAULT_DIR if subdir is None else os.path.join(DEFAULT_DIR, subdir)


def enable_compile_cache(subdir: Optional[str] = None) -> str:
    """Point JAX's persistent compilation cache at `cache_dir(subdir)`.

    Sets nothing when `JAX_COMPILATION_CACHE_DIR` is set (JAX reads the
    variable itself). Returns the directory in use."""
    path = cache_dir(subdir)
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
