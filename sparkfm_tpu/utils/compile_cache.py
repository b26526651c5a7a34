"""Where the persistent XLA compilation cache lives.

Entry points (cli.main, bench.py, benchmarks/*.py, chip_smoke.py) call
:func:`enable_compile_cache` once before their first compile. A run that
sets ``JAX_COMPILATION_CACHE_DIR`` keeps its cache there: JAX reads the
variable itself and nothing is set in code. Otherwise the cache goes to
``<checkout>/.jax_cache`` (listed in .gitignore), a fixed path, since the
path is part of the cache key.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Use the variable's directory if set, else point JAX's compilation
    cache at ``<checkout>/.jax_cache``; returns the directory in use."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
