"""Persistent XLA compilation cache for the entry points (CLI, bench,
chip smoke test).

Importing the package changes no JAX setting; an entry point calls
``enable()`` once, before its first compile. Keyed on the HLO and the
device, so identical compiles are served from disk across processes: a
full-width engine config compiles for minutes, which the cache turns into
seconds on the second run.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".xla_cache")


def enable(backend: str | None = None) -> str | None:
    """Turn the cache on; returns the directory this call set, else None.

    * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, so nothing is
      set here (the caller's or the machine's directory wins).
    * CPU backend: off. XLA:CPU executables encode the exact host machine
      features; one loaded under other flags changes instruction selection
      enough to flip float rounding (and so a whole trajectory) between
      processes.
    * Otherwise: the fixed path ``<checkout>/.xla_cache``. A fixed path
      matters — the directory is part of what a later run must find.

    backend: the resolved JAX backend (default ``jax.default_backend()``).
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if (backend or jax.default_backend()) == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CHECKOUT_CACHE_DIR
