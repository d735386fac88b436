"""Persistent XLA compilation cache setup.

Without a persistent cache every NEW PROCESS pays every compile again.
Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there and
this module sets nothing.  Otherwise the cache lives in a fixed
`.jax_cache/` directory at the checkout root (the path is part of the
cache key, so it must not move between runs).

Opt out with GENOMIC_PCA_TPU_NO_CACHE=1.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_done = False

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Optional[Path]:
    """The directory this module would configure: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then uses it directly),
    else the checkout's `.jax_cache/`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE_DIR


def enable_persistent_cache() -> None:
    """Idempotent; call before the first jit compilation."""
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("GENOMIC_PCA_TPU_NO_CACHE") == "1":
        return
    target = cache_dir()
    if target is None:
        return
    import jax

    try:
        target.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(target))
        # Persist every program: a cold run is a dozen programs, most
        # of them cheap, and each new process would pay all of them.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        log.debug("Persistent compilation cache at %s", target)
    except (OSError, AttributeError) as e:  # read-only checkout
        log.info("Could not enable persistent compilation cache: %s", e)
