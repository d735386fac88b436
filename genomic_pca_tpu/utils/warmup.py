"""Background backend warm-up.

The FIRST device operation of a process pays a one-time backend
initialization (client and device setup, seconds on a GPU) that no
compilation cache can remove.  Both workflows start with host-only work
measured in seconds to minutes (VCF parsing, BED QC scan), so the init
cost disappears if a background thread touches the device while the
host parses.

The thread runs one trivial jitted op end-to-end (dispatch + fetch):
that forces client init, device handshake, and the first executable
load.  Errors are swallowed — the workflow's first real device op will
surface any genuine backend failure with full context.

This plays the same latency-hiding role as the reference's IoService
actor pool spin-up happening concurrently with BIM/FAM metadata loading
(/root/reference/src/prepare.rs:923-993), applied to the backend-init
axis instead of file I/O.
"""

from __future__ import annotations

import logging
import threading
import time

log = logging.getLogger(__name__)

_lock = threading.Lock()
_started: threading.Thread | None = None


def warm_backend_async() -> threading.Thread:
    """Start (once) a daemon thread that initializes the JAX backend.

    Returns the thread; callers never need to join it — the main
    thread's first device op blocks on the same internal init lock and
    proceeds as soon as init completes.
    """
    global _started
    with _lock:
        if _started is not None:
            return _started

        def _touch() -> None:
            t0 = time.perf_counter()
            try:
                import jax
                import jax.numpy as jnp
                import numpy as np

                # ONE jitted program (eager zeros + add would compile
                # two separate op programs — each a cold remote
                # round-trip on the compile service).
                np.asarray(
                    jax.jit(lambda: jnp.zeros((8, 128), jnp.float32) + 1.0)()
                )
                log.debug(
                    "Backend warm-up finished in %.1fs",
                    time.perf_counter() - t0,
                )
            except Exception as exc:  # pragma: no cover - backend-specific
                log.debug("Backend warm-up failed (deferred): %s", exc)

        _started = threading.Thread(
            target=_touch, name="backend-warmup", daemon=True
        )
        _started.start()
        return _started


def process_count_nodevice() -> int:
    """`jax.process_count()` without forcing backend initialization.

    `jax.process_count()` materializes the backend (it enumerates
    devices), which on a remote backend blocks the MAIN thread on the
    ~60-70 s init this module exists to hide.  Resolution order:

    1. The `jax.distributed` client, when one was created — its
       num_processes is authoritative without touching devices.
    2. If the backend is ALREADY initialized (warm-up thread finished,
       or any earlier device op ran), `jax.process_count()` is free —
       and it matters: on multi-host accelerator clusters the PJRT client
       reports the real host count even when `jax.distributed` was
       never initialized, and taking the single-process branch there
       while the array layer shards by the real count would duplicate
       every variant (see `assert_process_count_consistent`).
    3. Otherwise no multi-controller runtime can exist yet in this
       process, so the count is 1 *for now*; call sites that later
       build global arrays re-validate via
       `assert_process_count_consistent` once the backend is up.
    """
    try:
        from jax._src import distributed

        state = distributed.global_state
        if getattr(state, "client", None) is not None:
            n = getattr(state, "num_processes", None)
            if n:
                return int(n)
    except Exception:
        pass
    try:
        from jax._src import xla_bridge

        if xla_bridge.backends_are_initialized():
            import jax

            return jax.process_count()
    except Exception:
        import jax

        return jax.process_count()
    return 1


def assert_process_count_consistent(assumed: int) -> None:
    """Fail fast if an early (no-device) process count drove a layout
    decision that the now-initialized backend contradicts.

    Called before building global sharded arrays: by then the backend
    is (or is about to be) materialized anyway, so `jax.process_count()`
    is free.  A mismatch means host-side work was partitioned for
    `assumed` processes while the array layer would shard for the real
    count — duplicating or dropping variants — so it must be a hard
    error, not a warning.
    """
    import jax

    real = jax.process_count()
    if real != assumed:
        raise RuntimeError(
            f"Process-count mismatch: host-side partitioning assumed "
            f"{assumed} process(es) but the initialized backend reports "
            f"{real}.  On multi-host runs set JAX_COORDINATOR_ADDRESS "
            f"(jax.distributed.initialize) before the workflow starts, or "
            f"initialize the backend first."
        )
