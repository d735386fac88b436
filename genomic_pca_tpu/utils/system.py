"""Process resource preflight.

Equivalent of the reference's rlimit queries before spawning its actor
pool (/root/reference/src/main.rs:37-51, 253-267): log the soft limits
for open files and processes/threads and warn when the planned
parallelism approaches them.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


def rlimit_soft(name: str) -> int:
    """Soft limit for 'nofile' or 'nproc'; -1 if unavailable."""
    try:
        import resource

        res = {
            "nofile": resource.RLIMIT_NOFILE,
            "nproc": resource.RLIMIT_NPROC,
        }[name]
        soft, _hard = resource.getrlimit(res)
        return soft if soft != resource.RLIM_INFINITY else 1 << 30
    except (ImportError, KeyError, ValueError, OSError):
        return -1


def preflight(planned_threads: int) -> None:
    """Log limits; warn if planned parallelism is close to them."""
    nofile = rlimit_soft("nofile")
    nproc = rlimit_soft("nproc")
    log.info(
        "Resource preflight: RLIMIT_NOFILE(soft)=%s RLIMIT_NPROC(soft)=%s "
        "planned_threads=%d",
        nofile, nproc, planned_threads,
    )
    if 0 < nproc < planned_threads + 16:
        log.warning(
            "Planned thread count %d is close to the NPROC soft limit %d.",
            planned_threads, nproc,
        )
    if 0 < nofile < 64:
        log.warning("NOFILE soft limit %d is unusually low.", nofile)
