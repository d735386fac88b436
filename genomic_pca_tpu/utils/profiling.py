"""Device profiling hooks.

The reference's profiling story is samply + PGO on the host binary
(/root/reference/README.md:143-173); the analog here is
`jax.profiler` traces viewable in XProf/TensorBoard, plus the throughput
counters the workflows log (SNPs/sec, stage timings).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Iterator, Optional

log = logging.getLogger(__name__)


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace context when a directory is given, else no-op."""
    if not profile_dir:
        yield
        return
    import jax

    log.info("Capturing jax.profiler trace to %s", profile_dir)
    with jax.profiler.trace(profile_dir):
        yield
    log.info("Profiler trace written to %s (view with XProf/TensorBoard).", profile_dir)
