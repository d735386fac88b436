"""Profiler trace reduction: trace-derived on-device timings.

Reads the `.xplane.pb` files `jax.profiler.trace` writes, with JAX's own
`jax.profiler.ProfileData` (no other package).  Two views:

- `device_busy_ms`: the union of the intervals in which any kernel or
  copy runs on a device — busy time; divided by the iterations of a
  traced loop it gives device ms/iter.  (GPU traces carry one line per
  CUDA stream, with one event per kernel.)
- `device_op_table`: per-kernel totals across device planes (which
  GEMM or fusion kernel the time went to).

Used by bench.py and chip_smoke.py.
"""

from __future__ import annotations

import glob
from collections import defaultdict
from typing import List, Optional, Tuple


def load_planes(trace_dir: str):
    """Every plane of every *.xplane.pb under trace_dir -> (planes, err)."""
    import jax

    paths = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    if not paths:
        return None, "no xplane.pb captured"
    planes = []
    for path in paths:
        planes.extend(jax.profiler.ProfileData.from_file(path).planes)
    return planes, None


def _is_device_plane(name: str) -> bool:
    low = name.lower()
    return low.startswith("/device:") and "custom" not in low


def _device_line_totals(trace_dir: str):
    """{event name: [total_ms, count]} over every device-plane line."""
    planes, err = load_planes(trace_dir)
    if planes is None:
        return None, err
    totals = defaultdict(lambda: [0.0, 0])
    for plane in planes:
        if not _is_device_plane(plane.name):
            continue
        for line in plane.lines:
            for ev in line.events:
                totals[ev.name][0] += ev.duration_ns / 1e6
                totals[ev.name][1] += 1
    return totals, None


def device_busy_ms(trace_dir: str) -> Tuple[Optional[float], int, Optional[str]]:
    """Device busy time (ms): the union of the intervals in which any
    event runs on a device plane, and the event count.  Returns
    (busy_ms, n_events, err); (None, 0, reason) when the trace holds no
    device events (e.g. CPU runs)."""
    planes, err = load_planes(trace_dir)
    if planes is None:
        return None, 0, err
    spans = sorted(
        (ev.start_ns, ev.start_ns + ev.duration_ns)
        for plane in planes if _is_device_plane(plane.name)
        for line in plane.lines for ev in line.events
    )
    if not spans:
        return None, 0, "no device events"
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e6, len(spans), None


def device_op_table(
    trace_dir: str, top: int = 12,
) -> Tuple[Optional[List[Tuple[str, float, int]]], Optional[str]]:
    """Per-event device totals -> [(event_name, total_ms, count)],
    largest first."""
    totals, err = _device_line_totals(trace_dir)
    if totals is None:
        return None, err
    if not totals:
        return None, "no device kernel events"
    rows = sorted(((op, t, c) for op, (t, c) in totals.items()),
                  key=lambda r: -r[1])[:top]
    return rows, None
