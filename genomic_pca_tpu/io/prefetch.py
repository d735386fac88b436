"""Host -> device prefetch pipeline with a telemetry-driven autoscaler.

Replacement for the reference's actor-based IoService
(/root/reference/src/prepare.rs:169-920).  The reference runs a pool of
BED-reader actor threads plus a CONTROLLER thread that re-evaluates the
pool every 750 ms with a 2 s post-action cooldown, scaling on queue
depth vs live actors and keeping an 8 s throughput history ring fed by
per-task byte metrics (prepare.rs:733-861, 247-254).  Here the same
structure keeps the compute engine fed:

* N worker threads fetch strips (disk decode + padding) as HOST
  payloads so host I/O and device compute overlap (double/triple
  buffering).  The `jax.device_put` happens on the CONSUMER thread, in
  strip order; its async enqueue overlaps the transfer with the
  previous strip's compute.
* A controller thread evaluates every `eval_interval_s` with a
  `cooldown_s` after each action (the reference's 750 ms / 2 s pair,
  scaled to strip latencies which are milliseconds here, not disk
  seeks).  Scale **up** when the consumer starved since the last eval
  and the ready-buffer is under-filled; scale **down** when the buffer
  sat full with no starvation (producers idle in backpressure).
* Decisions are THROUGHPUT-DRIVEN, not just queue-driven: each scale-up
  records the windowed bytes/sec before the action, and at the next
  post-cooldown eval the controller reverts the extra worker if it
  bought < 5% more throughput — the reference's telemetry ring made an
  input to the decision rather than passive logging.
* Telemetry mirrors `IoTaskMetrics { bytes_read }` (prepare.rs:247-254):
  bytes moved, windowed throughput, and every scale action.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PrefetchTelemetry:
    bytes_total: int = 0
    strips_total: int = 0
    consumer_waits: int = 0
    workers_high_water: int = 1
    scale_ups: int = 0
    scale_downs: int = 0

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"PrefetchTelemetry(bytes={self.bytes_total}, "
            f"strips={self.strips_total}, waits={self.consumer_waits}, "
            f"workers_hw={self.workers_high_water}, "
            f"ups={self.scale_ups}, downs={self.scale_downs})"
        )


class StripPrefetcher:
    """Ordered prefetching iterator over `fetch(i) for i in range(n)`.

    `fetch` runs on worker threads and should return a HOST-side
    payload plus its host byte count (keep `jax.device_put` on the
    consumer side, in strip order).  Results are delivered strictly in
    order.
    """

    def __init__(
        self,
        fetch: Callable[[int], Tuple[object, int]],
        n_strips: int,
        depth: int = 3,
        max_workers: int = 4,
        autoscale: bool = True,
        timeout_s: float = 60.0,
        eval_interval_s: float = 0.2,
        cooldown_s: float = 0.5,
        initial_workers: int = 1,
    ):
        # timeout_s mirrors the reference's DEFAULT_IO_OPERATION_TIMEOUT
        # of 60 s on every request/response (prepare.rs:180, 1161).
        self._fetch = fetch
        self.n_strips = n_strips
        self.depth = max(1, depth)
        self.max_workers = max(1, max_workers)
        self.autoscale = autoscale
        self.timeout_s = timeout_s
        self.eval_interval_s = eval_interval_s
        self.cooldown_s = cooldown_s
        self.telemetry = PrefetchTelemetry()
        self._results: dict = {}
        self._results_lock = threading.Condition()
        self._next_to_fetch = 0
        self._fetch_lock = threading.Lock()
        self._stop = threading.Event()
        self._workers: list = []
        self._workers_lock = threading.Lock()
        self._target_workers = min(max(1, initial_workers), self.max_workers)
        self._controller: Optional[threading.Thread] = None
        self._waits_at_eval = 0
        self._window = collections.deque(maxlen=256)  # (t, bytes)
        self._window_lock = threading.Lock()

    # ---- worker machinery -------------------------------------------
    def _claim(self) -> Optional[int]:
        with self._fetch_lock:
            if self._next_to_fetch >= self.n_strips:
                return None
            i = self._next_to_fetch
            self._next_to_fetch += 1
            return i

    def _worker(self, wid: int) -> None:
        while not self._stop.is_set():
            # Respect shrink decisions: workers above target exit
            # (the reference retires one actor per scale-down step,
            # prepare.rs:823-845).
            if wid >= self._target_workers:
                return
            # Backpressure: don't run ahead of the consumer by > depth.
            with self._results_lock:
                while (
                    len(self._results) >= self.depth and not self._stop.is_set()
                ):
                    self._results_lock.wait(timeout=0.1)
            if self._stop.is_set():
                return
            i = self._claim()
            if i is None:
                return
            try:
                payload, nbytes = self._fetch(i)
                err = None
            except Exception as e:  # deliver the error in-order
                payload, nbytes, err = None, 0, e
            with self._results_lock:
                self._results[i] = (payload, err)
                self.telemetry.bytes_total += nbytes
                self.telemetry.strips_total += 1
                with self._window_lock:
                    self._window.append((time.monotonic(), nbytes))
                self._results_lock.notify_all()

    def _ensure_workers(self) -> None:
        with self._workers_lock:
            alive = [w for w in self._workers if w.is_alive()]
            self._workers = alive
            while len(self._workers) < self._target_workers:
                wid = len(self._workers)
                t = threading.Thread(
                    target=self._worker, args=(wid,), daemon=True,
                    name=f"prefetch-{wid}",
                )
                t.start()
                self._workers.append(t)
            self.telemetry.workers_high_water = max(
                self.telemetry.workers_high_water, len(self._workers)
            )

    # ---- controller (reference: io_service_controller_thread) --------
    def _decide(
        self,
        backlog: int,
        starved_since: int,
        remaining: int,
        bps: float,
        probe: Optional[float],
    ) -> Tuple[str, Optional[float]]:
        """One controller decision (pure; the loop supplies the signals).

        Returns (action, new_probe) with action in
        {"up", "down_probe", "down_idle", "hold"}:

        * up         — consumer starved since last eval and the ready
                       buffer is under-filled (reference: queue > 3x
                       live actors, prepare.rs:772-822).  Records the
                       pre-action throughput as a probe.
        * down_probe — the last scale-up bought < 5% more windowed Bps
                       and starvation stopped: give the worker back
                       (the telemetry ring DRIVING the decision).
        * down_idle  — buffer sat full with no starvation: producers
                       idle in backpressure (reference: queue < 1.5x
                       actors, prepare.rs:823-845).
        """
        if (
            probe is not None
            and starved_since == 0
            and probe > 0
            and bps < 1.05 * probe
            and self._target_workers > 1
        ):
            return "down_probe", None
        if (
            starved_since > 0
            and backlog < self.depth
            and self._target_workers < self.max_workers
            and remaining > 0
        ):
            return "up", bps
        if (
            starved_since == 0
            and backlog >= self.depth
            and self._target_workers > 1
        ):
            return "down_idle", None
        return "hold", None

    def _apply_decision(self, action: str, new_probe: Optional[float]):
        if action == "up":
            self._target_workers += 1
            self.telemetry.scale_ups += 1
            self._ensure_workers()
            log.debug("prefetch scale-up to %d workers", self._target_workers)
        elif action in ("down_probe", "down_idle"):
            self._target_workers -= 1
            self.telemetry.scale_downs += 1
            log.debug(
                "prefetch scale-down to %d workers (%s)",
                self._target_workers, action,
            )
        return new_probe

    def _controller_loop(self) -> None:
        """Periodic eval + cooldown autoscaler (prepare.rs:733-861)."""
        last_action = 0.0
        probe: Optional[float] = None  # Bps before the last scale-up
        while not self._stop.wait(self.eval_interval_s):
            with self._results_lock:
                backlog = len(self._results)
                waits = self.telemetry.consumer_waits
            with self._fetch_lock:
                remaining = self.n_strips - self._next_to_fetch
            now = time.monotonic()
            if now - last_action < self.cooldown_s:
                continue
            starved_since = waits - self._waits_at_eval
            self._waits_at_eval = waits
            action, new_probe = self._decide(
                backlog, starved_since, remaining, self.throughput_bps(), probe
            )
            probe = self._apply_decision(action, new_probe)
            if action != "hold":
                last_action = now

    def _start_controller(self) -> None:
        if not self.autoscale or self._controller is not None:
            return
        self._controller = threading.Thread(
            target=self._controller_loop, daemon=True, name="prefetch-ctl"
        )
        self._controller.start()

    # ---- consumer API -----------------------------------------------
    def __iter__(self) -> Iterator[object]:
        self._ensure_workers()
        self._start_controller()
        try:
            for i in range(self.n_strips):
                deadline = time.monotonic() + self.timeout_s
                with self._results_lock:
                    starved = i not in self._results
                    if starved:
                        self.telemetry.consumer_waits += 1
                    while i not in self._results:
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"Strip {i} not produced within "
                                f"{self.timeout_s:.0f}s."
                            )
                        self._ensure_workers()
                        self._results_lock.wait(timeout=0.1)
                    payload, err = self._results.pop(i)
                    self._results_lock.notify_all()
                self._ensure_workers()
                if err is not None:
                    raise err
                yield payload
        finally:
            # One shutdown path: close() also clears queued payloads —
            # after a completed pass the queue is empty anyway, and on
            # early exit dropping them releases strip memory sooner.
            self.close()

    def close(self) -> None:
        """Deterministically stop workers + controller (idempotent).

        Consumers that may abandon a pass mid-loop (exception, early
        break) call this from a try/finally so worker shutdown does not
        depend on GC closing a nested generator chain — until the stop
        event is set, daemon workers spin on 0.1 s backpressure polls
        holding strip payloads.
        """
        self._stop.set()
        with self._results_lock:
            self._results.clear()
            self._results_lock.notify_all()
        if self._controller is not None:
            self._controller.join(timeout=2.0)

    def throughput_bps(self, window_s: float = 8.0) -> float:
        """Windowed bytes/sec (reference: 8 s window, prepare.rs:753-770)."""
        now = time.monotonic()
        # Snapshot under the lock: worker appends during iteration raise
        # "deque mutated during iteration" and kill the controller
        # thread (observed at biobank scale).
        with self._window_lock:
            snap = list(self._window)
        pts = [(t, b) for t, b in snap if now - t <= window_s]
        if not pts:
            return 0.0
        span = max(now - pts[0][0], 1e-6)
        return sum(b for _, b in pts) / span
