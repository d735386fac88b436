"""Host-streamed standardized matrix for bigger-than-device datasets.

Implements `ops.operator.StandardizedOperator` (see ops/operator.py for
the container role split) but the genotype strips
live on HOST (disk via BedReader, or RAM) and stream through the prefetch
pipeline (io/prefetch.py) each pass, double-buffered against device
compute.  This is the reference's lazy accessor + IoService combination
(/root/reference/src/prepare.rs:169-920, 1838-2029): whole strips copy
to the device ahead of use and run through the same XLA strip products
as the resident container (ops/products.py).

Strips can be int8 dosages or PLINK 2-bit packed bytes (`packed=True`):
the packed layout moves 4x less data per pass over the host->device
link — the bottleneck of this container by construction.

Use when the resident matrix exceeds device memory; otherwise prefer
ShardedMatrix (strips resident, no re-read per pass).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from genomic_pca_tpu.io.prefetch import StripPrefetcher
from genomic_pca_tpu.ops import products
from genomic_pca_tpu.ops.rsvd import quantize_basis, subspace_residual

log = logging.getLogger(__name__)

MISSING = -127


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class StreamingMatrix:
    """Standardized genotype operator streamed from host per pass.

    `strip_source(i)` returns host arrays for strip i:
      dense  — (geno int8 (S, N), mean (S,), std (S,))
      packed — (PLINK bytes uint8 (S, ceil(N/4)), mean (S,), std (S,)),
               trailing-bit sanitized (`sanitize_partial_byte`).
    Every strip must have the same row count S = `strip_size` (sources
    pad the last strip; padded rows carry std = 0 and are inert).
    """

    def __init__(
        self,
        strip_source: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
        n_strips: int,
        n_rows: int,
        n_samples: int,
        strip_size: int,
        tile_d: int = 1024,
        kernel_precision: Optional[str] = None,
        prefetch_depth: int = 3,
        prefetch_workers: int = 4,
        packed: bool = False,
        devices=None,
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
    ):
        from genomic_pca_tpu.parallel.sharded import (
            DEFAULT_KERNEL_PRECISION, packed_cols, resolve_q8_polish,
        )

        kernel_precision = kernel_precision or DEFAULT_KERNEL_PRECISION

        # Multi-device streaming: strips round-robin across the local
        # devices (strip i -> device i mod D), so the host->device link
        # and the per-strip products scale with the device count.  Each
        # device keeps its own partial accumulator; the small condensed
        # factors ((N, l) / (l, l)) merge once per pass at the end — the
        # streaming analog of ShardedMatrix's variant-axis psum.
        self.devices = (
            list(devices) if devices is not None else jax.local_devices()
        )
        self._source = strip_source
        self.n_strips = n_strips
        self.n_rows = n_rows
        self.n_samples = n_samples
        self.strip_size = strip_size
        self.packed = packed
        if packed:
            self.n4_pad = packed_cols(n_samples)
            self.n_pad = 4 * self.n4_pad
        else:
            self.n4_pad = 0
            self.n_pad = _round_up(n_samples, 128)
        # Each strip runs as whole scan steps of `step` rows: a short
        # strip is one step; a longer one row-pads to a step multiple.
        step = products.strip_rows(self.n_pad, tile_d)
        if strip_size <= step:
            step = strip_size
        self.step = step
        self.strip_rows = _round_up(strip_size, step)
        self.tile_d = tile_d
        self.kernel_precision = kernel_precision
        self.exact_precision = products.exact_precision(kernel_precision)
        self.q8_polish = resolve_q8_polish(q8_polish, missing_fraction)
        if kernel_precision == "q8":
            log.info(
                "Streaming container: int8 quantized steering passes "
                "active (packed=%s, polish=%d).", packed, self.q8_polish,
            )
        self.prefetch_depth = prefetch_depth
        self.prefetch_workers = prefetch_workers
        self.last_telemetry = None

    # ------------------------------------------------------------------
    def _fetch(self, i: int):
        from genomic_pca_tpu.parallel.sharded import PACKED_MISSING_BYTE, inv_std_of

        g, m, s = self._source(i)
        m = np.asarray(m, dtype=np.float32)
        s = np.asarray(s, dtype=np.float32)
        inv = inv_std_of(s).astype(np.float32)
        if self.packed:
            g = np.asarray(g, dtype=np.uint8)
            if g.shape[1] < self.n4_pad:  # pad byte columns, all-missing
                pad = self.n4_pad - g.shape[1]
                g = np.pad(g, ((0, 0), (0, pad)),
                           constant_values=PACKED_MISSING_BYTE)
        else:
            g = np.asarray(g, dtype=np.int8)
            if g.shape[1] < self.n_pad:  # pad samples with missing
                pad = self.n_pad - g.shape[1]
                g = np.pad(g, ((0, 0), (0, pad)), constant_values=MISSING)
        if g.shape[0] < self.strip_rows:  # pad rows to whole scan steps
            pad = self.strip_rows - g.shape[0]
            fill = PACKED_MISSING_BYTE if self.packed else 0
            g = np.pad(g, ((0, pad), (0, 0)), constant_values=fill)
            m = np.pad(m, (0, pad))
            inv = np.pad(inv, (0, pad))  # inv_std = 0: inert rows
        # HOST payload only: the device upload happens on the consumer
        # thread in `_prefetcher`, in strip order.
        return (g, m.reshape(-1, 1), inv.reshape(-1, 1)), g.nbytes

    def _prefetcher(self):
        p = StripPrefetcher(
            self._fetch,
            self.n_strips,
            depth=self.prefetch_depth,
            max_workers=self.prefetch_workers,
        )
        self.last_telemetry = p.telemetry

        def _uploaded():
            # try/finally so an abandoned pass (exception or early break
            # in the consumer) deterministically stops the workers
            # instead of relying on GC to close the generator chain.
            try:
                for i, (g, m, inv) in enumerate(p):
                    dev = self.devices[i % len(self.devices)]
                    # device_put enqueues asynchronously: strip i+1's
                    # wire transfer overlaps strip i's compute via the
                    # stream.
                    yield (
                        jax.device_put(g, dev),
                        jax.device_put(m, dev),
                        jax.device_put(inv, dev),
                    )
            finally:
                p.close()

        return _uploaded()

    def _pad_b(self, b: jax.Array) -> jax.Array:
        n, ell = b.shape
        out = jnp.zeros((self.n_pad, ell), dtype=jnp.float32)
        return out.at[:n, :].set(jnp.asarray(b, jnp.float32))

    def _strip_right(self, g, m, iv, b):
        return products.right(
            g, m, iv, b, precision=self.exact_precision, step=self.step
        )

    def _strip_gram(self, g, m, iv, b):
        return products.gram(
            g, m, iv, b, precision=self.exact_precision, step=self.step
        )

    def _strip_tsq(self, w):
        return products.tsq_of(w, self.exact_precision)

    # ---- multi-device accumulation helpers ---------------------------
    def _replicate_b(self, bp: jax.Array):
        """Replicate the padded sketch onto every streaming device."""
        return [jax.device_put(bp, d) for d in self.devices]

    def _combine(self, accs: dict) -> jax.Array:
        """Merge per-device partial accumulators (one small transfer per
        extra device — the streaming analog of the psum over "v")."""
        dev0 = self.devices[0]
        total = None
        for d in self.devices:
            if d not in accs:
                continue
            part = accs[d] if d is dev0 else jax.device_put(accs[d], dev0)
            total = part if total is None else total + part
        return total

    # ---- public passes ----------------------------------------------
    def gram_apply(self, b: jax.Array) -> jax.Array:
        bp = self._pad_b(b)
        bps = self._replicate_b(bp)
        accs: dict = {}
        for i, (g, m, iv) in enumerate(self._prefetcher()):
            d = self.devices[i % len(self.devices)]
            part = self._strip_gram(g, m, iv, bps[i % len(self.devices)])
            accs[d] = part if d not in accs else accs[d] + part
        return self._combine(accs)[: self.n_samples]

    def _gram_apply_q8(self, b: jax.Array) -> jax.Array:
        """Quantized steering pass: A^T A b with int8 matmuls per
        strip.  Used only inside `power_iterate`; user-visible products
        always run the exact ones."""
        bq, sb, csum = quantize_basis(self._pad_b(b))
        parts = [
            tuple(jax.device_put(x, d) for x in (bq, sb, csum))
            for d in self.devices
        ]
        accs: dict = {}
        for i, (g, m, iv) in enumerate(self._prefetcher()):
            di = i % len(self.devices)
            d = self.devices[di]
            part = products.gram_q8(
                g, iv, m * iv, *parts[di], step=self.step
            )
            accs[d] = part if d not in accs else accs[d] + part
        return self._combine(accs)[: self.n_samples]

    def power_iterate(
        self,
        b0: jax.Array,
        n_iter: int,
        tolerance: Optional[float] = None,
    ) -> jax.Array:
        """n_iter x (B <- qr(A^T A B)), one full streaming pass each:
        (n_samples, l) orthonormal basis.  With kernel_precision="q8"
        the first n_iter - q8_polish passes run the int8 products and
        the final `q8_polish` passes run exact, the
        same polish discipline as ShardedMatrix.power_iterate.  With
        `tolerance` the STEERING passes early-exit on the relative
        subspace residual (exact polish always runs) and the return is
        (basis, n_iterations_done)."""
        b = jnp.asarray(b0, jnp.float32)
        use_q8 = self.kernel_precision == "q8"
        n_q8 = max(n_iter - self.q8_polish, 0) if use_q8 else 0
        n_done = 0
        converged = False
        for t in range(n_iter):
            is_polish = use_q8 and t >= n_q8
            if converged and not is_polish:
                continue
            tmat = self._gram_apply_q8(b) if t < n_q8 else self.gram_apply(b)
            res = None
            if tolerance is not None and t > 0 and not converged:
                res = float(subspace_residual(b, tmat))
            b, _ = jnp.linalg.qr(tmat)
            n_done += 1
            if res is not None and res < tolerance:
                if not use_q8:
                    break
                converged = True  # skip remaining steering; polish runs
        if tolerance is None:
            return b
        return b, n_done

    def tsq_accumulate(self, b: jax.Array) -> jax.Array:
        bp = self._pad_b(b)
        bps = self._replicate_b(bp)
        accs: dict = {}
        for i, (g, m, iv) in enumerate(self._prefetcher()):
            d = self.devices[i % len(self.devices)]
            part = products.tsq(
                g, m, iv, bps[i % len(self.devices)],
                precision=self.exact_precision, step=self.step,
            )
            accs[d] = part if d not in accs else accs[d] + part
        return self._combine(accs)

    def right_apply(self, b: jax.Array) -> np.ndarray:
        bp = self._pad_b(b)
        bps = self._replicate_b(bp)
        outs = []
        for i, (g, m, iv) in enumerate(self._prefetcher()):
            w = self._strip_right(g, m, iv, bps[i % len(self.devices)])
            # real (unpadded) rows of strip i — strips may be row-padded
            # past strip_size to a whole number of scan steps.
            real = min(self.strip_size, self.n_rows - i * self.strip_size)
            outs.append(np.asarray(w[:real]))
        return np.concatenate(outs, axis=0)

    # Device-side A B capture budget: per-strip products kept in device
    # memory total n_strips x strip_rows x ell x 4 bytes.  Conservative;
    # past it the host-capture path below applies.
    _CAPTURE_DEVICE_BUDGET = 6 << 30

    def tsq_and_project(self, b: jax.Array):
        """One fused streaming pass returning `tsq_accumulate(b)`
        ((l, l) device) and a `project(w_k) -> (n_rows, k) float32 host`
        closure.

        Improvement over `tsq_and_capture` for asymmetric links: the
        per-strip `A_s B` products STAY ON THEIR DEVICE, and `project`
        contracts each with the (l, k) eigenvector block there before
        downloading — device-to-host moves (n_rows, k) instead of
        (n_rows, l).  At l = 128 lane-filled refinement width and
        k = 40 that is 3.2x fewer D2H bytes (the loadings floor), with
        zero cross-device traffic (each strip projects where it lives).
        Falls back to None (callers use `tsq_and_capture`) when the
        captured products would not fit the HBM budget.
        """
        ell = b.shape[1]
        cap_bytes = self.n_strips * self.strip_rows * ell * 4
        if cap_bytes > self._CAPTURE_DEVICE_BUDGET:
            return None
        bp = self._pad_b(b)
        bps = self._replicate_b(bp)
        accs: dict = {}
        ws: list = []  # per-strip (strip_rows, ell) device arrays
        for i, (g, m, iv) in enumerate(self._prefetcher()):
            d = self.devices[i % len(self.devices)]
            w = self._strip_right(g, m, iv, bps[i % len(self.devices)])
            part = self._strip_tsq(w)
            accs[d] = part if d not in accs else accs[d] + part
            ws.append(w)
        acc = self._combine(accs)

        def project(w_small: np.ndarray) -> np.ndarray:
            w_small = np.asarray(w_small, dtype=np.float32)
            pads = [jax.device_put(w_small, d) for d in self.devices]
            outs = []
            for i, w in enumerate(ws):
                p = pads[i % len(self.devices)]
                real = min(
                    self.strip_size, self.n_rows - i * self.strip_size
                )
                outs.append(
                    np.asarray(
                        jnp.dot(
                            w[:real], p,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST,
                        )
                    )
                )
            ws.clear()  # release the captured products
            return np.concatenate(outs, axis=0)

        return acc, project

    def tsq_and_capture(self, b: jax.Array):
        """One fused streaming pass returning BOTH
        `tsq_accumulate(b)` ((l, l) device) and `A B` ((n_rows, l) host).

        PCA finalization needs the condensed Gram of the final basis AND
        the loadings `A V / sigma`; since `V = B W`,
        `A V = (A B) W` — so capturing the per-strip `A_s B` products the
        tsq already computes saves one full pass over the data (each
        streaming pass re-reads and re-uploads the whole matrix).
        Callers finish with a host-side `(A B) @ W` (models use it via
        the `tsq_and_capture` duck-type check).  Host memory cost:
        n_rows x l f32.
        """
        bp = self._pad_b(b)
        bps = self._replicate_b(bp)
        accs: dict = {}
        outs = []
        for i, (g, m, iv) in enumerate(self._prefetcher()):
            d = self.devices[i % len(self.devices)]
            w = self._strip_right(g, m, iv, bps[i % len(self.devices)])
            part = self._strip_tsq(w)
            accs[d] = part if d not in accs else accs[d] + part
            real = min(self.strip_size, self.n_rows - i * self.strip_size)
            outs.append(np.asarray(w[:real]))
        return self._combine(accs), np.concatenate(outs, axis=0)
