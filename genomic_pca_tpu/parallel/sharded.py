"""Variant-sharded resident matrix: shard_map + XLA strip products + psum.

The production container for the standardized genotype operator A (D x N):

* Genotypes live as one 2-D array (D_pad, cols) sharded over rows on a
  1-D mesh ("v"): int8 dosages, or PLINK 2-bit packed bytes (uint8).
  Per-SNP mean / inv_std columns shard identically.  Row padding carries
  inv_std = 0 (standardizes to zero); sample-column padding is the
  missing sentinel (-127, or the 0x55 byte when packed; standardizes to
  zero); sketch rows pad with zeros.  All padding is mathematically
  inert.
* Each pass runs under `shard_map`: the local row block goes through
  the plain-XLA strip products of ops/products.py, and a single `psum`
  over "v" merges the small condensed factors.  Only (N x l)/(l x l)
  blocks cross between devices.
* On a 1-device mesh the same code is the single-device path.

This replaces the reference's rayon worker pools + flume channels
(src/main.rs:103-106, src/prepare.rs:169-920) per SURVEY §2.3's
equivalence table.
"""

from __future__ import annotations

import functools
import logging
from typing import Iterator, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from genomic_pca_tpu.ops import products
from genomic_pca_tpu.ops.rsvd import (
    cholqr2_q, quantize_basis, subspace_residual,
)
from genomic_pca_tpu.parallel.mesh import VARIANT_AXIS, make_mesh

log = logging.getLogger(__name__)

MISSING = -127


def resolve_q8_polish(
    q8_polish: Optional[int], missing_fraction: Optional[float]
) -> int:
    """Exact-iteration count finishing a quantized power loop.

    The q8 steering passes approximate each missing genotype as raw 0
    (a -u_i operator perturbation, ops/products.py q8 notes), so
    the polish budget scales with how much missingness QC could have
    admitted: <=2% (the default 0.98 call-rate gate) is validated at one
    polish pass (|r| >= 0.99999 vs float64, tests/test_q8.py); looser
    gates get a second exact pass (validated at 10% missing).  Explicit
    `q8_polish` overrides; unknown missingness takes the conservative
    default for the default QC gate.
    """
    if q8_polish is not None:
        if q8_polish < 1:
            raise ValueError("q8_polish must be >= 1 (the Rayleigh-Ritz "
                             "basis must come from an exact pass)")
        return int(q8_polish)
    if missing_fraction is not None and missing_fraction > 0.02:
        return 2
    return 1


# Product precision of every container built without an explicit
# `kernel_precision` (ops/products.py: "f32", "bf16" or "q8").
DEFAULT_KERNEL_PRECISION = "q8"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def inv_std_of(s: np.ndarray) -> np.ndarray:
    """1/std with the zero-std convention (0 -> standardize to zero).

    THE canonical expression for the framework's inert-row convention —
    every matrix-packing site must use it so the fused/re-read/streamed
    paths stay bit-identical.
    """
    s = np.asarray(s)
    return np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)


# --- PLINK 2-bit packed layout helpers -------------------------------------
# Packed mode stores genotypes in PLINK's on-disk 2-bit encoding (uint8,
# 4 samples/byte, low bits first; count_A1 codes 00->2, 01->missing,
# 10->1, 11->0): 4x less device memory and read bandwidth, and BED bytes
# upload verbatim.  Products unpack in original sample order
# (ops/products.unpack_codes).

PACKED_MISSING_BYTE = 0x55  # four 01 (missing) fields


def packed_cols(n_samples: int) -> int:
    """Device column count for packed rows: ceil(n/4) bytes padded to a
    multiple of 128.  THE canonical packed-width expression — the
    capture budget gates, batch padding, and resident-size estimate must
    all agree with the actual device layout."""
    return _round_up(max(-(-n_samples // 4), 1), 128)


@jax.jit
def pack_codes_device(g: jax.Array) -> jax.Array:
    """(D, N) int8 dosages WITHOUT missing values -> (D, N/4) PLINK
    uint8 ON DEVICE (count_A1 codes: 2 -> 00, 1 -> 10, 0 -> 11).

    Device-side re-encode for benchmarks/traces that synthesize data in
    HBM; production ingestion packs on the host (`pack_int8_rows`,
    which also handles the missing sentinel).  N must be a multiple
    of 4."""
    d, n = g.shape
    c = jnp.where(g == 2, 0, 3 - g.astype(jnp.int32)).astype(jnp.uint8)
    c4 = c.reshape(d, n // 4, 4)
    return (
        c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4) | (c4[..., 3] << 6)
    )


def pack_int8_rows(geno: np.ndarray) -> np.ndarray:
    """(D, N) int8 dosages -> (D, ceil(N/4)) PLINK-packed uint8.

    Pad fields (beyond N in the last byte) are 01 = missing (inert) —
    the on-disk encoder zero-fills them (PLINK convention), so sanitize
    afterwards."""
    from genomic_pca_tpu.io.bed import pack_bed_rows

    geno = np.asarray(geno)
    return sanitize_partial_byte(pack_bed_rows(geno), geno.shape[1])


def sanitize_partial_byte(
    packed: np.ndarray, n_samples: int
) -> np.ndarray:
    """Force trailing 2-bit fields of the last data byte to 01 (missing).

    PLINK zero-fills trailing bits, and code 00 means dosage 2 under
    count_A1 — NOT inert.  Call on raw BED bytes before device use."""
    rem = n_samples % 4
    if rem == 0 or packed.shape[1] == 0:
        return packed
    packed = packed.copy()
    keep = (1 << (2 * rem)) - 1
    fill = PACKED_MISSING_BYTE & (0xFF ^ keep)
    packed[:, -1] = (packed[:, -1] & keep) | fill
    return packed


def _slice_blocks_impl(
    geno: jax.Array,  # (D_pad, N_pad) int8
    mean: jax.Array,  # (D_pad, 1) f32
    inv_std: jax.Array,  # (D_pad, 1) f32
    starts: jax.Array,  # (B,) int32 global row starts
    lens: jax.Array,  # (B,) int32 block lengths (<= bucket)
    col_idx,  # (C,) int32 sample columns, or None for all columns
    bucket: int,
) -> jax.Array:
    """(B, bucket, C) f32 standardized row-run blocks, sliced on device.

    Rows outside [start, start+len) and missing genotypes standardize to
    zero (inert padding, same convention as the host accessor).
    Un-jitted core shared by the standalone slicer and the fused
    stage-1+2 program (models/eigensnp.py).
    """
    d_pad = geno.shape[0]

    def one(start, d_b):
        astart = jnp.minimum(start, d_pad - bucket)
        g = jax.lax.dynamic_slice_in_dim(geno, astart, bucket, 0)
        m = jax.lax.dynamic_slice_in_dim(mean, astart, bucket, 0)
        iv = jax.lax.dynamic_slice_in_dim(inv_std, astart, bucket, 0)
        if col_idx is not None:
            g = jnp.take(g, col_idx, axis=1)
        rows = astart + jnp.arange(bucket, dtype=starts.dtype)
        rmask = (rows >= start) & (rows < start + d_b)
        gf = g.astype(jnp.float32)
        x = gf * iv + (-m * iv)
        x = jnp.where(gf == float(MISSING), 0.0, x)
        return jnp.where(rmask[:, None], x, 0.0)

    return jax.vmap(one)(starts, lens)


_slice_blocks_standardized = functools.partial(
    jax.jit, static_argnames=("bucket",)
)(_slice_blocks_impl)


def _slice_blocks_packed_impl(
    geno: jax.Array,  # (D_pad, N4_pad) uint8 packed
    mean: jax.Array,
    inv_std: jax.Array,
    starts: jax.Array,
    lens: jax.Array,
    col_idx,
    bucket: int,
) -> jax.Array:
    """Packed analog of `_slice_blocks_impl`: unpacks the sliced
    rows in ORIGINAL sample order (interleave reshape)."""
    d_pad, n4 = geno.shape

    def one(start, d_b):
        astart = jnp.minimum(start, d_pad - bucket)
        gp = jax.lax.dynamic_slice_in_dim(geno, astart, bucket, 0)
        m = jax.lax.dynamic_slice_in_dim(mean, astart, bucket, 0)
        iv = jax.lax.dynamic_slice_in_dim(inv_std, astart, bucket, 0)
        c = gp.astype(jnp.int32)
        cs = jnp.stack(
            [(c >> (2 * p)) & 3 for p in range(4)], axis=-1
        ).reshape(bucket, 4 * n4)  # original sample order
        x = ((4 - cs) >> 1).astype(jnp.float32) * iv + (-m * iv)
        x = jnp.where(cs != 1, x, 0.0)
        if col_idx is not None:
            x = jnp.take(x, col_idx, axis=1)
        rows = astart + jnp.arange(bucket, dtype=starts.dtype)
        rmask = (rows >= start) & (rows < start + d_b)
        return jnp.where(rmask[:, None], x, 0.0)

    return jax.vmap(one)(starts, lens)


_slice_blocks_standardized_packed = functools.partial(
    jax.jit, static_argnames=("bucket",)
)(_slice_blocks_packed_impl)


class ShardedMatrix:
    """Standardized genotype operator sharded over the variant axis.

    Implements `ops.operator.StandardizedOperator` (n_samples, n_rows,
    gram_apply, tsq_accumulate, right_apply) plus every optional fast
    path (power_iterate, pca_core) — the production device-resident
    container; see ops/operator.py for the container role split.
    """

    def __init__(
        self,
        geno: jax.Array,  # (D_pad, N_pad) int8 / (D_pad, N4_pad) uint8, P(v, None)
        mean: jax.Array,  # (D_pad, 1) f32, P(v, None)
        inv_std: jax.Array,  # (D_pad, 1) f32, P(v, None)
        n_rows: int,
        n_samples: int,
        mesh: Mesh,
        tile_d: int = 1024,
        kernel_precision: Optional[str] = None,
        row_segments: Optional[np.ndarray] = None,
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
    ):
        self.geno = geno
        self.mean = mean
        self.inv_std = inv_std
        self.n_rows = n_rows
        self.n_samples = n_samples
        self.mesh = mesh
        self.q8_polish = resolve_q8_polish(q8_polish, missing_fraction)
        # Segmented row layout (multi-process fused assembly): (S, 3)
        # rows of (matrix_row_start, pca_row_start, count) — real rows
        # live in per-process segments with inert padding between them
        # instead of one prefix run.  None = prefix layout (rows
        # [0, n_rows) are the real rows, padding at the end).
        if row_segments is not None:
            row_segments = np.asarray(row_segments, dtype=np.int64)
            assert row_segments.ndim == 2 and row_segments.shape[1] == 3
            assert int(row_segments[:, 2].sum()) == n_rows
        self.row_segments = row_segments
        kernel_precision = kernel_precision or DEFAULT_KERNEL_PRECISION
        self.kernel_precision = kernel_precision
        self.exact_precision = products.exact_precision(kernel_precision)
        # uint8 genotypes signal the PLINK 2-bit packed layout: the
        # sample axis is 4x the byte axis.
        self.packed = geno.dtype == jnp.uint8
        self.d_pad = geno.shape[0]
        self.n_pad = geno.shape[1] * 4 if self.packed else geno.shape[1]
        # tile_d is the row-padding granule (every shard is a multiple);
        # the products scan strips of `step` rows, a divisor of it.
        self.tile_d = tile_d
        self.step = products.strip_rows(self.n_pad, tile_d)
        if kernel_precision == "q8":
            log.info(
                "int8 quantized power path active (packed=%s, polish=%d "
                "exact pass%s; missing genotypes approximate to raw 0 "
                "during steering iterations only).",
                self.packed, self.q8_polish,
                "" if self.q8_polish == 1 else "es",
            )
        self._build_kernels()

    # ------------------------------------------------------------------
    @staticmethod
    def from_arrays(
        geno_strips: Iterator[np.ndarray],
        means: Optional[List[np.ndarray]] = None,
        stds: Optional[List[np.ndarray]] = None,
        strip_size: int = 2048,
        center_only: bool = False,
        mesh: Optional[Mesh] = None,
        tile_d: int = 1024,
        kernel_precision: Optional[str] = None,
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
    ) -> "ShardedMatrix":
        """Pack host int8 strips into the padded sharded 2-D layout.

        Moments are computed exactly from integer histograms when not
        supplied; `center_only=True` sets inv_std to 1 (VCF-mode
        center-without-scale, matching tests/pca.py:109).  `strip_size`
        is accepted for API compatibility (the XLA fallback scans in
        `tile_d` strips).
        """
        mesh = mesh or make_mesh()
        n_dev = mesh.devices.size

        gs: List[np.ndarray] = []
        ms: List[np.ndarray] = []
        ss: List[np.ndarray] = []
        n_samples = None
        for i, g in enumerate(geno_strips):
            g = np.asarray(g, dtype=np.int8)
            n_samples = g.shape[1] if n_samples is None else n_samples
            if means is not None and stds is not None:
                m = np.asarray(means[i], dtype=np.float32)
                s = np.asarray(stds[i], dtype=np.float32)
            else:
                # Host-side exact integer histograms (avoids a fresh
                # device compile per distinct strip shape at pack time).
                n1 = (g == 1).sum(axis=1, dtype=np.int64)
                n2 = (g == 2).sum(axis=1, dtype=np.int64)
                nv = n1 + n2 + (g == 0).sum(axis=1, dtype=np.int64)
                with np.errstate(divide="ignore", invalid="ignore"):
                    m = np.where(nv > 0, (n1 + 2.0 * n2) / np.maximum(nv, 1), 0.0)
                    ssd = (n1 + 4.0 * n2) - nv * m * m
                    var = np.where(nv >= 2, ssd / np.maximum(nv - 1, 1), 0.0)
                    s = np.sqrt(np.maximum(var, 0.0))
                m = m.astype(np.float32)
                s = s.astype(np.float32)
            if center_only:
                s = np.ones_like(m)
            gs.append(g)
            ms.append(m)
            ss.append(s)
        if n_samples is None:
            raise ValueError("No strips provided.")

        g_all = np.concatenate(gs, axis=0)
        m_all = np.concatenate(ms, axis=0).astype(np.float32)
        s_all = np.concatenate(ss, axis=0).astype(np.float32)
        n_rows = g_all.shape[0]

        d_pad = _round_up(
            max(n_rows, 1),
            tile_d * n_dev,
        )
        n_pad = _round_up(n_samples, 128)
        g_pad = np.full((d_pad, n_pad), MISSING, dtype=np.int8)
        g_pad[:n_rows, :n_samples] = g_all
        m_pad = np.zeros((d_pad, 1), dtype=np.float32)
        m_pad[:n_rows, 0] = m_all
        inv_pad = np.zeros((d_pad, 1), dtype=np.float32)
        inv_pad[:n_rows, 0] = inv_std_of(s_all)

        sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
        return ShardedMatrix(
            geno=jax.device_put(g_pad, sh),
            mean=jax.device_put(m_pad, sh),
            inv_std=jax.device_put(inv_pad, sh),
            n_rows=n_rows,
            n_samples=n_samples,
            mesh=mesh,
            tile_d=tile_d,
            kernel_precision=kernel_precision,
            q8_polish=q8_polish,
            missing_fraction=missing_fraction,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def from_local_rows(
        read_rows,  # Callable[[int, int], (geno, mean, std)] for global rows [lo, hi)
        n_rows: int,
        n_samples: int,
        mesh: Optional[Mesh] = None,
        tile_d: int = 1024,
        kernel_precision: Optional[str] = None,
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
        center_only: bool = False,
        packed: bool = False,
    ) -> "ShardedMatrix":
        """Multi-host constructor: each PROCESS reads only the global row
        range its devices own (per-host BED byte-range reads, SURVEY §5
        long-context mapping), and the global sharded array assembles via
        `jax.make_array_from_process_local_data` — genotypes never
        transit through a single host.

        `read_rows(lo, hi)` returns host arrays for global SNP rows
        [lo, hi) clipped to n_rows: geno (hi-lo', N) int8 dosages — or,
        with `packed=True`, (hi-lo', ceil(N/4)) raw PLINK uint8 bytes
        (sanitized here; 4x less upload per host) — plus mean (hi-lo',)
        and std (hi-lo',).  Works unchanged single-process.
        """
        mesh = mesh or make_mesh()
        n_dev = mesh.devices.size
        d_pad = _round_up(
            max(n_rows, 1),
            tile_d * n_dev,
        )
        n_pad = packed_cols(n_samples) if packed else _round_up(n_samples, 128)
        rows_per_dev = d_pad // n_dev

        proc = jax.process_index()
        flat = list(mesh.devices.flat)
        local_dev_idx = [i for i, d in enumerate(flat) if d.process_index == proc]
        if not local_dev_idx:
            raise ValueError("This process owns no devices in the mesh.")
        lo = min(local_dev_idx) * rows_per_dev
        hi = (max(local_dev_idx) + 1) * rows_per_dev

        geno_dtype = np.uint8 if packed else np.int8
        read_hi = min(hi, n_rows)
        if lo < read_hi:
            g, m, s = read_rows(lo, read_hi)
            g = np.asarray(g, dtype=geno_dtype)
            if packed:
                g = sanitize_partial_byte(g, n_samples)
            m = np.asarray(m, dtype=np.float32)
            s = np.asarray(s, dtype=np.float32)
        else:
            g = np.zeros((0, (n_samples + 3) // 4 if packed else n_samples), geno_dtype)
            m = np.zeros(0, dtype=np.float32)
            s = np.zeros(0, dtype=np.float32)
        if center_only:
            s = np.ones_like(m)

        local_rows = hi - lo
        g_loc = np.full(
            (local_rows, n_pad),
            PACKED_MISSING_BYTE if packed else MISSING,
            dtype=geno_dtype,
        )
        g_loc[: g.shape[0], : g.shape[1]] = g
        m_loc = np.zeros((local_rows, 1), dtype=np.float32)
        m_loc[: len(m), 0] = m
        inv_loc = np.zeros((local_rows, 1), dtype=np.float32)
        inv_loc[: len(s), 0] = inv_std_of(s)

        sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
        if jax.process_count() == 1:
            geno = jax.device_put(g_loc, sh)
            mean = jax.device_put(m_loc, sh)
            inv = jax.device_put(inv_loc, sh)
        else:
            geno = jax.make_array_from_process_local_data(sh, g_loc, (d_pad, n_pad))
            mean = jax.make_array_from_process_local_data(sh, m_loc, (d_pad, 1))
            inv = jax.make_array_from_process_local_data(sh, inv_loc, (d_pad, 1))
        return ShardedMatrix(
            geno=geno,
            mean=mean,
            inv_std=inv,
            n_rows=n_rows,
            n_samples=n_samples,
            mesh=mesh,
            tile_d=tile_d,
            kernel_precision=kernel_precision,
            q8_polish=q8_polish,
            missing_fraction=missing_fraction,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def from_owned_units(
        unit_counts: np.ndarray,  # (U,) global row count per unit
        unit_owner: np.ndarray,  # (U,) owning process index per unit
        local_units,  # {unit_index: (geno, mean, std)} for units THIS process owns
        n_samples: int,
        mesh: Optional[Mesh] = None,
        tile_d: int = 1024,
        kernel_precision: Optional[str] = None,
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
        packed: bool = False,
        center_only: bool = False,
    ) -> "ShardedMatrix":
        """Multi-host constructor for UNIT-sharded ingestion (per-host VCF
        file sharding: each process parses only the files it owns —
        SURVEY §2.3 row 1, the `rayon par_iter` over files of
        /root/reference/src/main.rs:171-179 made distributed).

        `unit_counts`/`unit_owner` are GLOBAL knowledge (identical on
        every process): row count and owning process of each unit (e.g.
        VCF file), in global unit order.  Global PcaSnpId order is unit
        order (reference file-order aggregation, vcf.rs:293-315); each
        unit becomes one row segment placed inside its owner's device
        shard, so genotypes never leave the process that parsed them.
        With `packed=True` unit genotypes are raw 2-bit rows (sanitized
        here).  Works unchanged single-process.
        """
        mesh = mesh or make_mesh()
        unit_counts = np.asarray(unit_counts, dtype=np.int64)
        unit_owner = np.asarray(unit_owner, dtype=np.int64)
        n_units = len(unit_counts)
        n_rows = int(unit_counts.sum())
        proc = jax.process_index()
        n_proc = jax.process_count()

        # Device ranges per process (canonical contiguous layout).
        flat = list(mesh.devices.flat)
        dev_idx_of = {p: [] for p in range(n_proc)}
        for i, d in enumerate(flat):
            dev_idx_of.setdefault(d.process_index, []).append(i)
        ndev_of = {}
        lo_dev_of = {}
        for p, idxs in dev_idx_of.items():
            if not idxs:
                continue
            if max(idxs) - min(idxs) + 1 != len(idxs):
                raise ValueError(
                    "from_owned_units requires each process's devices to "
                    "be contiguous in mesh order"
                )
            ndev_of[p] = len(idxs)
            lo_dev_of[p] = min(idxs)

        # Per-process totals -> uniform rows_per_dev (tile_d-aligned).
        totals = np.zeros(max(n_proc, int(unit_owner.max(initial=0)) + 1),
                         dtype=np.int64)
        for u in range(n_units):
            totals[unit_owner[u]] += unit_counts[u]
        rows_per_dev = 1
        for p, nd in ndev_of.items():
            need = -(-int(totals[p]) // nd)
            rows_per_dev = max(rows_per_dev, need)
        rows_per_dev = _round_up(
            rows_per_dev, tile_d
        )
        d_pad = rows_per_dev * len(flat)
        n_pad = packed_cols(n_samples) if packed else _round_up(n_samples, 128)

        # Global segment table (computed identically on every process):
        # units in global order, placed consecutively inside their
        # owner's row range.
        pca_ofs = np.concatenate([[0], np.cumsum(unit_counts)])
        local_cursor = {p: 0 for p in ndev_of}
        segments = []
        placement = {}  # unit -> matrix_row_start
        for u in range(n_units):
            cnt = int(unit_counts[u])
            if cnt == 0:
                continue
            p = int(unit_owner[u])
            if p not in ndev_of:
                raise ValueError(f"unit {u} owned by process {p} with no devices")
            mstart = lo_dev_of[p] * rows_per_dev + local_cursor[p]
            local_cursor[p] += cnt
            placement[u] = mstart
            segments.append((mstart, int(pca_ofs[u]), cnt))
        segments = np.asarray(
            sorted(segments, key=lambda s: s[1]), dtype=np.int64
        ).reshape(-1, 3)

        # Fill this process's local buffer.
        geno_dtype = np.uint8 if packed else np.int8
        my_lo = lo_dev_of[proc] * rows_per_dev
        my_rows = ndev_of[proc] * rows_per_dev
        g_loc = np.full(
            (my_rows, n_pad),
            PACKED_MISSING_BYTE if packed else MISSING,
            dtype=geno_dtype,
        )
        m_loc = np.zeros((my_rows, 1), dtype=np.float32)
        inv_loc = np.zeros((my_rows, 1), dtype=np.float32)
        for u, (g, m, s) in local_units.items():
            if int(unit_owner[u]) != proc:
                raise ValueError(f"process {proc} supplied unit {u} it does not own")
            g = np.asarray(g, dtype=geno_dtype)
            if packed:
                g = sanitize_partial_byte(g, n_samples)
            ofs = placement[u] - my_lo
            g_loc[ofs : ofs + g.shape[0], : g.shape[1]] = g
            m_loc[ofs : ofs + g.shape[0], 0] = np.asarray(m, dtype=np.float32)
            s_arr = (
                np.ones(g.shape[0], dtype=np.float32)
                if center_only
                else np.asarray(s, dtype=np.float32)
            )
            inv_loc[ofs : ofs + g.shape[0], 0] = inv_std_of(s_arr)

        sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
        if n_proc == 1:
            geno = jax.device_put(g_loc, sh)
            mean = jax.device_put(m_loc, sh)
            inv = jax.device_put(inv_loc, sh)
        else:
            geno = jax.make_array_from_process_local_data(sh, g_loc, (d_pad, n_pad))
            mean = jax.make_array_from_process_local_data(sh, m_loc, (d_pad, 1))
            inv = jax.make_array_from_process_local_data(sh, inv_loc, (d_pad, 1))
        return ShardedMatrix(
            geno=geno,
            mean=mean,
            inv_std=inv,
            n_rows=n_rows,
            n_samples=n_samples,
            mesh=mesh,
            tile_d=tile_d,
            kernel_precision=kernel_precision,
            q8_polish=q8_polish,
            missing_fraction=missing_fraction,
            row_segments=segments,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def from_packed_rows(
        packed_rows: np.ndarray,  # (D, bytes_per_row) uint8 raw PLINK bytes
        mean: np.ndarray,  # (D,) f32
        std: np.ndarray,  # (D,) f32
        n_samples: int,
        mesh: Optional[Mesh] = None,
        tile_d: int = 1024,
        kernel_precision: Optional[str] = None,
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
    ) -> "ShardedMatrix":
        """Build the packed (2-bit) sharded matrix from raw PLINK bytes.

        The bytes upload VERBATIM (after trailing-bit sanitization) —
        no host decode, 4x less transfer and HBM than the int8 layout.
        Row padding is all-missing bytes with inv_std = 0; the sample
        byte axis pads to a 128-lane multiple with 0x55.
        """
        mesh = mesh or make_mesh()
        n_dev = mesh.devices.size
        packed_rows = np.asarray(packed_rows, dtype=np.uint8)
        packed_rows = sanitize_partial_byte(packed_rows, n_samples)
        d = packed_rows.shape[0]
        d_pad = _round_up(
            max(d, 1),
            tile_d * n_dev,
        )
        n4_pad = packed_cols(n_samples)
        g_pad = np.full((d_pad, n4_pad), PACKED_MISSING_BYTE, dtype=np.uint8)
        g_pad[:d, : packed_rows.shape[1]] = packed_rows
        m_pad = np.zeros((d_pad, 1), dtype=np.float32)
        m_pad[:d, 0] = np.asarray(mean, dtype=np.float32)
        inv_pad = np.zeros((d_pad, 1), dtype=np.float32)
        inv_pad[:d, 0] = inv_std_of(np.asarray(std, dtype=np.float32))

        sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
        return ShardedMatrix(
            geno=jax.device_put(g_pad, sh),
            mean=jax.device_put(m_pad, sh),
            inv_std=jax.device_put(inv_pad, sh),
            n_rows=d,
            n_samples=n_samples,
            mesh=mesh,
            tile_d=tile_d,
            kernel_precision=kernel_precision,
            q8_polish=q8_polish,
            missing_fraction=missing_fraction,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def from_packed_strips(
        read_strip,  # Callable[[int, int], np.ndarray] rows [lo, hi) -> (hi-lo, <=cols) uint8
        n_rows: int,
        mean: np.ndarray,
        std: np.ndarray,
        n_samples: int,
        mesh: Optional[Mesh] = None,
        tile_d: int = 1024,
        kernel_precision: Optional[str] = None,
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
        strip_rows: int = 262_144,
    ) -> "ShardedMatrix":
        """Packed constructor that streams strip-sized host buffers to
        the device(s) with ASYNC device_puts, then concatenates
        device-side into each device's (rows_per_dev, cols) shard.

        Equivalent result to `from_packed_rows`, but the host never
        materializes the full (d_pad, cols) block: at genome scale the
        first-touch page faults of one fresh multi-GB buffer cost
        minutes on lazily-ballooned VMs, and here they amortize across
        strips that upload while later strips are still being gathered
        — the fault+gather time hides entirely under the transfer.
        Transient device memory is 2x the resident block (strips + the
        concatenated shard), so callers should gate on that.

        `read_strip(lo, hi)` returns SANITIZED packed rows for global
        post-QC rows [lo, hi) (lo/hi never exceed n_rows).  Strips are
        row-padded/column-padded here with inert all-missing bytes.
        """
        mesh = mesh or make_mesh()
        n_dev = mesh.devices.size
        d_pad = _round_up(
            max(n_rows, 1),
            tile_d * n_dev,
        )
        n4_pad = packed_cols(n_samples)
        rows_per_dev = d_pad // n_dev
        flat = list(mesh.devices.flat)

        per_dev = []
        for di, dev in enumerate(flat):
            dev_lo = di * rows_per_dev
            chunks = []
            for lo in range(dev_lo, dev_lo + rows_per_dev, strip_rows):
                hi = min(lo + strip_rows, dev_lo + rows_per_dev)
                buf = np.full(
                    (hi - lo, n4_pad), PACKED_MISSING_BYTE, dtype=np.uint8
                )
                read_hi = min(hi, n_rows)
                if lo < read_hi:
                    rows = read_strip(lo, read_hi)
                    buf[: read_hi - lo, : rows.shape[1]] = rows
                chunks.append(jax.device_put(buf, dev))  # async upload
            per_dev.append(
                chunks[0]
                if len(chunks) == 1
                else jnp.concatenate(chunks, axis=0)
            )

        sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
        geno = jax.make_array_from_single_device_arrays(
            (d_pad, n4_pad), sh, per_dev
        )
        m_pad = np.zeros((d_pad, 1), dtype=np.float32)
        m_pad[:n_rows, 0] = np.asarray(mean, dtype=np.float32)
        inv_pad = np.zeros((d_pad, 1), dtype=np.float32)
        inv_pad[:n_rows, 0] = inv_std_of(np.asarray(std, dtype=np.float32))
        return ShardedMatrix(
            geno=geno,
            mean=jax.device_put(m_pad, sh),
            inv_std=jax.device_put(inv_pad, sh),
            n_rows=n_rows,
            n_samples=n_samples,
            mesh=mesh,
            tile_d=tile_d,
            kernel_precision=kernel_precision,
            q8_polish=q8_polish,
            missing_fraction=missing_fraction,
        )

    # ------------------------------------------------------------------
    def _build_kernels(self) -> None:
        mesh = self.mesh
        vspec = P(VARIANT_AXIS, None)
        rep = P(None, None)
        prec = self.exact_precision
        step = self.step

        # check_vma=False: the products' scan carries start as unvarying
        # zeros, which the varying-manual-axes check rejects.
        smap = functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(vspec, vspec, vspec, rep),
            check_vma=False,
        )

        @functools.partial(smap, out_specs=rep)
        def gram_sm(g, m, iv, b):
            return jax.lax.psum(
                products.gram(g, m, iv, b, precision=prec, step=step),
                VARIANT_AXIS,
            )

        @functools.partial(smap, out_specs=rep)
        def tsq_sm(g, m, iv, b):
            return jax.lax.psum(
                products.tsq(g, m, iv, b, precision=prec, step=step),
                VARIANT_AXIS,
            )

        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(vspec, vspec, vspec, rep, rep, rep),
            out_specs=rep,
            check_vma=False,
        )
        def gram_q8_sm(g, m, iv, bq, sb, csum):
            return jax.lax.psum(
                products.gram_q8(g, iv, m * iv, bq, sb, csum, step=step),
                VARIANT_AXIS,
            )

        @functools.partial(smap, out_specs=vspec)
        def right_sm(g, m, iv, b):
            return products.right(g, m, iv, b, precision=prec, step=step)

        # A^T W with W variant-sharded like the genotypes: the device
        # path for projecting NEW samples through fitted loadings
        # (PCA::transform, main.rs:659-660).
        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(vspec, vspec, vspec, vspec),
            out_specs=rep,
            check_vma=False,
        )
        def left_sm(g, m, iv, w):
            return jax.lax.psum(
                products.left(g, m, iv, w, step=step), VARIANT_AXIS
            )

        n_samples = self.n_samples
        n_pad = self.n_pad

        def pad_b(b):
            n, ell = b.shape
            out = jnp.zeros((n_pad, ell), dtype=jnp.float32)
            return out.at[:n, :].set(b)

        # Fully-jitted wrappers: padding, the sharded pass, and the
        # un-padding slice form ONE executable each.
        @jax.jit
        def gram_k(g, m, iv, b):
            return gram_sm(g, m, iv, pad_b(b))[:n_samples]

        @jax.jit
        def tsq_k(g, m, iv, b):
            return tsq_sm(g, m, iv, pad_b(b))

        @jax.jit
        def right_k(g, m, iv, b):
            return right_sm(g, m, iv, pad_b(b))

        @jax.jit
        def left_k(g, m, iv, w):
            return left_sm(g, m, iv, w)[:n_samples]

        # Two-pass Cholesky-QR between power-iteration steps
        # (ops/rsvd.cholqr2_q — one shared implementation with the fused
        # stage-1 rSVD stabilizer).  Callers needing exact
        # orthonormality run one final Householder QR outside the loop.
        cholqr2 = cholqr2_q

        def zero_pad_rows(t):
            return t.at[n_samples:, :].set(0.0)

        use_q8 = self.kernel_precision == "q8"
        # With q8 enabled the LAST power iteration(s) always run through
        # the exact bf16 products: the quantized passes only steer the
        # subspace (8-bit rounding + the missing->raw-0 approximation,
        # ops/products.py q8 notes); the exact polish passes before
        # the Rayleigh-Ritz restore bf16-path quality (|r| >= 0.99999 vs
        # float64, tests/test_q8.py; count resolved per the observed
        # missingness bound — `resolve_q8_polish`).
        q8_polish = self.q8_polish

        def power_loop(g, m, iv, bp, n_iter, tol=None):
            """Subspace iteration; returns (basis, n_iterations_done).

            `tol` (static) switches the steering loop to a while_loop
            that exits once the relative subspace residual
            ||T - B(B^T T)||_F / ||T||_F of a pass drops below tol —
            the `rfit` tolerance contract
            (/root/reference/src/main.rs:648-656).  Exact polish passes
            (q8 discipline) always run in full.
            """
            def t_exact(cur):
                return zero_pad_rows(gram_sm(g, m, iv, cur))

            def t_q8(cur):
                bq, sb, csum = quantize_basis(cur)
                return zero_pad_rows(gram_q8_sm(g, m, iv, bq, sb, csum))

            def run(tfn, max_n, b0):
                if tol is None:
                    out = jax.lax.fori_loop(
                        0, max_n, lambda _, cur: cholqr2(tfn(cur)), b0
                    )
                    return out, jnp.int32(max_n)

                def cond(c):
                    i, _b, res = c
                    return (i < max_n) & (res >= tol)

                def body(c):
                    i, cur, _res = c
                    t = tfn(cur)
                    # Residual of t against the incoming basis.  On the
                    # first pass `cur` is the raw random sketch (not yet
                    # orthonormal), so the residual is meaningless there
                    # — pin it to inf so the loop can never exit before
                    # one full orthonormalized pass (matches the i > 0
                    # guard of the host and streaming loops).
                    res = jnp.where(
                        i > 0, subspace_residual(cur, t), jnp.float32(jnp.inf)
                    )
                    return i + 1, cholqr2(t), res

                i, out, _ = jax.lax.while_loop(
                    cond, body, (jnp.int32(0), b0, jnp.float32(jnp.inf))
                )
                return out, i

            if not use_q8:
                return run(t_exact, n_iter, bp)
            n_q8 = max(n_iter - q8_polish, 0)
            out, i1 = run(t_q8, n_q8, bp)
            # The mandated exact polish passes ALWAYS run in full — the
            # adaptive polish count is the accuracy guarantee of the q8
            # approximation (resolve_q8_polish), not a convergence
            # heuristic a loose tolerance may skip.  Same semantics as
            # StreamingMatrix.power_iterate.
            n_polish = n_iter - n_q8
            out = jax.lax.fori_loop(
                0, n_polish, lambda _, cur: cholqr2(t_exact(cur)), out
            )
            return out, i1 + n_polish

        # Whole power-iteration loop on device: n_iter x (gram -> CholQR).
        @functools.partial(jax.jit, static_argnames=("n_iter", "tol"))
        def power_k(g, m, iv, b, n_iter, tol=None):
            out, n_done = power_loop(g, m, iv, pad_b(b), n_iter, tol)
            # One exact Householder QR to finish.
            q, _ = jnp.linalg.qr(out)
            return q[:n_samples], n_done

        # The ENTIRE randomized PCA as one XLA program: power iterations,
        # condensed eigensolve, scores, and (variant-sharded) loadings —
        # one compile and one dispatch instead of three.
        @functools.partial(jax.jit, static_argnames=("n_iter", "k", "tol"))
        def pca_core_k(g, m, iv, b, n_iter, k, tol=None):
            out, n_done = power_loop(g, m, iv, pad_b(b), n_iter, tol)
            q, _ = jnp.linalg.qr(out)  # (n_pad, ell) orthonormal
            gram = tsq_sm(g, m, iv, q)  # (ell, ell)
            evals, w = jnp.linalg.eigh(gram)
            order = jnp.argsort(-evals)
            evals = jnp.maximum(evals[order], 0.0)
            w = w[:, order]
            sigma = jnp.sqrt(evals)
            # (n_pad, ell) right singular vectors, HIGHEST: they are the
            # user-visible scores.
            v_full = jnp.dot(q, w, precision=jax.lax.Precision.HIGHEST)
            v_k = v_full[:, :k]
            # loadings U = A V / sigma, variant-sharded output
            c = right_sm(g, m, iv, v_k)  # (d_pad, k) = A V
            inv_sigma = jnp.where(sigma[:k] > 0, 1.0 / jnp.where(
                sigma[:k] > 0, sigma[:k], 1.0), 0.0)
            loadings = c * inv_sigma[None, :]
            return (
                v_k[:n_samples],  # right singular vectors (N, k)
                sigma[:k],
                evals[:k],
                loadings,  # (d_pad, k), caller slices rows
                n_done,
            )

        self._gram_k = gram_k
        self._tsq_k = tsq_k
        self._right_k = right_k
        self._left_k = left_k
        self._power_k = power_k
        self._pca_core_k = pca_core_k

    # ---- segmented row layout helpers ---------------------------------
    def translate_row_runs(
        self, starts: np.ndarray, lens: np.ndarray
    ) -> np.ndarray:
        """PcaSnpId run starts -> matrix-row starts under the segmented
        layout.  Raises if any run crosses a segment boundary (callers
        gate on `runs_device_sliceable` first)."""
        starts = np.asarray(starts, dtype=np.int64)
        if self.row_segments is None:
            return starts
        seg = self.row_segments
        # Segment of each run: last segment with pca_start <= start.
        si = np.searchsorted(seg[:, 1], starts, side="right") - 1
        si = np.clip(si, 0, len(seg) - 1)
        ends = np.asarray(lens, dtype=np.int64) + starts
        inside = (starts >= seg[si, 1]) & (ends <= seg[si, 1] + seg[si, 2])
        # Zero-length padding runs (batch fill) translate to row 0.
        inside |= np.asarray(lens, dtype=np.int64) == 0
        if not bool(inside.all()):
            raise ValueError(
                "block run crosses a row-segment boundary; use the host "
                "accessor path for this block file"
            )
        out = seg[si, 0] + (starts - seg[si, 1])
        return np.where(np.asarray(lens, dtype=np.int64) == 0, 0, out)

    def runs_device_sliceable(self, runs: np.ndarray) -> bool:
        """True when every (start, len) run stays inside one row
        segment, i.e. `fetch_blocks_device` can slice it contiguously."""
        try:
            self.translate_row_runs(runs[:, 0], runs[:, 1])
            return True
        except ValueError:
            return False

    def _trim_rows(self, arr: np.ndarray) -> np.ndarray:
        """(d_pad, ...) host array -> (n_rows, ...) real rows in
        PcaSnpId order (drops inter-segment and tail padding)."""
        if self.row_segments is None:
            return arr[: self.n_rows]
        out = np.empty((self.n_rows,) + arr.shape[1:], dtype=arr.dtype)
        for mstart, pstart, cnt in self.row_segments:
            out[pstart : pstart + cnt] = arr[mstart : mstart + cnt]
        return out

    @property
    def _segments_or_default(self) -> np.ndarray:
        if self.row_segments is None:
            return np.array([[0, 0, self.n_rows]], dtype=np.int64)
        return self.row_segments

    # ---- device-resident block access ---------------------------------
    def fetch_blocks_device(
        self,
        starts: np.ndarray,  # (B,) global row starts (PcaSnpId space)
        lens: np.ndarray,  # (B,) block lengths
        bucket: int,
        col_idx: Optional[jax.Array] = None,
    ) -> jax.Array:
        """(B, bucket, C) f32 standardized blocks sliced from the
        HBM-resident int8 matrix — no host round-trip.

        The device analog of the host accessor's
        `fetch_block_standardized` for blocks that are contiguous
        PcaSnpId runs; rows beyond each block's length are zero.
        `starts` are PcaSnpId positions; the segmented layout translates
        them to matrix rows (`translate_row_runs`).
        """
        bucket = min(bucket, self.d_pad)
        if int(np.max(lens)) > bucket:
            raise ValueError(f"block longer than bucket: {np.max(lens)} > {bucket}")
        slicer = (
            _slice_blocks_standardized_packed
            if self.packed
            else _slice_blocks_standardized
        )
        return slicer(
            self.geno,
            self.mean,
            self.inv_std,
            jnp.asarray(self.translate_row_runs(starts, lens), dtype=jnp.int32),
            jnp.asarray(np.asarray(lens), dtype=jnp.int32),
            col_idx,
            bucket,
        )

    def count_missing(self) -> int:
        """Number of missing genotypes among real rows/columns (one
        scalar download; supports the strict `missing_policy="error"`
        accessor semantics on the device path).

        Runs under `jax.enable_x64`: without it the int64 accumulators
        silently truncate to int32, which overflows at genome scale
        (>2^31 missing entries wraps negative or, worse, to a small
        positive count)."""

        segments = tuple(
            (int(m), int(c)) for m, _p, c in self._segments_or_default
        )

        if self.packed:
            n4 = self.geno.shape[1]
            n_samples = self.n_samples

            def count_packed(g):
                miss = jnp.zeros((), jnp.int64)
                for mstart, cnt in segments:
                    c = g[mstart : mstart + cnt].astype(jnp.int32)
                    for p in range(4):
                        cp = (c >> (2 * p)) & 3
                        # sample index of plane p, byte j is 4j + p
                        sample = 4 * jnp.arange(n4) + p
                        valid_col = (sample < n_samples)[None, :]
                        miss += jnp.sum(
                            (cp == 1) & valid_col, dtype=jnp.int64
                        )
                return miss

            with jax.enable_x64(True):
                return int(np.asarray(jax.jit(count_packed)(self.geno)))

        def count(g):
            miss = jnp.zeros((), jnp.int64)
            for mstart, cnt in segments:
                real = g[mstart : mstart + cnt, : self.n_samples]
                miss += jnp.sum(real == MISSING, dtype=jnp.int64)
            return miss

        with jax.enable_x64(True):
            return int(np.asarray(jax.jit(count)(self.geno)))

    def _rows_to_host(self, arr: jax.Array) -> np.ndarray:
        """Materialize a variant-sharded (d_pad, k) output on every host.

        Single-process arrays are fully addressable; multi-process ones
        span other hosts' devices, so each process concatenates its own
        contiguous row shards (mesh order) and a tiled
        `process_allgather` assembles the global block — the only
        cross-host traffic the output path needs (k columns, not the
        genotype matrix).
        """
        if jax.process_count() == 1:
            return np.asarray(arr)
        from jax.experimental import multihost_utils

        shards = sorted(
            arr.addressable_shards,
            key=lambda s: s.index[0].start or 0,
        )
        local = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
        return np.asarray(multihost_utils.process_allgather(local, tiled=True))

    # ---- public passes (each ONE device dispatch) --------------------
    def gram_apply(self, b: jax.Array) -> jax.Array:
        """A^T (A B): (n_samples, l), replicated."""
        return self._gram_k(self.geno, self.mean, self.inv_std, b)

    def tsq_accumulate(self, b: jax.Array) -> jax.Array:
        """(A B)^T (A B): (l, l), replicated."""
        return self._tsq_k(self.geno, self.mean, self.inv_std, b)

    def right_apply(self, b: jax.Array) -> np.ndarray:
        """A B on host with padding removed: (n_rows, l)."""
        out = self._right_k(self.geno, self.mean, self.inv_std, b)
        return self._trim_rows(self._rows_to_host(out))

    def left_apply(self, w: np.ndarray) -> np.ndarray:
        """A^T W: (n_samples, k) for row-space W (n_rows, k) in PcaSnpId
        order.

        The device projection path (standardize + contraction over the
        variant axis under shard_map, psum-merged): with A built from
        NEW samples and the TRAINING moments, `left_apply(loadings)` is
        `PCA::transform` (/root/reference/src/main.rs:659-660) on
        device.  Padding rows are inert (inv_std = 0)."""
        w = np.asarray(w, dtype=np.float32)
        if w.ndim != 2 or w.shape[0] != self.n_rows:
            raise ValueError(
                f"left_apply expects ({self.n_rows}, k), got {w.shape}"
            )
        k = w.shape[1]
        w_pad = np.zeros((self.d_pad, k), dtype=np.float32)
        for mstart, pstart, cnt in self._segments_or_default:
            w_pad[mstart : mstart + cnt] = w[pstart : pstart + cnt]
        sh = NamedSharding(self.mesh, P(VARIANT_AXIS, None))
        if jax.process_count() == 1:
            w_dev = jax.device_put(w_pad, sh)
        else:
            flat = list(self.mesh.devices.flat)
            rows_per_dev = self.d_pad // len(flat)
            proc = jax.process_index()
            idxs = [
                i for i, d in enumerate(flat) if d.process_index == proc
            ]
            lo = min(idxs) * rows_per_dev
            hi = (max(idxs) + 1) * rows_per_dev
            w_dev = jax.make_array_from_process_local_data(
                sh, w_pad[lo:hi], (self.d_pad, k)
            )
        return np.asarray(
            self._left_k(self.geno, self.mean, self.inv_std, w_dev)
        )

    def power_iterate(
        self, b0: jax.Array, n_iter: int, tolerance: Optional[float] = None
    ) -> jax.Array:
        """n_iter x (B <- qr(A^T A B)) entirely on device: (n_samples, l)
        orthonormal basis.  One dispatch for the whole loop.  With
        `tolerance` the loop early-exits on the subspace residual and
        the return is (basis, n_iterations_done)."""
        q, n_done = self._power_k(
            self.geno, self.mean, self.inv_std, b0, n_iter, tolerance
        )
        if tolerance is None:
            return q
        return q, int(n_done)

    def pca_core(
        self,
        b0: jax.Array,
        n_iter: int,
        k: int,
        tolerance: Optional[float] = None,
    ):
        """Full randomized PCA in ONE program/dispatch.

        Returns (v, sigma, evals, loadings): right singular vectors
        (n_samples, k), singular values (k,), their squares (k,), and
        loadings (n_rows, k) on host.  With `tolerance` the power loop
        early-exits (rfit tolerance contract, main.rs:648-656) and a
        fifth element — the iteration count actually run — is returned.
        """
        v, sigma, evals, loadings, n_done = self._pca_core_k(
            self.geno, self.mean, self.inv_std, b0, n_iter, k, tolerance
        )
        out = (v, sigma, evals, self._trim_rows(self._rows_to_host(loadings)))
        if tolerance is None:
            return out
        return out + (int(n_done),)
