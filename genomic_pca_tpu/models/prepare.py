"""Data preparation pipeline for the EigenSNP workflow.

The `MicroarrayDataPreparer` equivalent
(/root/reference/src/prepare.rs:922-1766): sample QC via keep-list
intersection, chunked SNP QC with exact moments, LD-block mapping, and a
standardized-genotype accessor handing device-resident int8 strips to the
PCA engine.

Differences by design:

* The reference's actor-based IoService (prepare.rs:169-920) exists to
  overlap mmap'd BED reads with SIMD QC threads.  Here the BED decode is
  one vectorized numpy gather per chunk (io/bed.py) and QC is a jitted
  XLA reduction, so the pipeline is a simple chunk loop; overlap of host
  I/O with device compute is provided by io/prefetch.py on the streaming
  paths.
* QC decisions derive from exact integer genotype histograms
  (ops/qc.py), equivalent to the reference's two-pass f64 SIMD
  accumulation.
"""

from __future__ import annotations

import dataclasses
import os
import logging
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from genomic_pca_tpu.config import DataPrepConfig
from genomic_pca_tpu.errors import DataPrepError
from genomic_pca_tpu.io.bed import BedReader
from genomic_pca_tpu.io.ldblocks import LdBlockSpec, map_snps_to_blocks, parse_ld_block_file
from genomic_pca_tpu.ops.qc import genotype_counts, snp_qc_from_counts
from genomic_pca_tpu.ops.stream import MISSING, StripedMatrix

log = logging.getLogger(__name__)


def _memory_limit(dev) -> int:
    """Device memory one JAX process may use on `dev` (bytes).

    Accelerators report it (`memory_stats()["bytes_limit"]`); one that
    does not is an error, not a guess.  The CPU backend has no such
    limit, so its budget is the host's physical memory."""
    stats = dev.memory_stats()
    if stats and int(stats.get("bytes_limit", 0)) > 0:
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise DataPrepError(
        f"Device {dev} ({dev.device_kind}) reports no memory limit; "
        "cannot size the resident matrix."
    )


def _device_memory_budget() -> int:
    """Total device memory across local devices (bytes)."""
    return sum(_memory_limit(dev) for dev in jax.local_devices())


def _default_device_budget() -> int:
    """Memory of the default device (bytes).

    The QC-capture batches and the fused-assembly output land on the
    default device before any resharding, so capture must gate on ONE
    device's memory, not the sum across local devices.
    """
    return _memory_limit(jax.local_devices()[0])


def _packed_cols(n_samples: int) -> int:
    """Device column count of a packed row (lazy import: parallel.sharded
    pulls in the kernel modules, which this module defers until needed)."""
    from genomic_pca_tpu.parallel.sharded import packed_cols

    return packed_cols(n_samples)


def _decode_bounded_rows(n_cohort_samples: int, target_bytes: int = 256 << 20) -> int:
    """Rows per decode chunk so the FULL-cohort-width int8 intermediate
    that BedReader.read materializes (before any column subsetting)
    stays near `target_bytes`."""
    return max(1024, min(262_144, target_bytes // max(n_cohort_samples, 1)))


@dataclasses.dataclass
class QcCapture:
    """Device-resident genotype batches retained by the QC scan.

    Fuses QC with matrix assembly (`DataPrepConfig.fuse_qc_matrix`): the
    batches the scan already uploaded for the histogram reduction stay in
    HBM, and `load_matrix` gathers the QC survivors from them on device —
    removing the second BED pass and the second host->device upload the
    reference's design implies (its accessor re-reads every block from
    the BED after QC, prepare.rs:1861-1872).
    """

    batch_rows: int = 0
    batches: List[jax.Array] = dataclasses.field(default_factory=list)
    # True when batches hold PLINK 2-bit packed bytes (uint8 columns =
    # padded byte axis) instead of int8 dosages — 4x less HBM held.
    packed: bool = False


@dataclasses.dataclass
class PreparedData:
    """QC'd, LD-mapped dataset ready for the EigenSNP core algorithm.

    Index spaces (mirroring PcaSnpId / QcSampleId, prepare.rs:1485, 1858):
      * QcSampleId i  <->  FAM row `qc_sample_indices[i]`
      * PcaSnpId   i  <->  BIM row `pca_snp_orig_indices[i]`
    """

    bed: BedReader
    config: DataPrepConfig
    qc_sample_indices: np.ndarray  # (N,) original FAM indices
    sample_ids: List[str]  # (N,) FAM iids, QcSampleId order
    pca_snp_orig_indices: np.ndarray  # (D,) original BIM indices, sorted
    mean: np.ndarray  # (D,) f32 aligned to PcaSnpId
    std: np.ndarray  # (D,) f32 aligned to PcaSnpId
    blocks: List[LdBlockSpec]
    n_snps_pre_qc: int
    n_snps_post_qc: int
    qc_capture: Optional[QcCapture] = None
    # Distributed-QC scan ranges [(lo, hi)] per process (BIM rows); set
    # when the scan was sharded so the fused assembly can align matrix
    # row segments with scan ownership.
    scan_ranges: Optional[List[tuple]] = None

    @property
    def n_samples(self) -> int:
        return len(self.qc_sample_indices)

    @property
    def n_pca_snps(self) -> int:
        return len(self.pca_snp_orig_indices)

    @property
    def missing_fraction_bound(self) -> float:
        """Deterministic upper bound on the post-QC missing fraction:
        the call-rate gate admits at most 1 - min_call_rate missing
        genotypes per surviving SNP.  Drives the adaptive q8 polish
        count (parallel/sharded.resolve_q8_polish) without an extra
        pass over the data."""
        return max(0.0, 1.0 - float(self.config.min_call_rate))

    def snp_metadata(self):
        """(sids, chroms, positions) aligned to PcaSnpId order
        (main.rs:450-496 equivalent)."""
        idx = self.pca_snp_orig_indices
        return (
            self.bed.bim.sid[idx],
            self.bed.bim.chrom[idx],
            self.bed.bim.bp[idx],
        )

    def _check_missing_policy(self, raw: np.ndarray) -> None:
        if self.config.missing_policy == "error" and (raw == MISSING).any():
            raise DataPrepError(
                "Missing genotype encountered post-QC with "
                "missing_policy='error' (reference accessor semantics, "
                "prepare.rs:1906-1911)."
            )

    def fetch_block_standardized(
        self,
        pca_snp_ids: np.ndarray,
        sample_subset: Optional[np.ndarray] = None,
        pad_rows_to: Optional[int] = None,
    ) -> jax.Array:
        """`get_standardized_snp_sample_block` equivalent
        (prepare.rs:1838-2029): (snps, samples) f32 host array.

        `pad_rows_to` zero-pads the SNP dimension (inert rows: missing
        genotypes with inv_std 0) so ragged LD blocks share a small set
        of compiled shapes instead of one XLA program per block size.
        """
        pca_snp_ids = np.asarray(pca_snp_ids, dtype=np.int64)
        orig = self.pca_snp_orig_indices[pca_snp_ids]
        samp = (
            self.qc_sample_indices
            if sample_subset is None
            else self.qc_sample_indices[np.asarray(sample_subset)]
        )
        raw = self.bed.read(orig, samp)
        self._check_missing_policy(raw)
        mean = self.mean[pca_snp_ids]
        std = self.std[pca_snp_ids]
        if pad_rows_to is not None and raw.shape[0] < pad_rows_to:
            pad = pad_rows_to - raw.shape[0]
            raw = np.pad(raw, ((0, pad), (0, 0)), constant_values=MISSING)
            mean = np.pad(mean, (0, pad))
            std = np.pad(std, (0, pad))

        # Host-side standardize: per-block work is tiny, and doing it in
        # numpy avoids one device dispatch per block (thousands of
        # blocks genome-wide).
        # The heavyweight standardize stays fused on-device in the
        # streamed engines.
        from genomic_pca_tpu.parallel.sharded import inv_std_of

        inv = inv_std_of(std)
        x = raw.astype(np.float32) * inv[:, None].astype(np.float32) + (
            -mean * inv
        )[:, None].astype(np.float32)
        return np.where(raw != MISSING, x, np.float32(0.0))

    @property
    def supports_packed_blocks(self) -> bool:
        """True when blocks can be fetched as raw PLINK bytes (full
        sample set; packed bytes cannot express column subsets)."""
        return bool(self.config.packed_pipeline) and len(
            self.qc_sample_indices
        ) == self.bed.n_samples

    def fetch_block_packed(
        self, pca_snp_ids: np.ndarray, pad_rows_to: Optional[int] = None
    ):
        """Raw 2-bit block fetch: (packed uint8 (R, n4_pad), mean f32 (R,),
        inv_std f32 (R,)) for the requested PcaSnpIds, ALL samples.

        The packed-byte analog of `fetch_block_standardized` for the
        EigenSNP stage engine: 16x less host->device traffic than the
        standardized-f32 block (bytes upload verbatim; dequant +
        standardize run on the VPU).  Row padding is all-missing bytes
        with inv_std 0 (inert); byte columns pad to the 128-lane device
        width.
        """
        from genomic_pca_tpu.parallel.sharded import (
            PACKED_MISSING_BYTE, inv_std_of, sanitize_partial_byte,
        )

        pca_snp_ids = np.asarray(pca_snp_ids, dtype=np.int64)
        orig = self.pca_snp_orig_indices[pca_snp_ids]
        raw = sanitize_partial_byte(
            self.bed.read_packed(orig), self.n_samples
        )
        if self.config.missing_policy == "error":
            from genomic_pca_tpu.ops.qc import genotype_counts_packed_host

            counts = genotype_counts_packed_host(raw, self.n_samples)
            if (counts[:, 3] < self.n_samples).any():
                raise DataPrepError(
                    "Missing genotype encountered post-QC with "
                    "missing_policy='error' (reference accessor "
                    "semantics, prepare.rs:1906-1911)."
                )
        mean = self.mean[pca_snp_ids].astype(np.float32)
        inv = inv_std_of(self.std[pca_snp_ids]).astype(np.float32)
        n4_pad = _packed_cols(self.n_samples)
        rows = pad_rows_to if pad_rows_to is not None else raw.shape[0]
        out = np.full((rows, n4_pad), PACKED_MISSING_BYTE, dtype=np.uint8)
        out[: raw.shape[0], : raw.shape[1]] = raw
        if raw.shape[0] < rows:
            mean = np.pad(mean, (0, rows - raw.shape[0]))
            inv = np.pad(inv, (0, rows - raw.shape[0]))
        return out, mean, inv

    def _strip_gen(self, strip_size: int):
        def gen():
            for start in range(0, self.n_pca_snps, strip_size):
                end = min(start + strip_size, self.n_pca_snps)
                orig = self.pca_snp_orig_indices[start:end]
                raw = self.bed.read(orig, self.qc_sample_indices)
                self._check_missing_policy(raw)
                yield raw

        means = [
            self.mean[s : min(s + strip_size, self.n_pca_snps)]
            for s in range(0, self.n_pca_snps, strip_size)
        ]
        stds = [
            self.std[s : min(s + strip_size, self.n_pca_snps)]
            for s in range(0, self.n_pca_snps, strip_size)
        ]
        return gen(), means, stds

    def load_striped_matrix(
        self, strip_size: int = 2048, device=None
    ) -> StripedMatrix:
        """Materialize the full standardized operator A (D x N) as
        device-resident int8 strips (simple single-device container)."""
        gen, means, stds = self._strip_gen(strip_size)
        return StripedMatrix.from_arrays(
            gen, means=means, stds=stds, strip_size=strip_size, device=device
        )

    def load_streaming_matrix(self, strip_size: int = 2048, **kw):
        """Host-streamed operator for datasets exceeding device HBM:
        strips decode from the BED per pass through the prefetch
        pipeline (io/prefetch.py).

        With `packed_pipeline` (the default) strips stream as PLINK
        2-bit bytes — 4x less traffic per pass over the host->device
        link, which is this container's bottleneck by construction.
        Full sample set: raw BED bytes verbatim (zero decode cost);
        keep-list: decode the kept columns and re-pack on the host.
        """
        from genomic_pca_tpu.ops.streaming import StreamingMatrix

        kw.setdefault("missing_fraction", self.missing_fraction_bound)
        n_strips = max(1, -(-self.n_pca_snps // strip_size))
        n = self.n_pca_snps

        def _pad_rows(raw, m, s, count, fill=0):
            if count < strip_size:  # pad rows, inert (std=0)
                pad = strip_size - count
                raw = np.pad(raw, ((0, pad), (0, 0)), constant_values=fill)
                m = np.pad(m, (0, pad))
                s = np.pad(s, (0, pad))
            return raw, m, s

        if self.config.packed_pipeline and n > 0:
            from genomic_pca_tpu.parallel.sharded import (
                PACKED_MISSING_BYTE, pack_int8_rows, sanitize_partial_byte,
            )

            idx = self.pca_snp_orig_indices
            if len(self.qc_sample_indices) == self.bed.n_samples:
                check_missing = self.config.missing_policy == "error"

                def source(i: int):
                    start = i * strip_size
                    end = min(start + strip_size, n)
                    raw = sanitize_partial_byte(
                        self.bed.read_packed(idx[start:end]), self.n_samples
                    )
                    if check_missing:
                        from genomic_pca_tpu.ops.qc import (
                            genotype_counts_packed_host,
                        )

                        counts = genotype_counts_packed_host(
                            raw, self.n_samples
                        )
                        if (counts[:, 3] < self.n_samples).any():
                            raise DataPrepError(
                                "Missing genotype encountered post-QC "
                                "with missing_policy='error' (reference "
                                "accessor semantics, "
                                "prepare.rs:1906-1911)."
                            )
                    return _pad_rows(
                        raw, self.mean[start:end], self.std[start:end],
                        end - start, fill=PACKED_MISSING_BYTE,
                    )

            else:
                sel = self.qc_sample_indices
                decode_step = _decode_bounded_rows(self.bed.n_samples)

                def source(i: int):
                    start = i * strip_size
                    end = min(start + strip_size, n)
                    parts = []
                    for s0 in range(start, end, decode_step):
                        e0 = min(s0 + decode_step, end)
                        dec = self.bed.read(idx[s0:e0], sel)
                        self._check_missing_policy(dec)
                        parts.append(pack_int8_rows(dec))
                    raw = parts[0] if len(parts) == 1 else np.concatenate(parts)
                    return _pad_rows(
                        raw, self.mean[start:end], self.std[start:end],
                        end - start, fill=PACKED_MISSING_BYTE,
                    )

            return StreamingMatrix(
                source,
                n_strips=n_strips,
                n_rows=n,
                n_samples=self.n_samples,
                strip_size=strip_size,
                packed=True,
                **kw,
            )

        def source(i: int):
            start = i * strip_size
            end = min(start + strip_size, n)
            orig = self.pca_snp_orig_indices[start:end]
            raw = self.bed.read(orig, self.qc_sample_indices)
            self._check_missing_policy(raw)
            return _pad_rows(
                raw, self.mean[start:end], self.std[start:end], end - start
            )

        return StreamingMatrix(
            source,
            n_strips=n_strips,
            n_rows=n,
            n_samples=self.n_samples,
            strip_size=strip_size,
            **kw,
        )

    def _matrix_from_capture(self, mesh, mk=None):
        """Assemble the sharded matrix from the QC scan's device batches.

        One jitted program gathers the PCA SNP rows (static per-batch
        index constants) and pads rows/columns with the missing sentinel;
        no BED re-read, no second upload.  The result is bit-identical to
        `ShardedMatrix.from_arrays` over `_strip_gen` (same rows, same
        inert padding, same moments).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        from genomic_pca_tpu.parallel.mesh import VARIANT_AXIS, make_mesh
        from genomic_pca_tpu.parallel.sharded import (
            PACKED_MISSING_BYTE, ShardedMatrix, inv_std_of,
        )

        mesh = mesh or make_mesh()
        n_dev = mesh.devices.size
        tile_d = 1024
        d = self.n_pca_snps
        cap = self.qc_capture
        packed = cap.packed
        # Same granule as ShardedMatrix's own constructors, so the
        # capture-fusion container is layout-identical to the re-read
        # path (bit-identity tests compare raw geno arrays).
        gran = tile_d * n_dev
        d_pad = -(-max(d, 1) // gran) * gran
        n_pad = -(-self.n_samples // 128) * 128
        pad_value = PACKED_MISSING_BYTE if packed else MISSING
        batch_of = self.pca_snp_orig_indices // cap.batch_rows
        within = (self.pca_snp_orig_indices % cap.batch_rows).astype(np.int32)
        sels = [within[batch_of == b] for b in range(len(cap.batches))]

        @jax.jit
        def assemble(*gs):
            rows = [
                jnp.take(g, jnp.asarray(sel), axis=0)
                for g, sel in zip(gs, sels)
                if sel.size
            ]
            x = rows[0] if len(rows) == 1 else jnp.concatenate(rows, axis=0)
            # Packed batches were already column-padded by the QC scan;
            # only the row axis needs padding here.
            return jnp.pad(
                x,
                ((0, d_pad - d), (0, 0 if packed else n_pad - x.shape[1])),
                constant_values=pad_value,
            )

        sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
        geno = jax.device_put(assemble(*cap.batches), sh)
        self.qc_capture = None  # release the pre-QC batches

        mean = np.zeros((d_pad, 1), dtype=np.float32)
        mean[:d, 0] = self.mean
        inv = np.zeros((d_pad, 1), dtype=np.float32)
        inv[:d, 0] = inv_std_of(self.std)
        sm = ShardedMatrix(
            geno=geno,
            mean=jax.device_put(jnp.asarray(mean), sh),
            inv_std=jax.device_put(jnp.asarray(inv), sh),
            n_rows=d,
            n_samples=self.n_samples,
            mesh=mesh,
            tile_d=tile_d,
            **(mk or {}),
        )

        if self.config.missing_policy == "error" and sm.count_missing():
            # The re-read path host-checks every strip (_strip_gen); the
            # fused path must enforce the same contract here, not rely
            # on a downstream consumer doing it.
            raise DataPrepError(
                "Missing genotypes present post-QC with "
                "missing_policy='error' (reference accessor semantics, "
                "prepare.rs:1906-1911)."
            )
        return sm

    def _matrix_from_capture_multiproc(self, mesh, mk=None):
        """Multi-process fused assembly from the distributed QC scan.

        Each process gathers its OWN scan range's QC survivors from the
        device batches it already uploaded — genotypes never cross
        processes; only the (tiny) keep-masks/moments did, in the QC
        allgather.  The global matrix uses a SEGMENTED row layout: the
        survivors of process p occupy rows [p*rows_pp, p*rows_pp +
        count_p) with inert padding (inv_std 0) up to the uniform
        per-process segment size, and `ShardedMatrix.row_segments` maps
        segments back to PcaSnpId order for loadings/missing-count.
        Scan ranges were LD-block aligned (block_aligned_ranges), so
        every LD block stays inside one segment and device block
        slicing works unchanged.

        Returns None when the mesh is not in the canonical layout
        (equal contiguous device runs in process order) — the caller
        falls back to the re-read path.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        from genomic_pca_tpu.parallel.mesh import VARIANT_AXIS, make_mesh
        from genomic_pca_tpu.parallel.sharded import (
            PACKED_MISSING_BYTE, ShardedMatrix, inv_std_of, packed_cols,
        )

        mesh = mesh or make_mesh()
        n_proc = jax.process_count()
        proc = jax.process_index()
        flat = list(mesh.devices.flat)
        n_dev = len(flat)
        devs_pp = n_dev // n_proc
        local_dev_idx = [
            i for i, d in enumerate(flat) if d.process_index == proc
        ]
        # Canonical layout check must be GLOBAL (every process validates
        # every run) so all processes take the same branch — the
        # assembly below is collective.
        canonical = n_dev == devs_pp * n_proc and all(
            [i for i, d in enumerate(flat) if d.process_index == q]
            == list(range(q * devs_pp, (q + 1) * devs_pp))
            for q in range(n_proc)
        )
        if not canonical or self.scan_ranges is None:
            return None

        ranges = self.scan_ranges
        pca = self.pca_snp_orig_indices
        bounds = np.searchsorted(
            pca, [lo for lo, _hi in ranges] + [ranges[-1][1]]
        )
        counts = np.diff(bounds)  # per-process survivor counts

        cap = self.qc_capture
        packed = cap.packed
        tile_d = 1024
        gran = tile_d * devs_pp
        rows_pp = max(gran, -(-int(counts.max()) // gran) * gran)
        d_pad = rows_pp * n_proc
        pad_value = PACKED_MISSING_BYTE if packed else MISSING
        n_qc = self.n_samples
        if packed:
            cols = packed_cols(n_qc)
        else:
            cols = -(-n_qc // 128) * 128

        lo, _hi = ranges[proc]
        mine = pca[bounds[proc] : bounds[proc + 1]] - lo
        batch_of = mine // max(cap.batch_rows, 1)
        within = (mine % max(cap.batch_rows, 1)).astype(np.int32)
        sels = [within[batch_of == b] for b in range(len(cap.batches))]

        @jax.jit
        def assemble(*gs):
            parts = [
                jnp.take(g, jnp.asarray(sel), axis=0)
                for g, sel in zip(gs, sels)
                if sel.size
            ]
            if parts:
                x = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
                return jnp.pad(
                    x,
                    (
                        (0, rows_pp - x.shape[0]),
                        # Packed batches were column-padded by the scan.
                        (0, 0 if packed else cols - x.shape[1]),
                    ),
                    constant_values=pad_value,
                )
            return jnp.full(
                (rows_pp, cols),
                pad_value,
                dtype=jnp.uint8 if packed else jnp.int8,
            )

        seg_local = assemble(*cap.batches)  # (rows_pp, cols), default dev
        self.qc_capture = None  # release the pre-QC batches

        # Distribute the local segment over this process's devices and
        # stitch the global sharded array from per-device pieces.
        per_dev = rows_pp // devs_pp
        sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
        pieces = [
            jax.device_put(
                seg_local[j * per_dev : (j + 1) * per_dev], flat[di]
            )
            for j, di in enumerate(local_dev_idx)
        ]
        geno = jax.make_array_from_single_device_arrays(
            (d_pad, int(seg_local.shape[1])), sh, pieces
        )

        d = len(pca)
        mean_seg = np.zeros((d_pad, 1), dtype=np.float32)
        inv_seg = np.zeros((d_pad, 1), dtype=np.float32)
        inv_all = inv_std_of(self.std)
        for p in range(n_proc):
            c0, c1 = int(bounds[p]), int(bounds[p + 1])
            mean_seg[p * rows_pp : p * rows_pp + (c1 - c0), 0] = self.mean[c0:c1]
            inv_seg[p * rows_pp : p * rows_pp + (c1 - c0), 0] = inv_all[c0:c1]
        mean_g = jax.make_array_from_process_local_data(
            sh, mean_seg[proc * rows_pp : (proc + 1) * rows_pp], (d_pad, 1)
        )
        inv_g = jax.make_array_from_process_local_data(
            sh, inv_seg[proc * rows_pp : (proc + 1) * rows_pp], (d_pad, 1)
        )

        segments = np.stack(
            [
                np.arange(n_proc, dtype=np.int64) * rows_pp,
                bounds[:-1].astype(np.int64),
                counts.astype(np.int64),
            ],
            axis=1,
        )
        log.info(
            "Multi-process fused assembly: %d survivors in %d segments "
            "of %d rows (no BED re-read / re-upload).",
            d, n_proc, rows_pp,
        )
        sm = ShardedMatrix(
            geno=geno,
            mean=mean_g,
            inv_std=inv_g,
            n_rows=d,
            n_samples=self.n_samples,
            mesh=mesh,
            tile_d=tile_d,
            row_segments=segments,
            **(mk or {}),
        )
        if self.config.missing_policy == "error" and sm.count_missing():
            raise DataPrepError(
                "Missing genotypes present post-QC with "
                "missing_policy='error' (reference accessor semantics, "
                "prepare.rs:1906-1911)."
            )
        return sm

    def estimate_resident_bytes(self) -> int:
        """Device bytes of the resident genotype container (also the
        per-pass upload of the streamed container, which re-uploads the
        same strips every pass): 2-bit packed when the packed pipeline
        will keep raw BED bytes, else 128-padded int8."""
        if self.config.packed_pipeline and (
            self.qc_capture is None or self.qc_capture.packed
        ):  # 2-bit resident: 4x the capacity of int8
            return self.n_pca_snps * _packed_cols(self.n_samples)
        n_pad = -(-self.n_samples // 128) * 128
        return self.n_pca_snps * n_pad

    def will_stream(self, force_streaming: bool = False) -> bool:
        """Whether load_matrix will fall back to the host-streamed
        container — THE streaming rule (load_matrix calls this; keep
        the threshold in one place)."""
        if force_streaming:
            return True
        return (
            jax.process_count() == 1
            and self.estimate_resident_bytes()
            > 0.6 * _device_memory_budget()
        )

    def load_matrix(
        self,
        strip_size: int = 2048,
        mesh=None,
        q8_polish: Optional[int] = None,
        kernel_precision: Optional[str] = None,
    ):
        """Materialize A as the production variant-sharded container
        (XLA strip products under shard_map, psum across the mesh).

        Falls back to the host-streamed container automatically when the
        resident int8 block would not fit in device memory.  Multi-host:
        each process decodes only the BED rows its devices own
        (`ShardedMatrix.from_local_rows`); single-host it is a plain
        sharded pack.
        """
        import jax

        from genomic_pca_tpu.parallel.sharded import ShardedMatrix

        # Container knobs shared by every construction path below: the
        # QC-derived missingness bound drives the adaptive q8 polish;
        # explicit q8_polish / kernel_precision override the defaults.
        mk = dict(missing_fraction=self.missing_fraction_bound)
        if q8_polish is not None:
            mk["q8_polish"] = q8_polish
        if kernel_precision is not None:
            mk["kernel_precision"] = kernel_precision

        # Packed residency applies with OR without a keep-list: raw BED
        # bytes upload verbatim for the full sample set, and keep-list
        # survivors repack to 2-bit on the host.  The int8 estimate only
        # applies when the capture fusion will assemble int8 batches.
        packed_ok = (
            self.config.packed_pipeline
            and len(self.qc_sample_indices) == self.bed.n_samples
        )
        resident_bytes = self.estimate_resident_bytes()
        budget = _device_memory_budget()
        if self.will_stream():
            log.warning(
                "Genotype block (%.1f GB) exceeds 60%% of device memory "
                "(%.1f GB); using the host-streamed matrix.",
                resident_bytes / 1e9,
                budget / 1e9,
            )
            # Don't hold the (pre-QC, >= resident-size) capture batches
            # in HBM while every pass streams from host.
            self.qc_capture = None
            return self.load_streaming_matrix(strip_size=strip_size, **mk)

        if jax.process_count() > 1:
            if self.qc_capture is not None and self.n_pca_snps > 0:
                sm = self._matrix_from_capture_multiproc(mesh, mk)
                if sm is not None:
                    return sm
            self.qc_capture = None  # non-canonical mesh: release batches

            if self.config.packed_pipeline:
                # Each process uploads only its own survivors as 2-bit
                # bytes — 4x less per-host transfer than int8.  Full
                # sample set: raw BED bytes verbatim; keep-list: decode
                # the kept columns and re-pack on the host.
                from genomic_pca_tpu.parallel.sharded import pack_int8_rows

                decode_step = _decode_bounded_rows(self.bed.n_samples)

                def read_packed_rows(lo: int, hi: int):
                    orig = self.pca_snp_orig_indices[lo:hi]
                    if packed_ok:
                        # from_local_rows(packed=True) sanitizes.
                        raw = self.bed.read_packed(orig)
                    else:
                        # Chunk the full-cohort-width decode; repack.
                        parts = []
                        for s in range(0, len(orig), decode_step):
                            dec = self.bed.read(
                                orig[s : s + decode_step],
                                self.qc_sample_indices,
                            )
                            self._check_missing_policy(dec)
                            parts.append(pack_int8_rows(dec))
                        raw = (
                            parts[0]
                            if len(parts) == 1
                            else np.concatenate(parts)
                        )
                    return raw, self.mean[lo:hi], self.std[lo:hi]

                sm = ShardedMatrix.from_local_rows(
                    read_packed_rows,
                    n_rows=self.n_pca_snps,
                    n_samples=self.n_samples,
                    mesh=mesh,
                    packed=True,
                    **mk,
                )
                if (
                    self.config.missing_policy == "error"
                    and sm.count_missing()
                ):
                    raise DataPrepError(
                        "Missing genotypes present post-QC with "
                        "missing_policy='error' (reference accessor "
                        "semantics, prepare.rs:1906-1911)."
                    )
                return sm

            def read_rows(lo: int, hi: int):
                orig = self.pca_snp_orig_indices[lo:hi]
                raw = self.bed.read(orig, self.qc_sample_indices)
                self._check_missing_policy(raw)
                return raw, self.mean[lo:hi], self.std[lo:hi]

            return ShardedMatrix.from_local_rows(
                read_rows,
                n_rows=self.n_pca_snps,
                n_samples=self.n_samples,
                mesh=mesh,
                **mk,
            )

        if self.qc_capture is not None and self.n_pca_snps > 0:
            log.info(
                "Matrix assembly from QC-scan device batches "
                "(fused path: no BED re-read / re-upload)."
            )
            return self._matrix_from_capture(mesh, mk)

        if (
            self.config.packed_pipeline
            and len(self.qc_sample_indices) == self.bed.n_samples
            and self.n_pca_snps > 0
        ):
            # 2-bit resident path without capture: raw BED bytes for the
            # PCA rows upload verbatim, strip-streamed so the host never
            # materializes the full block and the gather/page-fault time
            # hides under the transfer.  Strip streaming transiently
            # doubles device memory (strips + concatenated shards), so
            # fall back to the one-shot buffer when that would not fit.
            from genomic_pca_tpu.parallel.sharded import (
                sanitize_partial_byte,
            )

            idx = self.pca_snp_orig_indices

            def read_strip(lo: int, hi: int) -> np.ndarray:
                return sanitize_partial_byte(
                    self.bed.read_packed(idx[lo:hi]), self.n_samples
                )

            if 2 * resident_bytes <= 0.85 * budget:
                sm = ShardedMatrix.from_packed_strips(
                    read_strip,
                    n_rows=self.n_pca_snps,
                    mean=self.mean,
                    std=self.std,
                    n_samples=self.n_samples,
                    mesh=mesh,
                    **mk,
                )
            else:
                sm = ShardedMatrix.from_packed_rows(
                    self.bed.read_packed(idx),
                    self.mean, self.std, self.n_samples, mesh=mesh, **mk,
                )
            if self.config.missing_policy == "error" and sm.count_missing():
                raise DataPrepError(
                    "Missing genotypes present post-QC with "
                    "missing_policy='error' (reference accessor "
                    "semantics, prepare.rs:1906-1911)."
                )
            return sm

        if self.config.packed_pipeline and self.n_pca_snps > 0:
            # Keep-list repack: decode the kept columns per strip and
            # re-pack to 2-bit on the host — the device pipeline stays
            # packed (4x less upload and HBM) even under sample
            # subsetting, which raw BED bytes cannot express.
            from genomic_pca_tpu.parallel.sharded import pack_int8_rows

            idx = self.pca_snp_orig_indices
            sel = self.qc_sample_indices
            # bed.read decodes the FULL cohort width before column
            # subsetting, so bound strips by decoded bytes (the device
            # budget gate says nothing about this host intermediate).
            decode_step = _decode_bounded_rows(self.bed.n_samples)

            def read_strip_repack(lo: int, hi: int) -> np.ndarray:
                parts = []
                for s in range(lo, hi, decode_step):
                    e = min(s + decode_step, hi)
                    raw = self.bed.read(idx[s:e], sel)
                    self._check_missing_policy(raw)
                    parts.append(pack_int8_rows(raw))
                return parts[0] if len(parts) == 1 else np.concatenate(parts)

            if 2 * resident_bytes <= 0.85 * budget:
                return ShardedMatrix.from_packed_strips(
                    read_strip_repack,
                    n_rows=self.n_pca_snps,
                    mean=self.mean,
                    std=self.std,
                    n_samples=self.n_samples,
                    mesh=mesh,
                    **mk,
                )
            packed_all = np.empty(
                (self.n_pca_snps, -(-self.n_samples // 4)), dtype=np.uint8
            )
            step = max(strip_size, 8192)
            for lo in range(0, self.n_pca_snps, step):
                hi = min(lo + step, self.n_pca_snps)
                packed_all[lo:hi] = read_strip_repack(lo, hi)
            return ShardedMatrix.from_packed_rows(
                packed_all, self.mean, self.std, self.n_samples, mesh=mesh,
                **mk,
            )

        gen, means, stds = self._strip_gen(strip_size)
        return ShardedMatrix.from_arrays(
            gen, means=means, stds=stds, mesh=mesh, **mk
        )


def perform_sample_qc(
    bed: BedReader, keep_path: Optional[str]
) -> np.ndarray:
    """Keep-list intersection preserving FAM order (prepare.rs:1058-1096)."""
    n = bed.n_samples
    if keep_path is None:
        log.info("No sample keep-list provided; using all %d samples.", n)
        return np.arange(n, dtype=np.int64)
    with open(keep_path, "r") as fh:
        keep = {line.rstrip("\n").rstrip("\r") for line in fh}
    idx = np.array(
        [i for i, iid in enumerate(bed.fam.iid) if iid in keep], dtype=np.int64
    )
    log.info("Sample QC: %d / %d samples selected.", len(idx), n)
    return idx


def _qc_snp_range(
    bed: BedReader,
    config: DataPrepConfig,
    sample_sel: Optional[np.ndarray],
    n_qc: int,
    lo: int,
    hi: int,
    capture: Optional[QcCapture] = None,
    packed: bool = False,
):
    """Chunked SNP QC + moments over global BIM rows [lo, hi).

    Returns (keep bool, mean f64, std f64) arrays of length hi - lo.
    IO granularity follows the reference's SNP_IO_CHUNK_SIZE; device
    dispatches gather multiple IO chunks into `qc_device_batch`-row
    batches (the integer-histogram QC is exact, so batching cannot
    change decisions — it only amortizes per-dispatch latency).

    With `capture`, each batch's device upload is retained in
    `capture.batches` for fused matrix assembly (see QcCapture).

    `packed=True` (requires sample_sel None) streams raw PLINK 2-bit
    bytes: no host decode, 4x less upload, histograms on packed codes —
    decisions are bit-identical either way.
    """
    chunk = config.snp_chunk_size
    batch_rows = max(chunk, config.qc_device_batch)
    batch_rows = -(-batch_rows // chunk) * chunk
    if packed:
        assert sample_sel is None, "packed QC requires the full sample set"
        from genomic_pca_tpu.parallel.sharded import (
            PACKED_MISSING_BYTE, packed_cols, sanitize_partial_byte,
        )

        from genomic_pca_tpu.ops.qc import genotype_counts_packed

        n4_pad = packed_cols(n_qc)
    if capture is not None:
        capture.batch_rows = batch_rows
        capture.packed = packed
    keep_chunks: List[np.ndarray] = []
    mean_chunks: List[np.ndarray] = []
    std_chunks: List[np.ndarray] = []
    n_batches = max(1, -(-(hi - lo) // batch_rows))

    # Fully-async scan: every batch's upload + histogram reduction is
    # enqueued without ANY device->host fetch (a fetch per batch
    # serializes the host loop behind the device).  Counts stay on device and come
    # back in ONE concatenated fetch after the loop; QC filtering is
    # then a pure-numpy pass.  Without capture, a sparse fence (one tiny
    # fetch every 4 batches) bounds in-flight batch memory.
    counts_dev: List[jax.Array] = []
    batch_sizes: List[int] = []

    for bi, bstart in enumerate(range(lo, hi, batch_rows)):
        bend = min(bstart + batch_rows, hi)
        rows: List[np.ndarray] = []
        for start in range(bstart, bend, chunk):
            end = min(start + chunk, bend)
            try:
                if packed:
                    rows.append(bed.read_packed(slice(start, end)))
                else:
                    rows.append(bed.read(slice(start, end), sample_sel))
            except (OSError, ValueError) as e:
                # QC-path chunk failures are logged and skipped — the
                # chunk's SNPs are excluded, mirroring prepare.rs:1380-1398
                # (accessor-path read failures later remain fatal).
                log.warning(
                    "SNP QC chunk %d-%d failed (%s); excluding its SNPs.",
                    start, end, e,
                )
                if packed:
                    rows.append(np.full(
                        (end - start, bed._bytes_per_snp),
                        PACKED_MISSING_BYTE, dtype=np.uint8,
                    ))
                else:
                    rows.append(
                        np.full((end - start, n_qc), MISSING, dtype=np.int8)
                    )
        raw = np.concatenate(rows, axis=0)
        if packed:
            raw = sanitize_partial_byte(raw, n_qc)
            # Pad rows (program-shape reuse) and byte columns (128-lane
            # granularity) with all-missing bytes.
            raw2 = np.full(
                (batch_rows, n4_pad), PACKED_MISSING_BYTE, dtype=np.uint8
            )
            raw2[: raw.shape[0], : raw.shape[1]] = raw
            raw = raw2
        elif raw.shape[0] < batch_rows:
            # Pad the tail batch with all-missing rows (dropped by QC) so
            # the whole pass reuses ONE compiled program shape.
            raw = np.pad(
                raw, ((0, batch_rows - raw.shape[0]), (0, 0)),
                constant_values=MISSING,
            )
        g_dev = jnp.asarray(raw)  # ONE upload per batch (async)
        if packed:
            counts = genotype_counts_packed(g_dev, n_qc)
        else:
            counts = genotype_counts(g_dev)
        counts_dev.append(jnp.stack(counts))  # (4, batch_rows) int32
        batch_sizes.append(bend - bstart)
        if capture is not None:
            capture.batches.append(g_dev)
        elif bi % 4 == 3:
            # Backpressure: batches are not retained, so bound how many
            # uploads can be in flight at once.
            np.asarray(counts_dev[bi - 3][0, :1])
        # Live progress: counts are fetched only after the loop, so the
        # decode/upload position is the real-time signal (a hung scan is
        # otherwise indistinguishable from a slow one).
        if (bi + 1) % max(1, n_batches // 20) == 0 or bi + 1 == n_batches:
            log.info(
                "SNP QC scan: batch %d/%d (%.0f%%) decoded and dispatched.",
                bi + 1, n_batches, 100.0 * (bi + 1) / n_batches,
            )

    if counts_dev:
        all_counts = np.asarray(jnp.concatenate(counts_dev, axis=1))
        pos = 0
        for bi, n_rows_b in enumerate(batch_sizes):
            c = all_counts[:, pos : pos + n_rows_b]
            pos += batch_rows
            qc = snp_qc_from_counts(c[0], c[1], c[2], c[3], n_qc, config)
            keep_chunks.append(qc.keep)
            mean_chunks.append(qc.mean)
            std_chunks.append(qc.std)
            log.debug(
                "SNP QC filter: batch %d/%d kept %d",
                bi + 1, n_batches, int(qc.keep.sum()),
            )
    if not keep_chunks:
        return (
            np.zeros(0, dtype=bool),
            np.zeros(0, dtype=np.float64),
            np.zeros(0, dtype=np.float64),
        )
    return (
        np.concatenate(keep_chunks),
        np.concatenate(mean_chunks),
        np.concatenate(std_chunks),
    )


def _qc_snp_range_hostscan(
    bed: BedReader,
    config: DataPrepConfig,
    n_qc: int,
    lo: int,
    hi: int,
    sample_sel: Optional[np.ndarray] = None,
):
    """Host-side SNP-QC scan over BIM rows [lo, hi).

    Full sample set: counts the 2-bit genotype codes straight off the
    mmap'd BED bytes (native SWAR popcounts via plinkio_packed_qc_counts,
    numpy LUT fallback) — no device upload, no decode.  With a sample
    keep-list (`sample_sel`): decodes each chunk (native threaded) and
    counts the int8 dosages of the kept columns.  The integer counts
    are identical to the device reduction's either way, so keep/mean/std
    are bit-identical to the device scan; the post-QC matrix then
    uploads exactly once in load_matrix (the minimum possible link
    traffic).
    """
    from genomic_pca_tpu.io.native import packed_qc_counts_native
    from genomic_pca_tpu.ops.qc import (
        genotype_counts_int8_host, genotype_counts_packed_host,
    )

    # Filtering runs PER CHUNK (like the device path runs per batch):
    # one whole-range pass would allocate ~15 fresh 80 MB temporaries at
    # 10M rows, and large numpy temporaries are mmap'd/munmap'd per op —
    # on slow-page-fault hosts the fault cost dwarfed the arithmetic
    # (measured 57-143 s vs 17 s with reused buffers).  Chunk-sized
    # temporaries get recycled by the allocator across iterations.
    # Subset scans decode int8 at FULL cohort width (bed.read subsets
    # columns only after decoding), so bound the chunk by those bytes.
    chunk_rows = 262_144
    if sample_sel is not None:
        chunk_rows = _decode_bounded_rows(bed.n_samples)
    n_chunks = max(1, -(-(hi - lo) // chunk_rows))
    keeps: List[np.ndarray] = []
    means: List[np.ndarray] = []
    stds: List[np.ndarray] = []
    for ci, start in enumerate(range(lo, hi, chunk_rows)):
        end = min(start + chunk_rows, hi)
        try:
            if sample_sel is not None:
                counts = genotype_counts_int8_host(
                    bed.read(slice(start, end), sample_sel)
                )
            else:
                offs = (
                    3 + np.arange(start, end, dtype=np.int64) * bed._bytes_per_snp
                )
                counts = packed_qc_counts_native(
                    bed._mmap, offs, bed.n_samples
                )
                if counts is None:
                    counts = genotype_counts_packed_host(
                        bed.read_packed(slice(start, end)), bed.n_samples
                    )
        except (OSError, ValueError) as e:
            # Chunk failures are logged and skipped (SNPs excluded),
            # mirroring the reference's QC path (prepare.rs:1380-1398).
            log.warning(
                "SNP QC chunk %d-%d failed (%s); excluding its SNPs.",
                start, end, e,
            )
            counts = np.zeros((end - start, 4), dtype=np.int32)
        qc = snp_qc_from_counts(
            counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3],
            n_qc, config,
        )
        keeps.append(qc.keep)
        means.append(qc.mean)
        stds.append(qc.std)
        if (ci + 1) % max(1, n_chunks // 20) == 0 or ci + 1 == n_chunks:
            log.info(
                "SNP QC host scan: chunk %d/%d (%.0f%%).",
                ci + 1, n_chunks, 100.0 * (ci + 1) / n_chunks,
            )
    if not keeps:
        return (
            np.zeros(0, dtype=bool),
            np.zeros(0, dtype=np.float64),
            np.zeros(0, dtype=np.float64),
        )
    return (
        np.concatenate(keeps),
        np.concatenate(means),
        np.concatenate(stds),
    )


def _allgather_qc(
    keep: np.ndarray,
    mean: np.ndarray,
    std: np.ndarray,
    ranges: List[tuple],
):
    """Merge per-process QC results for contiguous (possibly unequal)
    scan ranges.

    Process p owns global rows [ranges[p][0], ranges[p][1]); locals are
    padded to the largest range (keep=False) so the tiled allgather
    concatenates fixed shapes in process order, then each process's
    actual rows are re-assembled in BIM order.  This is the multi-host
    replacement for the reference's single-host QC scan (SURVEY §5
    long-axis mapping).  Ranges may be unequal because the distributed
    scan aligns boundaries to LD blocks (io/ldblocks.py
    block_aligned_ranges).
    """
    from jax.experimental import multihost_utils

    max_len = max(hi - lo for lo, hi in ranges)
    pad = max_len - len(keep)
    local = {
        "keep": np.pad(keep, (0, pad)).astype(np.bool_),
        "mean": np.pad(mean, (0, pad)).astype(np.float64),
        "std": np.pad(std, (0, pad)).astype(np.float64),
    }
    gathered = multihost_utils.process_allgather(local, tiled=True)
    pieces = {k: [] for k in local}
    for p, (lo, hi) in enumerate(ranges):
        for k in pieces:
            pieces[k].append(np.asarray(gathered[k])[p * max_len : p * max_len + (hi - lo)])
    return (
        np.concatenate(pieces["keep"]),
        np.concatenate(pieces["mean"]),
        np.concatenate(pieces["std"]),
    )


def prepare_data(config: DataPrepConfig) -> PreparedData:
    """Full preparation: sample QC -> chunked SNP QC -> LD mapping.

    With multiple JAX processes and `config.distributed_qc`, the QC scan
    itself is sharded: each process reads and QCs only a contiguous
    1/process_count range of BIM rows, and keep-masks + moments merge via
    one allgather — removing the single-host QC bottleneck on multi-host
    slices.  Decisions are exact integer-histogram QC either way, so the
    distributed scan is bit-identical to the serial one.
    """
    if config.qc_mode not in ("auto", "host", "device"):
        raise DataPrepError(
            f"qc_mode must be 'auto', 'host', or 'device', "
            f"got {config.qc_mode!r}"
        )
    bed = BedReader(config.bed_path)
    qc_samples = perform_sample_qc(bed, config.sample_keep_path)
    n_qc = len(qc_samples)
    if n_qc == 0:
        raise DataPrepError("Sample QC left 0 samples.")

    sample_sel = None if n_qc == bed.n_samples else qc_samples
    # 2-bit packed pipeline whenever the full sample set is in play
    # (keep-lists need column subsetting, which packed bytes cannot do).
    packed = bool(config.packed_pipeline) and sample_sel is None
    # No-device process count: the real call materializes the backend,
    # which would serialize the ~60-70 s remote init ahead of the
    # host-side QC scan instead of overlapping it (utils/warmup.py).
    from genomic_pca_tpu.utils.warmup import process_count_nodevice

    n_proc = process_count_nodevice()
    capture: Optional[QcCapture] = None
    scan_ranges: Optional[List[tuple]] = None
    # Parsed up front (the reference parses after QC, main.rs ordering):
    # the distributed scan aligns its range boundaries to LD blocks so
    # every block stays wholly inside one process's range — making the
    # fused QC->matrix assembly (and device block slicing) process-local.
    parsed_blocks = parse_ld_block_file(config.ld_block_path)
    if n_proc > 1 and config.distributed_qc:
        from genomic_pca_tpu.io.ldblocks import block_aligned_ranges

        scan_ranges = block_aligned_ranges(
            bed.bim.chrom, bed.bim.bp, parsed_blocks, n_proc
        )
        lo, hi = scan_ranges[jax.process_index()]
        log.info(
            "Distributed SNP QC: process %d/%d scans rows [%d, %d).",
            jax.process_index(), n_proc, lo, hi,
        )
        if config.qc_mode == "host":
            # Forced host scan: each process counts its range off its
            # own mmap; load_matrix then uploads only its survivors as
            # packed bytes (from_local_rows packed=True).  "auto" keeps
            # the device scan + capture fusion multi-process (capture
            # avoids the post-QC BED re-read on each host).
            log.info("SNP QC: host-side scan (qc_mode=host).")
            keep_l, mean_l, std_l = _qc_snp_range_hostscan(
                bed, config, n_qc, lo, hi, sample_sel=sample_sel
            )
        else:
            # Fused capture engages only when EVERY process's pre-QC
            # range fits its capture budget — the decision must be
            # deterministic and identical across processes (the
            # global-array assembly in load_matrix is collective).
            if config.fuse_qc_matrix:
                max_rows = max(h - l for l, h in scan_ranges)
                if packed:
                    pre_qc_bytes = max_rows * _packed_cols(n_qc)
                else:
                    n_pad = -(-n_qc // 128) * 128
                    pre_qc_bytes = max_rows * n_pad
                if pre_qc_bytes <= 0.45 * _default_device_budget():
                    capture = QcCapture()
            keep_l, mean_l, std_l = _qc_snp_range(
                bed, config, sample_sel, n_qc, lo, hi,
                capture=capture, packed=packed,
            )
        keep, mean_all, std_all = _allgather_qc(
            keep_l, mean_l, std_l, scan_ranges
        )
    elif config.qc_mode == "host" or (
        config.qc_mode == "auto" and config.packed_pipeline
    ):
        # Host-side scan: nothing uploads during QC; the post-QC matrix
        # uploads exactly once in load_matrix (packed either way — the
        # keep-list case repacks decoded survivors to 2-bit).  Strictly
        # less link traffic than any device-scan variant (capture ships
        # the pre-QC block; no-capture ships pre-QC AND survivors).
        # With packed_pipeline=False the matrix stays int8, so "auto"
        # keeps the device scan + capture fusion there (one decode).
        log.info(
            "SNP QC: host-side %s scan (qc_mode=%s).",
            "packed" if packed else "decoded-subset", config.qc_mode,
        )
        keep, mean_all, std_all = _qc_snp_range_hostscan(
            bed, config, n_qc, 0, bed.n_snps, sample_sel=sample_sel
        )
    else:
        # QC->matrix fusion: retain the scan's device uploads when the
        # full pre-QC block fits comfortably on the DEFAULT device (the
        # batches and the assembly output land there before resharding;
        # the post-QC matrix is a subset, so it fits a fortiori).
        # Single-process only: the multi-process load path reads each
        # process's own row range and would never consume the capture.
        if config.fuse_qc_matrix and n_proc == 1:
            if packed:
                # 4x more data fits in the packed layout
                pre_qc_bytes = bed.n_snps * _packed_cols(n_qc)
            else:
                n_pad = -(-n_qc // 128) * 128
                pre_qc_bytes = bed.n_snps * n_pad
            if pre_qc_bytes <= 0.45 * _default_device_budget():
                capture = QcCapture()
        keep, mean_all, std_all = _qc_snp_range(
            bed, config, sample_sel, n_qc, 0, bed.n_snps,
            capture=capture, packed=packed,
        )
    qc_orig = np.nonzero(keep)[0]
    log.info("SNP QC: %d / %d SNPs passed.", len(qc_orig), bed.n_snps)

    blocks, pca_orig = map_snps_to_blocks(
        bed.bim.chrom[qc_orig],
        bed.bim.bp[qc_orig],
        qc_orig,
        parsed_blocks,
    )
    log.info(
        "LD mapping: %d QC'd SNPs -> %d PCA SNPs across %d blocks.",
        len(qc_orig),
        len(pca_orig),
        len(blocks),
    )

    return PreparedData(
        bed=bed,
        config=config,
        qc_sample_indices=qc_samples,
        sample_ids=[str(s) for s in bed.fam.iid[qc_samples]],
        pca_snp_orig_indices=pca_orig,
        mean=mean_all[pca_orig].astype(np.float32),
        std=std_all[pca_orig].astype(np.float32),
        blocks=blocks,
        n_snps_pre_qc=bed.n_snps,
        n_snps_post_qc=len(qc_orig),
        # Multi-process: the capture decision was made globally, so keep
        # it even when THIS process's range captured no batches (an
        # empty-range process must still join the collective assembly).
        qc_capture=capture
        if (capture and (capture.batches or n_proc > 1))
        else None,
        scan_ranges=scan_ranges,
    )
