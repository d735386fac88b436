"""Configuration dataclasses.

These decouple the CLI surface from the engines, mirroring the reference's
`MicroarrayDataPreparerConfig` (/root/reference/src/prepare.rs:149-156) and
`EigenSNPCoreAlgorithmConfig` (field list characterized at
/root/reference/src/main.rs:302-327).  Defaults are the clap
`default_value_if("eigensnp", ...)` values from
/root/reference/src/main.rs:545-591, which are authoritative when the
EigenSNP workflow is selected.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DataPrepConfig:
    """QC + standardization parameters for the PLINK/EigenSNP path.

    Reference: /root/reference/src/prepare.rs:149-167 and the CLI defaults
    at /root/reference/src/main.rs:545-552.
    """

    bed_path: str = ""
    ld_block_path: str = ""
    sample_keep_path: Optional[str] = None
    min_call_rate: float = 0.98
    min_maf: float = 0.01
    max_hwe_p: float = 1e-6  # 1.0 disables the HWE filter
    min_variance: float = 1e-9
    snp_chunk_size: int = 2000  # SNP_IO_CHUNK_SIZE, prepare.rs:1115
    # Rows per QC device dispatch (chunks are gathered into batches of
    # this many rows before the jitted histogram reduction; results are
    # exact integer counts, so batching never changes QC decisions).
    qc_device_batch: int = 16384
    # Deviation from the reference: the reference accessor hard-errors on a
    # missing genotype surviving QC (prepare.rs:1906-1911); with call-rate
    # thresholds < 1.0 missing values legitimately survive, so the default
    # here is mean-imputation (= exactly what the reference's own Python
    # oracle does, tests/pca.py:110).  Set "error" for strict parity.
    missing_policy: str = "impute_mean"  # "impute_mean" | "error"
    # Multi-host: partition the SNP-QC scan across processes (each host
    # reads and QCs only its contiguous BIM range, then keep-masks and
    # moments are allgathered).  No effect with a single process.
    distributed_qc: bool = True
    # Use the PLINK 2-bit packed device pipeline when no sample subset
    # is selected: BED bytes upload verbatim (no host decode, 4x less
    # transfer), QC histograms run on packed codes (bit-identical
    # decisions), and the matrix stays 2-bit in HBM (4x capacity).
    # Sample keep-lists fall back to the int8 pipeline.
    packed_pipeline: bool = True
    # Fuse QC with matrix assembly: the QC scan's device-uploaded
    # genotype batches are retained and the final sharded matrix is
    # gathered from them on device — one BED pass and one host->device
    # upload for the whole workflow instead of two of each.  Applies
    # single-process when the pre-QC block fits comfortably in device
    # memory; otherwise the scan stays streaming (no behavior change).
    fuse_qc_matrix: bool = True
    # Where the QC genotype histograms are computed.  "host" counts on
    # the host — straight off the mmap'd BED bytes (native SWAR
    # popcounts, numpy fallback) for the full sample set, or on decoded
    # kept columns under a keep-list — so NOTHING uploads to the device
    # until the post-QC matrix: the minimum possible host->device
    # traffic (the pre-QC block is 1.4-3x larger than the survivors).
    # "device" uploads pre-QC batches and reduces on the accelerator
    # (required for the fused QC->matrix capture).  "auto" = host scan
    # for single-process runs with the packed pipeline (with or without
    # a keep-list), device otherwise (multi-process keeps the
    # LD-aligned capture fusion; packed_pipeline=False keeps the int8
    # capture).  Counts are exact integers either way, so QC decisions
    # are bit-identical across modes.
    qc_mode: str = "auto"  # "auto" | "host" | "device"


@dataclasses.dataclass(frozen=True)
class RsvdConfig:
    """Randomized-SVD parameters (VCF workflow `rfit` equivalent).

    Reference call site: /root/reference/src/main.rs:648-656 — k from CLI,
    n_oversamples=10, seed passthrough, tol=None.
    """

    k: int = 10
    n_oversamples: int = 10
    n_power_iter: int = 4
    seed: Optional[int] = None
    # rfit's tolerance argument: subspace-residual early exit for the
    # power loop.  The reference always passes None (main.rs:648-656).
    tolerance: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class EigenSnpConfig:
    """EigenSNP two-stage algorithm parameters.

    Field-for-field parity with `EigenSNPCoreAlgorithmConfig` as populated
    at /root/reference/src/main.rs:311-327 with clap defaults from
    main.rs:553-591.
    """

    k_global: int = 10
    components_per_block: int = 7
    subset_factor: float = 0.075
    min_subset_size: int = 10_000
    max_subset_size: int = 40_000
    global_oversampling: int = 10
    global_power_iter: int = 2
    local_oversampling: int = 10
    local_power_iter: int = 2
    seed: int = 2025
    snp_strip_size: int = 2000
    refine_passes: int = 1
    collect_diagnostics: bool = False
    # Analog of `diagnostic_block_list_id_to_trace`
    # (/root/reference/src/main.rs:326, always None there): select ONE
    # LD block by tag for deep stage-1 tracing — the diagnostics JSON
    # gains a `block_trace` entry with the block's subset sample
    # indices, PCA SNP ids, full local basis, local singular values,
    # and its rows of the condensed projection.  Setting this implies
    # diagnostics collection.
    diagnostic_block_tag: Optional[str] = None
    # Width of the refinement subspace (extension over the reference).
    # None = auto: widen to 128 columns (better convergence per pass —
    # see models/pca.lane_fill_width).  Set <= k_global to
    # refine exactly the k-dimensional stage-2 basis.
    refine_width: Optional[int] = None

    def subset_size(self, n_samples: int) -> int:
        """Sample-subset size for local basis learning.

        subset_factor × N clamped to [min_subset_size, max_subset_size]
        and never more than N (semantics per SURVEY §2.4 /
        main.rs:314-316).
        """
        raw = int(round(self.subset_factor * n_samples))
        clamped = max(self.min_subset_size, min(self.max_subset_size, raw))
        return min(n_samples, clamped)
