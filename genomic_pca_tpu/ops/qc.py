"""Per-SNP QC: device-side genotype histograms + host-side exact filters.

Replaces the reference's two-pass 256-bit-SIMD QC kernel
(/root/reference/src/prepare.rs:1232-1363) with a device/host split:

1. `genotype_counts` — a jitted XLA reduction over the samples axis of an
   int8 SNP-major strip, producing per-SNP counts (n0, n1, n2, n_valid)
   as int32.  Dosages are integers in {0,1,2}, so these histograms carry
   *exact* sufficient statistics: dosage_sum = n1 + 2*n2 and
   sum_of_squares = n1 + 4*n2 — which makes mean/variance/MAF/HWE exactly
   computable afterwards with no floating-point accumulation error (the
   reference needs f64 SIMD accumulators for the same guarantee,
   prepare.rs:1218, 1316).

2. `snp_qc_from_counts` — host-side (numpy f64) application of the QC
   chain in the reference's order (prepare.rs:1280-1363):
   call-rate >= min  ->  MAF >= min (+ monomorphic epsilon)  ->
   HWE p > max (filter active only when threshold < 1.0)  ->
   sample variance (ddof=1) > 1e-9.

Returning counts rather than decisions keeps the device program
shape-static (the survivor count is data-dependent, so select/gather
happens on host — SURVEY §7 "hard parts").
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from genomic_pca_tpu.config import DataPrepConfig
from genomic_pca_tpu.ops.hwe import hwe_chi2_p

MISSING = -127


@partial(jax.jit, donate_argnums=())
def genotype_counts(strip: jax.Array) -> tuple:
    """Count per-row genotype classes of an int8 (snps, samples) strip.

    Returns int32 arrays (n0, n1, n2, n_valid), each of shape (snps,).
    Any value outside {0,1,2} counts as missing.
    """
    g = strip
    n0 = jnp.sum((g == 0).astype(jnp.int32), axis=1)
    n1 = jnp.sum((g == 1).astype(jnp.int32), axis=1)
    n2 = jnp.sum((g == 2).astype(jnp.int32), axis=1)
    return n0, n1, n2, n0 + n1 + n2


@partial(jax.jit, static_argnames=("n_samples",))
def genotype_counts_packed(strip: jax.Array, n_samples: int) -> tuple:
    """`genotype_counts` over a PLINK 2-bit packed (snps, bytes) strip.

    Codes (count_A1, low bits first): 00 -> dosage 2, 01 -> missing,
    10 -> 1, 11 -> 0.  Columns beyond `n_samples` (pad fields) are
    excluded via the sample-index mask; the identical integer counts
    make packed QC decisions bit-identical to the int8 scan.
    """
    c = strip.astype(jnp.int32)
    n4 = c.shape[1]
    n0 = jnp.zeros(c.shape[0], jnp.int32)
    n1 = jnp.zeros(c.shape[0], jnp.int32)
    n2 = jnp.zeros(c.shape[0], jnp.int32)
    for p in range(4):
        cp = (c >> (2 * p)) & 3
        valid_col = ((4 * jnp.arange(n4) + p) < n_samples)[None, :]
        n2 += jnp.sum((cp == 0) & valid_col, axis=1, dtype=jnp.int32)
        n1 += jnp.sum((cp == 2) & valid_col, axis=1, dtype=jnp.int32)
        n0 += jnp.sum((cp == 3) & valid_col, axis=1, dtype=jnp.int32)
    return n0, n1, n2, n0 + n1 + n2


# counts-per-byte of each 2-bit code: _PACKED_CODE_COUNT[code][byte]
_PACKED_CODE_COUNT = np.zeros((4, 256), dtype=np.uint8)
for _b in range(256):
    for _p in range(4):
        _PACKED_CODE_COUNT[(_b >> (2 * _p)) & 3, _b] += 1


def genotype_counts_packed_host(
    raw: np.ndarray, n_samples: int
) -> np.ndarray:
    """Host (numpy) analog of `genotype_counts_packed`: per-SNP counts
    off raw packed rows with no device involvement.

    `raw` is (rows, >= ceil(n_samples/4)) uint8 (extra pad columns are
    ignored).  Returns (rows, 4) int32 columns (n0, n1, n2, n_valid) —
    identical integers to the device reduction and to the native
    `plinkio_packed_qc_counts`.
    """
    bps = (n_samples + 3) // 4
    raw = np.asarray(raw, dtype=np.uint8)[:, :bps]
    n0 = _PACKED_CODE_COUNT[3][raw].sum(axis=1, dtype=np.int64)
    n1 = _PACKED_CODE_COUNT[2][raw].sum(axis=1, dtype=np.int64)
    miss = _PACKED_CODE_COUNT[1][raw].sum(axis=1, dtype=np.int64)
    rem = n_samples % 4
    if rem and bps:
        last = raw[:, -1]
        for p in range(rem, 4):  # trailing pad fields are not samples
            code = (last >> (2 * p)) & 3
            n0 -= code == 3
            n1 -= code == 2
            miss -= code == 1
    nv = n_samples - miss
    n2 = nv - n0 - n1
    return np.stack([n0, n1, n2, nv], axis=1).astype(np.int32)


def dosage_mean_from_counts(counts: np.ndarray) -> np.ndarray:
    """Exact per-SNP dosage mean over valid entries from (rows, 4)
    integer counts (n0, n1, n2, n_valid) — THE moment formula every
    packing/assembly site must share so host/device paths stay
    bit-identical."""
    nv = counts[:, 3].astype(np.int64)
    ds = counts[:, 1].astype(np.int64) + 2 * counts[:, 2].astype(np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(nv > 0, ds / np.maximum(nv, 1), 0.0)


def genotype_counts_int8_host(raw: np.ndarray) -> np.ndarray:
    """Host (numpy) analog of `genotype_counts` for int8 dosage rows:
    (rows, 4) int32 (n0, n1, n2, n_valid), identical integers to the
    device reduction.  Any value outside {0,1,2} counts as missing."""
    raw = np.asarray(raw, dtype=np.int8)
    n0 = (raw == 0).sum(axis=1, dtype=np.int64)
    n1 = (raw == 1).sum(axis=1, dtype=np.int64)
    n2 = (raw == 2).sum(axis=1, dtype=np.int64)
    return np.stack([n0, n1, n2, n0 + n1 + n2], axis=1).astype(np.int32)


@dataclasses.dataclass
class QcResult:
    """Per-strip QC outcome: survivor mask plus standardization moments."""

    keep: np.ndarray  # bool (snps,)
    mean: np.ndarray  # float32 (snps,), 0 where dropped
    std: np.ndarray  # float32 (snps,), 0 where dropped

    @property
    def n_kept(self) -> int:
        return int(self.keep.sum())


def snp_qc_from_counts(
    n0: np.ndarray,
    n1: np.ndarray,
    n2: np.ndarray,
    n_valid: np.ndarray,
    n_qc_samples: int,
    config: DataPrepConfig,
) -> QcResult:
    """Apply the QC chain exactly, from integer genotype counts.

    `n2` is the homozygous count for the counted allele (dosage 2); the
    allele-1 dosage sum is n1 + 2*n2 (counts are exact, see module doc).
    """
    n0 = np.asarray(n0, dtype=np.int64)
    n1 = np.asarray(n1, dtype=np.int64)
    n2 = np.asarray(n2, dtype=np.int64)
    nv = np.asarray(n_valid, dtype=np.int64)

    keep = np.ones(nv.shape, dtype=bool)

    # 1. call rate (prepare.rs:1282-1284)
    if n_qc_samples > 0:
        call_rate = nv / float(n_qc_samples)
        keep &= call_rate >= config.min_call_rate
    keep &= nv > 0

    with np.errstate(divide="ignore", invalid="ignore"):
        dosage_sum = (n1 + 2 * n2).astype(np.float64)
        mean = np.where(nv > 0, dosage_sum / np.maximum(nv, 1), 0.0)
        freq = mean / 2.0
        maf = np.minimum(freq, 1.0 - freq)

        # 2. MAF + explicit monomorphic epsilon (prepare.rs:1294-1304)
        keep &= maf >= config.min_maf
        keep &= np.abs(freq) >= 1e-9
        keep &= np.abs(1.0 - freq) >= 1e-9

        # The later filters evaluate only on rows still alive (the
        # reference's per-SNP loop short-circuits the same way,
        # prepare.rs:1280-1363) — at genome scale the HWE chain over
        # all 10M rows cost minutes of host time for SNPs the MAF gate
        # had already dropped.  Identical decisions: same formulas on
        # the same elements.
        alive = np.flatnonzero(keep)

        # 3. HWE, only when the filter is active (prepare.rs:1306-1311)
        if config.max_hwe_p < 1.0 and len(alive):
            hwe_p = hwe_chi2_p(n0[alive], n1[alive], n2[alive])
            fail = hwe_p <= config.max_hwe_p
            keep[alive[fail]] = False
            alive = alive[~fail]

        # 4. sample variance ddof=1 (prepare.rs:1316-1363): exact via
        #    sum(g^2) = n1 + 4*n2  =>  ssd = sum(g^2) - nv*mean^2
        nv_a = nv[alive]
        mean_a = mean[alive]
        sum_sq = (n1[alive] + 4 * n2[alive]).astype(np.float64)
        ssd = sum_sq - nv_a * mean_a * mean_a
        var_a = np.where(nv_a >= 2, ssd / np.maximum(nv_a - 1, 1), 0.0)
        fail = var_a <= config.min_variance
        keep[alive[fail]] = False
        alive = alive[~fail]
        var_a = var_a[~fail]

    mean_out = np.zeros(len(keep), dtype=np.float32)
    std_out = np.zeros(len(keep), dtype=np.float32)
    mean_out[alive] = mean[alive].astype(np.float32)
    std_out[alive] = np.sqrt(np.maximum(var_a, 0.0)).astype(np.float32)
    return QcResult(keep=keep, mean=mean_out, std=std_out)


def qc_strip(
    strip: np.ndarray, n_qc_samples: int, config: DataPrepConfig
) -> QcResult:
    """Convenience: device histogram + host filter for one int8 strip."""
    n0, n1, n2, nv = (np.asarray(a) for a in genotype_counts(jnp.asarray(strip)))
    return snp_qc_from_counts(n0, n1, n2, nv, n_qc_samples, config)
