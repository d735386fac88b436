"""Exact Gram-matrix PCA — the correctness oracle.

Re-implementation of the reference's own numeric ground truth
(/root/reference/tests/pca.py:70-141): stream variant strips, QC, center
(optionally scale), mean-impute missing, accumulate the N x N sample Gram
matrix in float64, divide by the kept-variant count, exact `eigh`, and
scores = eigenvectors * sqrt(eigenvalues).

Runs in numpy float64 on host: it is the measuring stick the device paths are
validated against (sign-flip-invariant |r| > 0.999 per PC, SURVEY §7), not
a production path.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, Optional

import numpy as np

from genomic_pca_tpu.config import DataPrepConfig
from genomic_pca_tpu.errors import ComputeError
from genomic_pca_tpu.ops.qc import snp_qc_from_counts

log = logging.getLogger(__name__)

MISSING = -127


@dataclasses.dataclass
class ExactPcaResult:
    scores: np.ndarray  # (n_samples, k)
    eigenvalues: np.ndarray  # (k,)
    n_kept_variants: int


def _counts(strip: np.ndarray):
    n0 = (strip == 0).sum(axis=1)
    n1 = (strip == 1).sum(axis=1)
    n2 = (strip == 2).sum(axis=1)
    return n0, n1, n2, n0 + n1 + n2


def exact_pca_from_strips(
    strips: Iterable[np.ndarray],
    n_samples: int,
    k: int,
    config: Optional[DataPrepConfig] = None,
    scale: bool = False,
    apply_qc: bool = True,
) -> ExactPcaResult:
    """Exact PCA over an iterator of (snps, samples) int8 dosage strips.

    `scale=False` reproduces the reference oracle (center-only,
    tests/pca.py:109); `scale=True` standardizes like the EigenSNP path.
    """
    config = config or DataPrepConfig()
    gram = np.zeros((n_samples, n_samples), dtype=np.float64)
    kept = 0

    for strip in strips:
        strip = np.asarray(strip, dtype=np.int8)
        if apply_qc:
            n0, n1, n2, nv = _counts(strip)
            qc = snp_qc_from_counts(n0, n1, n2, nv, n_samples, config)
            if qc.n_kept == 0:
                continue
            sel = strip[qc.keep]
            mean = qc.mean[qc.keep].astype(np.float64)
            std = qc.std[qc.keep].astype(np.float64)
        else:
            n0, n1, n2, nv = _counts(strip)
            with np.errstate(divide="ignore", invalid="ignore"):
                mean = np.where(nv > 0, (n1 + 2.0 * n2) / np.maximum(nv, 1), 0.0)
                ssd = (n1 + 4.0 * n2) - nv * mean * mean
                std = np.sqrt(np.where(nv >= 2, ssd / np.maximum(nv - 1, 1), 0.0))
            sel = strip

        x = sel.astype(np.float64)
        valid = sel != MISSING
        x = np.where(valid, x, mean[:, None])  # mean-impute missing
        x -= mean[:, None]
        if scale:
            safe = np.where(std > 0, std, 1.0)
            x /= safe[:, None]
        gram += x.T @ x
        kept += x.shape[0]

    if kept == 0:
        raise ComputeError("No variants passed QC; cannot compute PCA.")

    gram /= kept
    evals_all, evecs_all = np.linalg.eigh(gram)  # ascending
    k_eff = min(k, n_samples - 1) if n_samples > 1 else 1
    evals = evals_all[-k_eff:][::-1].copy()
    evecs = evecs_all[:, -k_eff:][:, ::-1].copy()
    scores = evecs * np.sqrt(np.maximum(evals, 0.0))
    return ExactPcaResult(scores=scores, eigenvalues=evals, n_kept_variants=kept)
