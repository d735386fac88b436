"""Exception hierarchy.

Equivalent of the reference's `DataPrepError` enum + `WrapErr` context
system (/root/reference/src/prepare.rs:28-138): typed errors so callers
can distinguish ingest, QC, and compute failures, each carrying a
human-readable context chain (Python exception chaining plays the role
of `wrap_err_with_context`).
"""

from __future__ import annotations


class GenomicPcaError(Exception):
    """Base class for all framework errors."""


class BedFormatError(GenomicPcaError, ValueError):
    """Malformed or truncated PLINK .bed/.bim/.fam input."""


class VcfParseError(GenomicPcaError, ValueError):
    """Malformed VCF input or sample-set mismatch."""


class DataPrepError(GenomicPcaError, ValueError):
    """QC / LD-mapping / accessor failures (prepare pipeline)."""


class ComputeError(GenomicPcaError, ValueError):
    """PCA engine failures (invalid shapes, no surviving variants)."""

