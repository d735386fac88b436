"""VCF/VCF.GZ ingestion: directory discovery, GT -> dosage, MAF gate.

Behavior parity with the reference's noodles-vcf path
(/root/reference/src/vcf.rs:14-287, main.rs:133-203):

* Discover `*.vcf` / `*.vcf.gz` in a directory, sorted by filename
  (main.rs:139-152); the first file's header defines the canonical sample
  set and every other file must match it exactly (vcf.rs:75-89).
* Bi-allelic SNP gate: single-base REF, exactly one single-base ALT
  (vcf.rs:109-121).
* GT parsing fast path: exactly 3 bytes `a{/|}b` with a,b in {0,1}
  (vcf.rs:51-63).  Any sample whose GT is missing ('.'), multi-allelic,
  haploid, or otherwise unparsable drops the WHOLE variant
  (vcf.rs:227-242).
* MAF from the dosage sum over 2N alleles; variants with
  maf < threshold are dropped (threshold defaults to 0.01 when unset,
  vcf.rs:258).
* Variant ID = `chrom:pos:ref:alt` (vcf.rs:272-273).

BGZF `.vcf.gz` files are decompressed block-parallel through the native
inflater (io/bgzf.py + native/plinkio.cpp); plain multi-member gzip
falls back to Python's gzip module (identical semantics, serial).

Hot-path design: when FORMAT is exactly "GT" every sample field is 3
bytes, so the record's sample region has fixed stride 4 and the entire
per-variant parse is three numpy slice-compares on the raw bytes — no
per-sample Python objects (the vectorized analog of the reference's
3-byte fast path).  Irregular records fall back to a per-field parser
with identical semantics.
"""

from __future__ import annotations

import dataclasses
import gzip
import logging
from pathlib import Path
from typing import IO, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from genomic_pca_tpu.errors import VcfParseError

log = logging.getLogger(__name__)


@dataclasses.dataclass
class VcfVariantBlock:
    """Variants parsed from one VCF file (variant-major dosages)."""

    ids: List[str]
    dosages: np.ndarray  # (n_variants, n_samples) int8, no missing


def discover_vcf_files(vcf_dir: str) -> List[Path]:
    paths = [
        p
        for p in Path(vcf_dir).iterdir()
        if p.is_file() and (p.name.endswith(".vcf") or p.name.endswith(".vcf.gz"))
    ]
    paths.sort()
    if not paths:
        raise FileNotFoundError(f"No .vcf or .vcf.gz files found in {vcf_dir}")
    return paths


def _open_text(path: Path) -> IO[bytes]:
    if path.name.endswith(".gz"):
        from genomic_pca_tpu.io.bgzf import open_maybe_bgzf

        fh = open_maybe_bgzf(path)
        if fh is not None:  # BGZF: block-parallel native inflate
            return fh
        return gzip.open(path, "rb")  # plain gzip (serial by construction)
    return open(path, "rb")


def read_vcf_sample_names(path: Path) -> List[str]:
    """Sample names from the #CHROM header line; GT must be declared."""
    has_gt_format = False
    with _open_text(path) as fh:
        for raw in fh:
            if raw.startswith(b"##"):
                if raw.startswith(b"##FORMAT=") and b"ID=GT" in raw:
                    has_gt_format = True
                continue
            if raw.startswith(b"#CHROM"):
                fields = raw.rstrip(b"\r\n").split(b"\t")
                if len(fields) < 10:
                    raise VcfParseError(f"VCF header from {path} contains no samples.")
                if not has_gt_format:
                    raise VcfParseError(
                        f"GT key (FORMAT=GT) not found in FORMAT header for VCF {path}"
                    )
                return [f.decode() for f in fields[9:]]
            raise VcfParseError(f"Malformed VCF {path}: data before #CHROM header")
    raise VcfParseError(f"Malformed VCF {path}: missing #CHROM header line")


_ALLELE_CODE = np.full(256, -1, dtype=np.int8)
_ALLELE_CODE[ord("0")] = 0
_ALLELE_CODE[ord("1")] = 1
_SNP_BASES = frozenset(b"ACGTacgt")


def _parse_samples_fast(region: bytes, n_samples: int) -> Optional[np.ndarray]:
    """Vectorized GT parse when every field is a 3-byte diploid GT.

    Returns int8 dosages or None if the variant must be dropped.
    """
    arr = np.frombuffer(region, dtype=np.uint8).reshape(n_samples, 4)[:, :3]
    sep = arr[:, 1]
    if not (((sep == ord("/")) | (sep == ord("|"))).all()):
        return None
    a1 = _ALLELE_CODE[arr[:, 0]]
    a2 = _ALLELE_CODE[arr[:, 2]]
    if (a1 < 0).any() or (a2 < 0).any():
        return None
    return a1 + a2


def _parse_samples_general(
    fields: List[bytes], gt_index: int
) -> Optional[np.ndarray]:
    """Per-field GT parse with the reference's 3-byte strictness."""
    out = np.empty(len(fields), dtype=np.int8)
    for i, field in enumerate(fields):
        if gt_index == 0:
            end = field.find(b":")
            gt = field if end < 0 else field[:end]
        else:
            parts = field.split(b":")
            if gt_index >= len(parts):
                return None
            gt = parts[gt_index]
        if len(gt) != 3 or (gt[1] != ord("/") and gt[1] != ord("|")):
            return None
        a1 = _ALLELE_CODE[gt[0]]
        a2 = _ALLELE_CODE[gt[2]]
        if a1 < 0 or a2 < 0:
            return None
        out[i] = a1 + a2
    return out


def process_single_vcf(
    path: Path,
    canonical_samples: Sequence[str],
    maf_threshold: Optional[float],
) -> Optional[VcfVariantBlock]:
    """Parse one VCF into MAF-filtered dosage rows (None if no survivors)."""
    samples = read_vcf_sample_names(path)
    if list(samples) != list(canonical_samples):
        raise VcfParseError(
            f"Sample mismatch in VCF {path}: expected {len(canonical_samples)} "
            f"samples matching the first VCF, found {len(samples)}."
        )
    n_samples = len(samples)
    threshold = 0.01 if maf_threshold is None else maf_threshold
    two_n = 2.0 * n_samples

    ids: List[str] = []
    rows: List[np.ndarray] = []

    # Native bulk parse: stream the body in chunks of complete lines
    # through the C++ tokenizer (native/plinkio.cpp), applying the MAF
    # gate vectorized per chunk.  Falls back to the per-line Python
    # parser below when the native library is unavailable.
    from genomic_pca_tpu.io.native import get_lib, parse_vcf_lines_native

    if get_lib() is not None:
        chunk_bytes = 64 << 20
        with _open_text(path) as fh:
            # Skip header lines.
            for raw in fh:
                if raw.startswith(b"#CHROM"):
                    break
            carry = b""
            while True:
                data = fh.read(chunk_bytes)
                if not data and not carry:
                    break
                buf = carry + data
                if data:
                    cut = buf.rfind(b"\n")
                    if cut < 0:
                        carry = buf
                        continue
                    carry = buf[cut + 1 :]
                    buf = buf[: cut + 1]
                else:
                    carry = b""
                if not buf:
                    continue
                parsed = parse_vcf_lines_native(buf, n_samples)
                dosages, keep, line_starts, n_lines = parsed
                kept_idx = np.nonzero(keep[:n_lines])[0]
                if len(kept_idx) == 0:
                    continue
                kept_dos = dosages[kept_idx]
                sums = kept_dos.sum(axis=1, dtype=np.int64).astype(np.float64)
                freq = sums / two_n
                maf = np.minimum(freq, 1.0 - freq)
                pass_maf = maf >= threshold
                for j in np.nonzero(pass_maf)[0]:
                    li = kept_idx[j]
                    start = line_starts[li]
                    endb = buf.find(b"\n", start)
                    fields = buf[start : endb if endb >= 0 else len(buf)].split(
                        b"\t", 5
                    )
                    ids.append(
                        f"{fields[0].decode()}:{fields[1].decode()}:"
                        f"{fields[3].decode()}:{fields[4].decode()}"
                    )
                rows.append(np.ascontiguousarray(kept_dos[pass_maf]))
        if not rows:
            return None
        return VcfVariantBlock(
            ids=ids, dosages=np.concatenate(rows, axis=0).astype(np.int8)
        )

    fast_region_len = 4 * n_samples - 1

    with _open_text(path) as fh:
        for raw in fh:
            if raw.startswith(b"#"):
                continue
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            # CHROM POS ID REF ALT QUAL FILTER INFO FORMAT <samples...>
            head = line.split(b"\t", 9)
            if len(head) < 10:
                continue
            chrom, pos, _vid, ref, alt, _q, _f, _info, fmt, sample_region = head
            if len(ref) != 1 or len(alt) != 1:
                continue  # not a bi-allelic single-base SNP
            if ref[0] not in _SNP_BASES or alt[0] not in _SNP_BASES:
                continue

            dosages: Optional[np.ndarray]
            if fmt == b"GT" and len(sample_region) == fast_region_len:
                dosages = _parse_samples_fast(sample_region + b"\t", n_samples)
            else:
                fmt_fields = fmt.split(b":")
                if b"GT" not in fmt_fields:
                    continue  # GT series absent for this record
                gt_index = fmt_fields.index(b"GT")
                fields = sample_region.split(b"\t")
                if len(fields) != n_samples:
                    continue
                dosages = _parse_samples_general(fields, gt_index)
            if dosages is None:
                continue  # whole-variant drop on any bad GT

            allele_sum = float(int(dosages.sum(dtype=np.int64)))
            freq = allele_sum / two_n
            maf = min(freq, 1.0 - freq)
            if maf < threshold:
                continue

            ids.append(f"{chrom.decode()}:{pos.decode()}:{ref.decode()}:{alt.decode()}")
            rows.append(dosages)

    if not rows:
        return None
    return VcfVariantBlock(ids=ids, dosages=np.stack(rows).astype(np.int8))


def load_vcf_directory_sharded(
    vcf_dir: str,
    maf_threshold: Optional[float],
    process_index: int,
    process_count: int,
    n_workers: int = 0,
):
    """Per-host file-sharded VCF parse: this process parses ONLY the
    files it owns (round-robin by sorted file index — the distributed
    form of the reference's rayon par_iter over files, main.rs:171-179).

    Returns (canonical_samples, n_files, owned_blocks) where
    owned_blocks is {file_index: VcfVariantBlock} for files this process
    owns that had surviving variants.  Every process reads only the
    FIRST file's header (the canonical sample set, vcf.rs:75-89) plus
    its own files; global per-file variant counts are for the caller to
    exchange (see workflows.run_vcf_workflow).
    """
    paths = discover_vcf_files(vcf_dir)
    canonical = read_vcf_sample_names(paths[0])
    owned = [
        (i, p) for i, p in enumerate(paths) if i % process_count == process_index
    ]
    log.info(
        "Process %d/%d parsing %d of %d VCF files (%d canonical samples).",
        process_index,
        process_count,
        len(owned),
        len(paths),
        len(canonical),
    )

    if n_workers > 1 and len(owned) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(n_workers, len(owned))) as pool:
            parsed = pool.starmap(
                process_single_vcf,
                [(p, canonical, maf_threshold) for _i, p in owned],
            )
    else:
        parsed = [process_single_vcf(p, canonical, maf_threshold) for _i, p in owned]

    blocks = {
        i: blk for (i, _p), blk in zip(owned, parsed) if blk is not None
    }
    return canonical, len(paths), blocks


def load_vcf_directory(
    vcf_dir: str,
    maf_threshold: Optional[float],
    n_workers: int = 0,
) -> Tuple[List[str], List[str], Iterator[np.ndarray]]:
    """Parse a VCF directory into (sample_names, variant_ids, strip iterator).

    Files are processed in sorted order (aggregation preserves file order,
    vcf.rs:293-315); `n_workers > 1` parses files in parallel processes
    (the rayon par_iter analog, main.rs:171-179).
    """
    paths = discover_vcf_files(vcf_dir)
    canonical = read_vcf_sample_names(paths[0])
    log.info(
        "Found %d VCF files; canonical sample set has %d samples (from %s).",
        len(paths),
        len(canonical),
        paths[0].name,
    )

    blocks: List[Optional[VcfVariantBlock]]
    if n_workers > 1 and len(paths) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(n_workers, len(paths))) as pool:
            blocks = pool.starmap(
                process_single_vcf,
                [(p, canonical, maf_threshold) for p in paths],
            )
    else:
        try:
            from tqdm import tqdm

            iterator = tqdm(paths, desc="VCF files", unit="file")
        except ImportError:
            iterator = paths
        blocks = [process_single_vcf(p, canonical, maf_threshold) for p in iterator]

    variant_ids: List[str] = []
    strips: List[np.ndarray] = []
    for blk in blocks:
        if blk is None:
            continue
        variant_ids.extend(blk.ids)
        strips.append(blk.dosages)
    if not variant_ids:
        raise VcfParseError("No variants passed filters across all VCF files.")
    return canonical, variant_ids, iter(strips)
