"""Command-line interface — full flag parity with the reference CLI.

Flag-for-flag port of the clap-derive `CliArgs`
(/root/reference/src/main.rs:501-593), including the conditional
requiredness (`--vcf-dir`/`-k` required unless `--eigensnp`;
`--bed-file`/`--ld-block-file` required with it) and the
`default_value_if("eigensnp", ...)` defaults (main.rs:545-591).

Usage:
    python -m genomic_pca_tpu -d vcf_dir/ -o out -k 10
    python -m genomic_pca_tpu --eigensnp --bed-file x.bed \
        --ld-block-file blocks.tsv -o out
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Optional

from genomic_pca_tpu.utils.logsetup import setup_logging

log = logging.getLogger("genomic_pca_tpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genomic-pca-tpu",
        description="Genomic PCA Tool from VCF or BED/LD-block files (JAX/XLA).",
    )
    from genomic_pca_tpu import __version__

    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    # --- Common arguments ---
    p.add_argument("-o", "--out", dest="output_prefix", required=True,
                   help="Output file prefix.")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="Number of threads for parallel host operations "
                        "(default: all available CPUs).")
    p.add_argument("--log-level", default="Info",
                   help="Logging level (e.g., Off, Error, Warn, Info, Debug, Trace).")

    # --- VCF workflow ---
    p.add_argument("-d", "--vcf-dir", default=None,
                   help="Directory containing VCF files "
                        "(required if not using --eigensnp).")
    p.add_argument("-k", "--components", type=int, default=None,
                   help="Number of principal components to compute (VCF workflow).")
    p.add_argument("--maf", type=float, default=None,
                   help="Minimum MAF for VCF variant filtering "
                        "(defaults to 0.01 when processing).")
    p.add_argument("--rfit-seed", type=int, default=None,
                   help="Seed for randomized SVD (VCF workflow).")
    p.add_argument("--rfit-tolerance", type=float, default=None,
                   help="Optional convergence tolerance for the randomized "
                        "SVD power loop (VCF workflow): early-exits once "
                        "the relative subspace residual of a pass drops "
                        "below it.  Default: run all iterations "
                        "(the rfit contract's tolerance=None).")

    # --- EigenSNP workflow ---
    p.add_argument("--eigensnp", action="store_true",
                   help="Run PCA using the EigenSNP algorithm "
                        "(requires BED & LD block files).")
    p.add_argument("--bed-file", default=None,
                   help="Path to the BED file (required if --eigensnp).")
    p.add_argument("--ld-block-file", default=None,
                   help="Path to the LD block definition file "
                        "(required if --eigensnp).")
    p.add_argument("--eigensnp-sample-keep-file", default=None,
                   help="Optional: file listing sample IDs to keep.")
    p.add_argument("--eigensnp-min-call-rate", type=float, default=None,
                   help="Min SNP call rate for QC (default 0.98).")
    p.add_argument("--eigensnp-min-maf", type=float, default=None,
                   help="Min SNP MAF for QC (default 0.01).")
    p.add_argument("--eigensnp-max-hwe-p", type=float, default=None,
                   help="Max SNP HWE p-value for QC; 1.0 disables "
                        "(default 1e-6).")
    p.add_argument("--eigensnp-k-global", type=int, default=None,
                   help="Target number of global PCs (default 10).")
    p.add_argument("--eigensnp-components-per-block", type=int, default=None,
                   help="Local components per LD block (default 7).")
    p.add_argument("--eigensnp-subset-factor", type=float, default=None,
                   help="Subset factor for local basis learning (default 0.075).")
    p.add_argument("--eigensnp-min-subset-size", type=int, default=None,
                   help="Min subset size for local basis learning (default 10000).")
    p.add_argument("--eigensnp-max-subset-size", type=int, default=None,
                   help="Max subset size for local basis learning (default 40000).")
    p.add_argument("--eigensnp-global-oversampling", type=int, default=None,
                   help="Global PCA sketch oversampling (default 10).")
    p.add_argument("--eigensnp-global-power-iter", type=int, default=None,
                   help="Global PCA power iterations (default 2).")
    p.add_argument("--eigensnp-local-oversampling", type=int, default=None,
                   help="Local RSVD sketch oversampling (default 10).")
    p.add_argument("--eigensnp-local-power-iter", type=int, default=None,
                   help="Local RSVD power iterations (default 2).")
    p.add_argument("--eigensnp-seed", type=int, default=None,
                   help="Random seed for EigenSNP (default 2025).")
    p.add_argument("--eigensnp-snp-strip-size", type=int, default=None,
                   help="SNP processing strip size (default 2000).")
    p.add_argument("--eigensnp-refine-passes", type=int, default=None,
                   help="Number of refinement passes (default 1).")
    p.add_argument("--eigensnp-refine-width", type=int, default=None,
                   help="Refinement subspace width (extension over the "
                        "reference: default widens to 128 columns for "
                        "better convergence; set to k_global to refine "
                        "exactly the stage-2 basis).")
    p.add_argument("--eigensnp-collect-diagnostics", action="store_true",
                   help="Enable detailed diagnostics collection.")
    p.add_argument("--eigensnp-diagnostic-block-tag", default=None,
                   help="Deep-trace ONE LD block (by its chr:start-end "
                        "tag): the diagnostics JSON gains a block_trace "
                        "entry with the block's subset indices, SNP ids, "
                        "full local basis, singular values and condensed "
                        "projection.  Implies diagnostics collection.")
    p.add_argument("--profile-dir", default=None,
                   help="Capture a jax.profiler trace of the compute "
                        "stages to this directory (XProf/TensorBoard).")
    p.add_argument("--eigensnp-compile-only", action="store_true",
                   help="Seed the persistent compilation cache for this "
                        "fileset's shape (QC + AOT-compile every device "
                        "program) without running the PCA or writing "
                        "outputs; the next real run starts fully warm.")
    p.add_argument("--eigensnp-stop-after-checkpoint", default=None,
                   metavar="NAME",
                   help="With --eigensnp-checkpoint-dir: exit cleanly "
                        "right after the named checkpoint (stage1_bases, "
                        "stage2_basis, refine_pass_<p>) is saved; a later "
                        "run with the same checkpoint dir resumes there. "
                        "For scheduled preemption and for bounding one "
                        "process's memory footprint.")
    p.add_argument("--eigensnp-checkpoint-dir", default=None,
                   help="Directory for stage checkpoint/resume on "
                        "preemptible capacity (extension over the "
                        "reference CLI).")
    p.add_argument("--eigensnp-no-fuse-qc", action="store_true",
                   help="Disable the QC->matrix fusion (the fused path "
                        "keeps the QC scan's device uploads and skips "
                        "the second BED pass; disable to minimize HBM "
                        "held during preparation).")
    p.add_argument("--eigensnp-qc-mode", default="auto",
                   choices=("auto", "host", "device"),
                   help="Where SNP-QC genotype histograms run: 'host' "
                        "counts 2-bit codes off the mmap'd BED (native "
                        "SWAR; nothing uploads until the post-QC "
                        "matrix), 'device' reduces on the accelerator "
                        "(enables QC->matrix capture fusion).  'auto' "
                        "picks host for the single-process packed "
                        "pipeline.  QC decisions are bit-identical "
                        "across modes.")

    # --- Projection (new capability, DEVIATIONS.md §8) ---
    p.add_argument("--write-moments", action="store_true",
                   help="EigenSNP: also write {prefix}.eigensnp.moments.tsv "
                        "(per-SNP training mean/std) so the fitted model "
                        "can be re-loaded for --project.")
    p.add_argument("--project", action="store_true",
                   help="Project NEW samples into a previously fitted PC "
                        "space: requires --bed-file (new samples), "
                        "--project-loadings and --project-moments.  Writes "
                        "{prefix}.projected.pca.tsv.")
    p.add_argument("--project-loadings", default=None,
                   help="Fitted {prefix}.eigensnp.loadings.tsv to project "
                        "through.")
    p.add_argument("--project-moments", default=None,
                   help="Matching {prefix}.eigensnp.moments.tsv with the "
                        "training standardization moments.")
    return p


def _default(value, fallback):
    return fallback if value is None else value


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    t0 = time.perf_counter()

    threads = args.threads if args.threads is not None else (os.cpu_count() or 1)
    # -t also budgets the native decode/QC/inflate helpers (reference
    # semantics: one knob for all parallel operations, main.rs:103-106).
    from genomic_pca_tpu.io.native import set_default_threads

    set_default_threads(args.threads)

    # Conditional requiredness (main.rs:519-540).
    if args.project:
        # --project is its own dispatch mode: combining it with fit-mode
        # flags would silently ignore the fit (strict conditional flag
        # discipline, matching the reference parser's style).
        conflicting = [
            name
            for name, val in (("--eigensnp", args.eigensnp),
                              ("--vcf-dir", args.vcf_dir),
                              ("-k/--components", args.components))
            if val
        ]
        if conflicting:
            log.error(
                "--project cannot be combined with fit-mode flags "
                "(%s): run the fit and the projection as separate "
                "invocations.", ", ".join(conflicting),
            )
            return 2
        missing = [
            name
            for name, val in (("--bed-file", args.bed_file),
                              ("--project-loadings", args.project_loadings),
                              ("--project-moments", args.project_moments))
            if val is None
        ]
        if missing:
            log.error("%s required when --project is used.", ", ".join(missing))
            return 2
        from genomic_pca_tpu.workflows import run_projection_workflow
        from genomic_pca_tpu.utils.profiling import maybe_trace

        try:
            with maybe_trace(args.profile_dir):
                run_projection_workflow(
                    args.bed_file,
                    args.project_loadings,
                    args.project_moments,
                    args.output_prefix,
                )
        except Exception:
            log.exception("Workflow failed.")
            return 1
        log.info("Total run time: %.3fs", time.perf_counter() - t0)
        return 0

    if args.eigensnp:
        missing = [
            name
            for name, val in (("--bed-file", args.bed_file),
                              ("--ld-block-file", args.ld_block_file))
            if val is None
        ]
        if missing:
            log.error("%s required when --eigensnp is used.", ", ".join(missing))
            return 2
    else:
        missing = [
            name
            for name, val in (("--vcf-dir", args.vcf_dir),
                              ("-k/--components", args.components))
            if val is None
        ]
        if missing:
            log.error("%s required for the VCF workflow.", ", ".join(missing))
            return 2
        # Only the EigenSNP pipeline has stage checkpoints; silently
        # ignoring either flag here would drop the caller's intended
        # preemption-safety / memory bound.
        for flag, val in (
            ("--eigensnp-stop-after-checkpoint",
             args.eigensnp_stop_after_checkpoint),
            ("--eigensnp-checkpoint-dir", args.eigensnp_checkpoint_dir),
        ):
            if val is not None:
                log.error(
                    "%s requires --eigensnp (the VCF/rfit workflow has "
                    "no stage checkpoints).", flag,
                )
                return 2

    from genomic_pca_tpu.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu.workflows import run_eigensnp_workflow, run_vcf_workflow

    from genomic_pca_tpu.utils.profiling import maybe_trace

    try:
        if args.eigensnp:
            prep_cfg = DataPrepConfig(
                bed_path=args.bed_file,
                ld_block_path=args.ld_block_file,
                sample_keep_path=args.eigensnp_sample_keep_file,
                min_call_rate=_default(args.eigensnp_min_call_rate, 0.98),
                min_maf=_default(args.eigensnp_min_maf, 0.01),
                max_hwe_p=_default(args.eigensnp_max_hwe_p, 1e-6),
                snp_chunk_size=_default(args.eigensnp_snp_strip_size, 2000),
                fuse_qc_matrix=not args.eigensnp_no_fuse_qc,
                qc_mode=args.eigensnp_qc_mode,
            )
            algo_cfg = EigenSnpConfig(
                k_global=_default(args.eigensnp_k_global, 10),
                components_per_block=_default(args.eigensnp_components_per_block, 7),
                subset_factor=_default(args.eigensnp_subset_factor, 0.075),
                min_subset_size=_default(args.eigensnp_min_subset_size, 10_000),
                max_subset_size=_default(args.eigensnp_max_subset_size, 40_000),
                global_oversampling=_default(args.eigensnp_global_oversampling, 10),
                global_power_iter=_default(args.eigensnp_global_power_iter, 2),
                local_oversampling=_default(args.eigensnp_local_oversampling, 10),
                local_power_iter=_default(args.eigensnp_local_power_iter, 2),
                seed=_default(args.eigensnp_seed, 2025),
                snp_strip_size=_default(args.eigensnp_snp_strip_size, 2000),
                refine_passes=_default(args.eigensnp_refine_passes, 1),
                refine_width=args.eigensnp_refine_width,
                collect_diagnostics=args.eigensnp_collect_diagnostics,
                diagnostic_block_tag=args.eigensnp_diagnostic_block_tag,
            )
            with maybe_trace(args.profile_dir):
                run_eigensnp_workflow(
                    prep_cfg, algo_cfg, args.output_prefix,
                    checkpoint_dir=args.eigensnp_checkpoint_dir,
                    write_moments=args.write_moments,
                    compile_only=args.eigensnp_compile_only,
                    stop_after_checkpoint=(
                        args.eigensnp_stop_after_checkpoint
                    ),
                )
        else:
            with maybe_trace(args.profile_dir):
                run_vcf_workflow(
                    vcf_dir=args.vcf_dir,
                    output_prefix=args.output_prefix,
                    k=args.components,
                    maf=args.maf,
                    rfit_seed=args.rfit_seed,
                    rfit_tolerance=args.rfit_tolerance,
                    threads=threads,
                )
    except Exception:
        log.exception("Workflow failed.")
        return 1

    log.info("Total run time: %.3fs", time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
