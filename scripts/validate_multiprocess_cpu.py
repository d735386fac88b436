"""REAL multi-process validation on CPU devices.

Spawns N python processes that form a `jax.distributed` process group
(CPU backend, 2 virtual devices each), run the FULL EigenSNP pipeline —
distributed QC scan (+allgather), per-process BED row-range loading
(`ShardedMatrix.from_local_rows` + `make_array_from_process_local_data`),
shard_map+psum compute — over a shared synthetic PLINK fileset, and
compare scores/eigenvalues/loadings against the single-process run.

This exercises the actual multi-host code paths (process groups, global
arrays, cross-process collectives) that `dryrun_multichip` can only
approximate with a single-process virtual mesh.

Usage: python scripts/validate_multiprocess_cpu.py [--nproc 2]
Exit code 0 + one JSON line on success.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CHILD = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)
import jax
jax.config.update("jax_platforms", "cpu")

pid, nproc, port, workdir, repo, qc_mode = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
    sys.argv[6],
)
sys.path.insert(0, repo)
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
)
assert jax.process_count() == nproc

import numpy as np
from genomic_pca_tpu.config import DataPrepConfig, EigenSnpConfig
from genomic_pca_tpu.models.eigensnp import compute_eigensnp_pca
from genomic_pca_tpu.models.prepare import prepare_data
from genomic_pca_tpu.parallel import sharded as _sharded

cfg = DataPrepConfig(
    bed_path=f"{workdir}/mh", ld_block_path=f"{workdir}/blocks.tsv",
    min_call_rate=0.5, min_maf=0.01, max_hwe_p=1e-6,
    snp_chunk_size=64, qc_device_batch=128, distributed_qc=True,
    qc_mode=qc_mode,
)
prep = prepare_data(cfg)
assert prep.scan_ranges is not None and len(prep.scan_ranges) == nproc

if qc_mode == "host":
    # Host scan: no device uploads during QC; each process uploads only
    # its survivors as raw 2-bit bytes (from_local_rows packed=True).
    assert prep.qc_capture is None, "host scan must not capture"
    sm = prep.load_matrix()
    assert sm.packed, "multi-process packed load did not engage"
else:
    # The fused multi-process assembly must engage: the QC scan captured
    # this process's device batches, and matrix load must NOT fall back
    # to the BED re-read path (from_local_rows).
    assert prep.qc_capture is not None, "QC capture did not engage"

    def _no_reread(*a, **kw):
        raise AssertionError("fused path fell back to from_local_rows")

    _sharded.ShardedMatrix.from_local_rows = staticmethod(_no_reread)

ecfg = EigenSnpConfig(
    k_global=4, components_per_block=3, min_subset_size=48,
    max_subset_size=48, subset_factor=0.6, seed=7,
)
res = compute_eigensnp_pca(prep, ecfg)
if pid == 0:
    np.savez(
        f"{workdir}/mh_out.npz",
        scores=res.scores,
        eigenvalues=res.eigenvalues,
        loadings=res.loadings,
        pca_orig=prep.pca_snp_orig_indices,
    )
print(f"proc {pid} done", flush=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--port", type=int, default=12931)
    ap.add_argument(
        "--qc-mode", default="auto", choices=("auto", "host", "device"),
        help="QC scan placement for the children (host = per-range mmap "
        "counts + packed survivor upload; auto/device = device scan "
        "with LD-aligned capture fusion)",
    )
    ap.add_argument(
        "--degenerate-tail", action="store_true",
        help="Make the last LD block's SNPs monomorphic so the last "
        "process's scan range has ZERO post-QC survivors — the "
        "zero-row-owner edge of the segmented assembly / per-process "
        "loading.",
    )
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    from genomic_pca_tpu.io.bed import write_plink
    from tests.conftest import make_genotypes

    rng = np.random.default_rng(11)
    n_snps, n_samples = 600, 64
    geno = make_genotypes(rng, n_snps, n_samples, missing_rate=0.01,
                          n_pops=3, fst=0.2)
    if args.degenerate_tail:
        # Monomorphic tail: fails the variance/MAF gates, so every SNP
        # in the last block (the last process's whole range under
        # block-aligned partitioning) is dropped by QC.
        geno[3 * n_snps // 4 :] = 0
    with tempfile.TemporaryDirectory(prefix="gptpu_mh_") as td:
        write_plink(f"{td}/mh", geno, bp=list(range(10, n_snps * 10 + 10, 10)))
        with open(f"{td}/blocks.tsv", "w") as fh:
            edges = np.linspace(0, n_snps * 10 + 20, 5, dtype=np.int64)
            for i in range(4):
                fh.write(f"1 {edges[i]+1} {edges[i+1]}\n")

        child = f"{td}/child.py"
        Path(child).write_text(CHILD)
        repo = str(Path(__file__).resolve().parent.parent)
        procs = [
            subprocess.Popen(
                [sys.executable, child, str(p), str(args.nproc),
                 str(args.port), td, repo, args.qc_mode],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for p in range(args.nproc)
        ]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                print(o[-4000:])
                raise SystemExit(f"child failed rc={p.returncode}")

        mh = np.load(f"{td}/mh_out.npz")

        # Single-process reference (same config, same seed).
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=2"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
        from genomic_pca_tpu.config import DataPrepConfig, EigenSnpConfig
        from genomic_pca_tpu.models.eigensnp import compute_eigensnp_pca
        from genomic_pca_tpu.models.prepare import prepare_data

        cfg = DataPrepConfig(
            bed_path=f"{td}/mh", ld_block_path=f"{td}/blocks.tsv",
            min_call_rate=0.5, min_maf=0.01, max_hwe_p=1e-6,
            snp_chunk_size=64, qc_device_batch=128,
        )
        prep = prepare_data(cfg)
        ecfg = EigenSnpConfig(
            k_global=4, components_per_block=3, min_subset_size=48,
            max_subset_size=48, subset_factor=0.6, seed=7,
        )
        ref = compute_eigensnp_pca(prep, ecfg)

        assert np.array_equal(mh["pca_orig"], prep.pca_snp_orig_indices), (
            "distributed QC selected different SNPs than the serial scan"
        )
        k = ref.scores.shape[1]
        rs = []
        for j in range(k):
            r = np.corrcoef(mh["scores"][:, j], ref.scores[:, j])[0, 1]
            rs.append(abs(r))
        ev_err = float(
            np.max(
                np.abs(mh["eigenvalues"] - ref.eigenvalues)
                / np.maximum(np.abs(ref.eigenvalues), 1e-12)
            )
        )
        load_r = []
        for j in range(k):
            r = np.corrcoef(mh["loadings"][:, j], ref.loadings[:, j])[0, 1]
            load_r.append(abs(r))
        result = {
            "nproc": args.nproc,
            "n_pca_snps": int(len(prep.pca_snp_orig_indices)),
            "min_score_abs_r": round(min(rs), 6),
            "min_loading_abs_r": round(min(load_r), 6),
            "eigenvalue_max_rel_err": ev_err,
            "pass": bool(min(rs) > 0.999 and min(load_r) > 0.999
                         and ev_err < 1e-3),
        }
        print(json.dumps(result))
        if not result["pass"]:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
