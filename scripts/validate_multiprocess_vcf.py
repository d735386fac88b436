"""REAL multi-process VCF-workflow validation on CPU devices.

Spawns N python processes forming a `jax.distributed` group (CPU
backend, 2 virtual devices each) and runs the FULL VCF workflow with
per-host file sharding — each process parses only the files it owns
(io/vcf.load_vcf_directory_sharded), contributes its rows in place
(ShardedMatrix.from_owned_units segmented assembly), and the rfit PCA
runs shard_map+psum over the global array.  Scores/eigenvalues are
compared against the single-process run of the same directory.

The reference parallelizes per VCF file inside one process
(/root/reference/src/main.rs:171-179); this validates the distributed
form of that strategy (SURVEY §2.3 row 1).

Usage: python scripts/validate_multiprocess_vcf.py [--nproc 2]
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

pid, nproc, port, workdir, repo = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
)
sys.path.insert(0, repo)
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
)
assert jax.process_count() == nproc

# Per-host file sharding must engage: the replicated-parse path would
# have every process read every file.
from genomic_pca_tpu.io import vcf as _vcf

def _no_replicated_parse(*a, **kw):
    raise AssertionError("multi-process VCF run used the replicated parser")

_vcf.load_vcf_directory = _no_replicated_parse

# A layout check: f32 products, so the runs differ only in assembly.
from genomic_pca_tpu.parallel import sharded as _sharded
_sharded.DEFAULT_KERNEL_PRECISION = "f32"

from genomic_pca_tpu.workflows import run_vcf_workflow
run_vcf_workflow(
    f"{workdir}/vcfs", f"{workdir}/mp", k=4, maf=0.01, rfit_seed=29, threads=1
)
print(f"proc {pid} done", flush=True)
"""


def _read_scores(path: str) -> np.ndarray:
    with open(path) as fh:
        header = fh.readline().strip().split("\t")
        k = len(header) - 1
        rows = [line.strip().split("\t")[1:] for line in fh]
    return np.asarray(rows, dtype=np.float64).reshape(len(rows), k)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--port", type=int, default=12975)
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    from tests.conftest import make_genotypes
    from tests.helpers import write_vcf

    rng = np.random.default_rng(5)
    n_variants, n_samples = 900, 56
    geno = make_genotypes(
        rng, n_variants, n_samples, missing_rate=0.0, n_pops=3, fst=0.2
    )
    names = [f"s{i}" for i in range(n_samples)]
    with tempfile.TemporaryDirectory(prefix="gptpu_mpvcf_") as td:
        os.makedirs(f"{td}/vcfs")
        # Three files of uneven size: exercises round-robin ownership
        # with nproc=2 (files 0,2 -> proc 0; file 1 -> proc 1).
        cuts = [0, 420, 620, n_variants]
        for i in range(3):
            write_vcf(
                f"{td}/vcfs/part{i}.vcf",
                geno[cuts[i] : cuts[i + 1]],
                names,
                start_pos=100 + 10_000 * i,
            )

        child = f"{td}/child.py"
        Path(child).write_text(CHILD)
        repo = str(Path(__file__).resolve().parent.parent)
        procs = [
            subprocess.Popen(
                [sys.executable, child, str(p), str(args.nproc),
                 str(args.port), td, repo],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for p in range(args.nproc)
        ]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                print(o[-4000:])
                raise SystemExit(f"child failed rc={p.returncode}")

        mp_scores = _read_scores(f"{td}/mp.vcf.pca.tsv")
        mp_evals = np.loadtxt(
            f"{td}/mp.eigenvalues.tsv", skiprows=1, usecols=1, ndmin=1
        )

        # Single-process reference on the same directory.
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=2"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
        from genomic_pca_tpu.parallel import sharded
        from genomic_pca_tpu.workflows import run_vcf_workflow

        sharded.DEFAULT_KERNEL_PRECISION = "f32"  # as in the children
        run_vcf_workflow(
            f"{td}/vcfs", f"{td}/sp", k=4, maf=0.01, rfit_seed=29, threads=1
        )
        sp_scores = _read_scores(f"{td}/sp.vcf.pca.tsv")
        sp_evals = np.loadtxt(
            f"{td}/sp.eigenvalues.tsv", skiprows=1, usecols=1, ndmin=1
        )

        rs = [
            abs(np.corrcoef(mp_scores[:, j], sp_scores[:, j])[0, 1])
            for j in range(mp_scores.shape[1])
        ]
        ev_err = float(
            np.max(np.abs(mp_evals - sp_evals) / np.maximum(np.abs(sp_evals), 1e-12))
        )
        result = {
            "nproc": args.nproc,
            "n_variants": n_variants,
            "min_score_abs_r": round(min(rs), 6),
            "eigenvalue_max_rel_err": ev_err,
            "pass": bool(min(rs) > 0.999 and ev_err < 1e-3),
        }
        print(json.dumps(result))
        if not result["pass"]:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
