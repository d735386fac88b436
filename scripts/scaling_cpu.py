"""Mesh-scaling measurement on virtual CPU devices.

Runs the sharded power-iteration pass over 1/2/4/8-device meshes
(XLA host-platform virtual devices) and reports SNPs/sec per mesh size —
a functional proxy for the 1 chip -> 1 host -> N hosts scaling ladder in
BASELINE.md (real multi-chip hardware is exercised by the driver's
`dryrun_multichip`).  On CPU the virtual devices share physical cores, so
the measurement validates *sharding overhead* (collectives, padding), not
parallel speedup.

Usage: python scripts/scaling_cpu.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main() -> int:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")

    from genomic_pca_tpu.parallel.mesh import make_mesh
    from genomic_pca_tpu.parallel.sharded import ShardedMatrix

    rng = np.random.default_rng(0)
    d, n, ell = 65536, 512, 32
    geno = rng.integers(0, 3, size=(d, n), dtype=np.int8)
    b = jnp.asarray(rng.standard_normal((n, ell)).astype(np.float32))

    results = {}
    ref = None
    for n_dev in (1, 2, 4, 8):
        mesh = make_mesh(jax.devices()[:n_dev])
        sm = ShardedMatrix.from_arrays(iter([geno]), mesh=mesh)
        out = np.asarray(sm.power_iterate(b, 2))  # warm-up/compile
        t0 = time.perf_counter()
        out = np.asarray(sm.power_iterate(b, 8))
        dt = time.perf_counter() - t0
        results[n_dev] = round(d * 8 / dt / 1e6, 2)
        if ref is None:
            ref = out
        else:
            # same result at every mesh size (up to f32 reduction order)
            for j in range(min(4, out.shape[1])):
                r = abs(np.corrcoef(out[:, j], ref[:, j])[0, 1])
                assert r > 0.999, (n_dev, j, r)

    proc_results = measure_process_scaling()
    print(json.dumps({
        "msnps_per_sec_by_mesh_size": results,
        "msnps_per_sec_by_process_count": proc_results,
    }))
    return 0


_PROC_CHILD = r"""
import os, sys, time
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
if nproc > 1:
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=nproc,
        process_id=pid,
    )
import json
import numpy as np
import jax.numpy as jnp
from genomic_pca_tpu.config import DataPrepConfig
from genomic_pca_tpu.models.prepare import prepare_data

t0 = time.perf_counter()
cfg = DataPrepConfig(
    bed_path=f"{workdir}/sc", ld_block_path=f"{workdir}/blocks.tsv",
    min_call_rate=0.5, min_maf=0.0, max_hwe_p=1.0,
    snp_chunk_size=4096, distributed_qc=True,
)
prep = prepare_data(cfg)
sm = prep.load_matrix()
rng = np.random.default_rng(0)
b = jnp.asarray(rng.standard_normal((prep.n_samples, 32)).astype(np.float32))
_ = np.asarray(sm.power_iterate(b, 2))  # warm-up/compile
t1 = time.perf_counter()
_ = np.asarray(sm.power_iterate(b, 8))
dt = time.perf_counter() - t1
if pid == 0:
    with open(f"{workdir}/scale_{nproc}.json", "w") as fh:
        json.dump({
            "msnps_per_sec": round(prep.n_pca_snps * 8 / dt / 1e6, 2),
            "pipeline_seconds": round(t1 - t0, 2),
            "n_pca_snps": prep.n_pca_snps,
        }, fh)
"""


def measure_process_scaling(counts=(1, 2, 4), port0: int = 13240) -> dict:
    """SNPs/sec of the distributed pipeline at REAL process counts.

    Spawns actual `jax.distributed` groups (2 virtual CPU devices per
    process) running QC -> per-process loading -> the sharded power
    pass, and reports M-SNPs/sec per process count — the process-count
    axis of BASELINE.md's scaling ladder.  On one shared CPU the number
    validates cross-process overhead (coordination, allgather,
    non-addressable arrays), not parallel speedup.
    """
    import subprocess
    import tempfile

    from genomic_pca_tpu.io.bed import write_plink

    rng = np.random.default_rng(3)
    d, n = 16384, 64
    thresh = rng.integers(8, 128, size=(d, 1), dtype=np.uint8)
    r1 = rng.integers(0, 256, size=(d, n), dtype=np.uint8)
    r2 = rng.integers(0, 256, size=(d, n), dtype=np.uint8)
    geno = ((r1 < thresh).astype(np.int8) + (r2 < thresh)).astype(np.int8)

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="gptpu_scale_") as td:
        write_plink(f"{td}/sc", geno, bp=list(range(10, d * 10 + 10, 10)))
        with open(f"{td}/blocks.tsv", "w") as fh:
            edges = np.linspace(0, d * 10 + 20, 9, dtype=np.int64)
            for i in range(8):
                fh.write(f"1 {edges[i] + 1} {edges[i + 1]}\n")
        child = f"{td}/child.py"
        Path(child).write_text(_PROC_CHILD)
        repo = str(Path(__file__).resolve().parent.parent)
        for idx, nproc in enumerate(counts):
            procs = [
                subprocess.Popen(
                    [sys.executable, child, str(p), str(nproc),
                     str(port0 + idx), td, repo],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                for p in range(nproc)
            ]
            outs = [p.communicate(timeout=560)[0] for p in procs]
            for p, o in zip(procs, outs):
                if p.returncode != 0:
                    print(o[-3000:], file=sys.stderr)
                    raise SystemExit(f"scaling child failed rc={p.returncode}")
            with open(f"{td}/scale_{nproc}.json") as fh:
                out[nproc] = json.load(fh)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
