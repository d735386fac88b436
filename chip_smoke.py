"""Smoke test of the main path on an NVIDIA GPU, in one process.

    python chip_smoke.py           # phases (a)-(f) on one GPU
    python chip_smoke.py --four    # phase (d) on a 4-GPU mesh vs 1 GPU

Drives the workflows through their user entry points
(`genomic_pca_tpu.cli.main`, in-process) on data generated from seeds,
and checks every result against a float64 reference:

  (a) EigenSNP CLI, 2,504 samples x 262,144 SNPs, 256 LD blocks, k=10
      (default q8 path, --write-moments, two refinement passes) vs the
      exact float64 PCA.
  (b) The same prepared data through the forced host-streamed container
      vs (a).
  (c) --project of the cohort through (a)'s loadings and moments vs a
      numpy float64 projection.
  (d) Biobank-width EigenSNP CLI, 98,304 SNPs x 49,152 samples, k=40,
      96 blocks, vs the 48-block x 4,096-sample subset oracle.
  (e) VCF CLI, 4 files x 2,504 samples x 40,000 variants, --threads 4
      (spawned parse workers, which must not open the GPU) vs the
      center-only float64 PCA.
  (f) Every product of both containers' layouts (dense int8, packed
      2-bit) in f32, bf16 and q8 at 262,144 x 2,048, L=128, vs the f32
      reference container (ops/stream.StripedMatrix) and the numpy
      quantization model, with compiled memory, device time from a
      profiler trace, and the kernels XLA ran.

Any failing check raises and exits non-zero.  Without a GPU the script
exits non-zero before any phase.  The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PHASES = ("a", "b", "c", "d", "e", "f")

# Data sizes per phase (samples n, SNPs or variants d).
SIZES = {
    "a": dict(d=262_144, n=2_504, k=10, blocks=256, refine=2),
    "d": dict(d=98_304, n=49_152, k=40, blocks=96, sub_blocks=48,
              sub_samples=4_096),
    "e": dict(d=40_000, n=2_504, k=10, files=4),
    "f": dict(d=262_144, n=2_048, ell=128),
}


def phases_for(four: bool):
    """Phases a run executes: all single-GPU phases, or with --four
    only the four-GPU path and what it is compared with."""
    return ("four",) if four else PHASES


def require_gpu(n: int = 1):
    """The JAX devices, or SystemExit when the first is not a GPU or
    there are fewer than `n`."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found {devs[0].platform}"
        )
    if len(devs) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs; JAX found {len(devs)}")
    return devs


def result_line(devices) -> str:
    """The final line: the device as JAX reports it."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, detail) -> None:
    """A phase's pass condition (kept under `python -O`, unlike assert)."""
    if not ok:
        raise AssertionError(detail)


def nvidia_smi(*query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", *query], capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# Comparisons.


def abs_r(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sign-invariant per-column |correlation|."""
    return np.asarray([
        abs(np.corrcoef(a[:, j], b[:, j])[0, 1]) for j in range(a.shape[1])
    ])


def rel_gaps(evals: np.ndarray) -> np.ndarray:
    """Relative gap of each eigenvalue to the next one."""
    ev = np.asarray(evals, np.float64)
    return (ev[:-1] - ev[1:]) / np.maximum(ev[:-1], 1e-300)


def separated_k(evals: np.ndarray, gap: float = 0.02) -> int:
    """Length of the eigengap-separated prefix: the leading PCs whose
    relative gap to the NEXT eigenvalue is at least `gap` (inside a
    near-degenerate eigenspace single PCs may rotate freely).  Pass one
    eigenvalue beyond the PCs compared, so the last one's gap is
    known."""
    small = np.nonzero(rel_gaps(evals) < gap)[0]
    return int(small[0]) if small.size else len(evals) - 1


def prefix_min(r: np.ndarray, sep: int) -> float:
    """Smallest |r| over the separated prefix (NaN, which fails every
    bar, when nothing is separated)."""
    return float(r[:sep].min()) if sep else float("nan")


def rel_frob(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def read_scores(path: Path) -> np.ndarray:
    with open(path) as fh:
        fh.readline()
        return np.asarray(
            [ln.rstrip("\n").split("\t")[1:] for ln in fh], dtype=np.float64
        )


def read_eigenvalues(path: Path) -> np.ndarray:
    return np.loadtxt(path, skiprows=1, usecols=1, ndmin=1)


def cli(*argv: str) -> None:
    from genomic_pca_tpu.cli import main as cli_main

    rc = cli_main([str(a) for a in argv] + ["--log-level", "Warn"])
    check(rc == 0, f"CLI exited {rc}: {argv}")


# ---------------------------------------------------------------------------
# Data.


def make_bed(out_dir: Path, d: int, n: int, n_blocks: int, seed: int) -> str:
    """Structured synthetic PLINK fileset (scripts/biobank_bench.generate:
    64 populations, seeded); returns the BED prefix."""
    sys.path.insert(0, str(REPO / "scripts"))
    from biobank_bench import generate

    generate(out_dir, d, n, n_blocks=n_blocks, seed=seed)
    return str(out_dir / "biobank")


def exact_oracle(prefix: str, moments: Path, k: int, scale: bool = True,
                 strip: int = 8192):
    """Exact float64 PCA over the SNPs a fit kept (its moments file),
    read back from the BED."""
    from genomic_pca_tpu.io.bed import BedReader
    from genomic_pca_tpu.io.writers import read_moments
    from genomic_pca_tpu.models.exact import exact_pca_from_strips

    ids = read_moments(moments)[0]
    bed = BedReader(prefix)
    pos = {sid: i for i, sid in enumerate(bed.bim.sid)}
    rows = np.asarray([pos[v] for v in ids], dtype=np.int64)
    strips = (bed.read(rows[lo: lo + strip]) for lo in range(0, len(rows), strip))
    return exact_pca_from_strips(
        strips, bed.n_samples, k, scale=scale, apply_qc=False
    )


# ---------------------------------------------------------------------------
# Phases.


def phase_a(work: Path) -> dict:
    sz = SIZES["a"]
    d, n, k = sz["d"], sz["n"], sz["k"]
    prefix = make_bed(work / "a", d, n, n_blocks=sz["blocks"], seed=101)
    out = work / "a" / "fit"
    cli("--eigensnp", "--bed-file", prefix,
        "--ld-block-file", work / "a" / "blocks.tsv", "-o", out,
        "--eigensnp-k-global", k, "--eigensnp-max-hwe-p", "1.0",
        # One pass (the reference default) leaves PC10 at |r| ~0.9989
        # in f32 and q8 alike: the algorithm, not the numerics.
        "--eigensnp-refine-passes", sz["refine"],
        "--write-moments")
    scores = read_scores(Path(f"{out}.eigensnp.pca.tsv"))
    evals = read_eigenvalues(Path(f"{out}.eigenvalues.tsv"))
    # k + 1 exact eigenvalues: the gap after PC k decides whether PC k
    # is separated.
    oracle = exact_oracle(prefix, Path(f"{out}.eigensnp.moments.tsv"), k + 1)
    sep = separated_k(oracle.eigenvalues)
    r = abs_r(scores, oracle.scores[:, :k])
    res = {"snps_kept": oracle.n_kept_variants, "separated_k": sep,
           "abs_r": np.round(r, 6).tolist(),
           "oracle_rel_gaps": np.round(rel_gaps(oracle.eigenvalues), 4).tolist(),
           "min_abs_r_separated": prefix_min(r, sep)}
    check(scores.shape == (n, k) and np.isfinite(scores).all()
          and np.isfinite(evals).all(), "non-finite or misshapen output")
    check(prefix_min(r, sep) >= 0.999, res)
    return res


def phase_b(work: Path) -> dict:
    from genomic_pca_tpu.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu.models.eigensnp import compute_eigensnp_pca
    from genomic_pca_tpu.models.prepare import prepare_data

    out = work / "a" / "fit"
    cfg = DataPrepConfig(
        bed_path=str(work / "a" / "biobank"),
        ld_block_path=str(work / "a" / "blocks.tsv"), max_hwe_p=1.0,
    )
    ecfg = EigenSnpConfig(k_global=SIZES["a"]["k"],
                          refine_passes=SIZES["a"]["refine"])
    res = compute_eigensnp_pca(prepare_data(cfg), ecfg, force_streaming=True)
    scores_a = read_scores(Path(f"{out}.eigensnp.pca.tsv"))
    evals_a = read_eigenvalues(Path(f"{out}.eigenvalues.tsv"))
    sep = separated_k(evals_a)
    r = abs_r(res.scores, scores_a)
    ev_err = np.abs(res.eigenvalues - evals_a) / np.abs(evals_a)
    out_d = {"separated_k": sep, "min_abs_r_separated": prefix_min(r, sep),
             "eigenvalue_max_rel_err": float(ev_err.max())}
    check(prefix_min(r, sep) >= 0.999, out_d)
    check(ev_err.max() <= 1e-2, out_d)
    return out_d


def phase_c(work: Path) -> dict:
    from genomic_pca_tpu.io.bed import BedReader
    from genomic_pca_tpu.io.writers import read_loadings, read_moments

    fit = work / "a" / "fit"
    out = work / "a" / "proj"
    cli("--project", "--bed-file", work / "a" / "biobank",
        "--project-loadings", f"{fit}.eigensnp.loadings.tsv",
        "--project-moments", f"{fit}.eigensnp.moments.tsv", "-o", out)
    got = read_scores(Path(f"{out}.projected.pca.tsv"))
    ids, w = read_loadings(f"{fit}.eigensnp.loadings.tsv")
    _ids, _a1, _a2, mean, std = read_moments(f"{fit}.eigensnp.moments.tsv")
    bed = BedReader(str(work / "a" / "biobank"))
    pos = {sid: i for i, sid in enumerate(bed.bim.sid)}
    rows = np.asarray([pos[v] for v in ids], dtype=np.int64)
    inv = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 0.0)
    ref = np.zeros((bed.n_samples, w.shape[1]))
    for lo in range(0, len(rows), 8192):
        g = bed.read(rows[lo: lo + 8192])
        x = (g.astype(np.float64) - mean[lo: lo + 8192, None]) * inv[lo: lo + 8192, None]
        ref += np.where(g != -127, x, 0.0).T @ w[lo: lo + 8192]
    err = rel_frob(got, ref)
    res = {"rel_frobenius_err": err, "min_abs_r": float(abs_r(got, ref).min())}
    check(got.shape == ref.shape and err <= 1e-4, res)
    return res


def phase_d(work: Path, four: bool = False) -> dict:
    sz = SIZES["d"]
    d, n, k = sz["d"], sz["n"], sz["k"]
    prefix = make_bed(work / "d", d, n, n_blocks=sz["blocks"], seed=7)
    out = work / "d" / "fit"
    cli("--eigensnp", "--bed-file", prefix,
        "--ld-block-file", work / "d" / "blocks.tsv", "-o", out,
        "--eigensnp-k-global", k, "--eigensnp-max-hwe-p", "1.0")
    scores = read_scores(Path(f"{out}.eigensnp.pca.tsv"))
    evals = read_eigenvalues(Path(f"{out}.eigenvalues.tsv"))
    check(scores.shape == (n, k) and np.isfinite(scores).all(),
          "non-finite or misshapen output")
    if four:
        return four_compare(work, scores, evals, k)
    from biobank_bench import subset_oracle

    orc = subset_oracle(work / "d", k=k, n_sub_blocks=sz["sub_blocks"],
                        n_sub_samples=sz["sub_samples"])
    res = {key: orc[key] for key in (
        "subset_snps", "subset_samples", "well_separated_k",
        "per_pc_abs_r_min_separated", "per_pc_abs_r_min",
        "subspace_min_principal_cosine_separated",
    )}
    check(orc["per_pc_abs_r_min_separated"] >= 0.99, res)
    return res


def four_compare(work: Path, scores4, evals4, k: int) -> dict:
    """(d) on all four GPUs (the CLI's default mesh) vs the same run on
    one GPU of that mesh, and the streamed container's round-robin over
    the four vs the resident result."""
    import jax

    from genomic_pca_tpu.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu.models.eigensnp import compute_eigensnp_pca
    from genomic_pca_tpu.models.prepare import prepare_data
    from genomic_pca_tpu.parallel.mesh import make_mesh

    cfg = DataPrepConfig(
        bed_path=str(work / "d" / "biobank"),
        ld_block_path=str(work / "d" / "blocks.tsv"), max_hwe_p=1.0,
    )
    ecfg = EigenSnpConfig(k_global=k)
    one = compute_eigensnp_pca(
        prepare_data(cfg), ecfg, mesh=make_mesh(jax.devices()[:1])
    )
    sep = separated_k(one.eigenvalues)
    r1 = abs_r(scores4, one.scores)
    e1 = np.abs(evals4 - one.eigenvalues) / np.abs(one.eigenvalues)
    streamed = compute_eigensnp_pca(prepare_data(cfg), ecfg,
                                    force_streaming=True)
    rs = abs_r(streamed.scores, scores4)
    es = np.abs(streamed.eigenvalues - evals4) / np.abs(evals4)
    res = {
        "devices": len(jax.devices()), "separated_k": sep,
        "four_vs_one_min_abs_r_separated": prefix_min(r1, sep),
        "four_vs_one_eigenvalue_max_rel_err": float(e1.max()),
        "streamed_vs_four_min_abs_r_separated": prefix_min(rs, sep),
        "streamed_vs_four_eigenvalue_max_rel_err": float(es.max()),
    }
    check(prefix_min(r1, sep) >= 0.999 and e1.max() <= 1e-3, res)
    check(prefix_min(rs, sep) >= 0.999 and es.max() <= 1e-2, res)
    return res


def write_vcfs(vcf_dir: Path, geno: np.ndarray, n_files: int) -> None:
    """GT-only VCFs, `geno` (variants, samples) split over n_files."""
    vcf_dir.mkdir(parents=True, exist_ok=True)
    n = geno.shape[1]
    table = np.frombuffer(b"0/0\t0/1\t1/1\t", np.uint8).reshape(3, 4)
    header = (
        "##fileformat=VCFv4.2\n"
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"s{i}" for i in range(n)) + "\n"
    ).encode()
    for f, part in enumerate(np.array_split(geno, n_files)):
        with open(vcf_dir / f"chunk{f}.vcf", "wb") as fh:
            fh.write(header)
            for lo in range(0, part.shape[0], 1024):
                body = table[part[lo: lo + 1024]].reshape(-1, 4 * n)
                body[:, -1] = ord("\n")
                for i, row in enumerate(body):
                    pos = 1_000_000 * f + lo + i + 1
                    fh.write(f"22\t{pos}\t.\tA\tC\t.\tPASS\t.\tGT\t".encode())
                    fh.write(row.tobytes())


def phase_e(work: Path) -> dict:
    from genomic_pca_tpu.models.exact import exact_pca_from_strips

    sz = SIZES["e"]
    d, n, k = sz["d"], sz["n"], sz["k"]
    # Balding-Nichols populations with geometrically decaying drift, so
    # the structure PCs have distinct eigenvalues.
    rng = np.random.default_rng(23)
    fst = 0.2 * 0.7 ** np.arange(8)
    anc = rng.uniform(0.05, 0.95, (d, 1))
    freqs = rng.beta(anc * (1 - fst) / fst, (1 - anc) * (1 - fst) / fst)
    pop = rng.integers(0, len(fst), n)
    geno = rng.binomial(2, freqs[:, pop]).astype(np.int8)
    write_vcfs(work / "e" / "vcfs", geno, n_files=sz["files"])

    seen: set = set()
    stop = threading.Event()

    def poll():  # which processes hold the GPU while the workers parse
        while not stop.is_set():
            out = nvidia_smi("--query-compute-apps=pid", "--format=csv,noheader")
            seen.update(p.strip() for p in out.splitlines() if p.strip())
            stop.wait(0.5)

    watcher = threading.Thread(target=poll, daemon=True)
    watcher.start()
    try:
        out = work / "e" / "fit"
        cli("-d", work / "e" / "vcfs", "-o", out, "-k", k,
            "--rfit-seed", 11, "--threads", 4)
    finally:
        stop.set()
        watcher.join()
    scores = read_scores(Path(f"{out}.vcf.pca.tsv"))
    p = geno.mean(axis=1) / 2.0
    keep = np.minimum(p, 1 - p) >= 0.01  # the workflow's MAF filter
    oracle = exact_pca_from_strips(
        [geno[keep]], n, k + 1, scale=False, apply_qc=False
    )
    sep = separated_k(oracle.eigenvalues)
    r = abs_r(scores, oracle.scores[:, :k])
    res = {"variants_kept": int(keep.sum()), "separated_k": sep,
           "oracle_rel_gaps": np.round(rel_gaps(oracle.eigenvalues), 4).tolist(),
           "min_abs_r_separated": prefix_min(r, sep),
           "gpu_pids_seen": sorted(seen), "own_pid": os.getpid()}
    check(prefix_min(r, sep) >= 0.999, res)
    check(len(seen) <= 1, res)  # no parse worker opened the GPU
    return res


def trace_report(fn, n_calls: int) -> dict:
    """Device ms per call of `fn` from a profiler trace, and the device
    events (kernels) that took the most time."""
    import jax

    from genomic_pca_tpu.utils import xplane

    jax.block_until_ready(fn())  # compiled and warm
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(n_calls):
                out = fn()
            jax.block_until_ready(out)
        ms, n_events, err = xplane.device_busy_ms(td)
        ops, _ = xplane.device_op_table(td, top=6)
    return {
        "device_busy_ms_per_call": None if ms is None else ms / n_calls,
        "events": n_events, "trace_err": err,
        "top_events_ms": [(name[:90], round(t, 4), c) for name, t, c in ops or ()],
    }


def memory_report(jitted, *args, **kw) -> dict:
    """The compiled program's memory: its temporaries show whether a
    standardized strip is written to device memory."""
    ma = jitted.lower(*args, **kw).compile().memory_analysis()
    return {
        key: getattr(ma, key, None) for key in (
            "temp_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes",
        )
    }


def phase_f(work: Path) -> dict:
    import jax
    import jax.numpy as jnp

    from genomic_pca_tpu.ops import products
    from genomic_pca_tpu.ops.rsvd import quantize_basis
    from genomic_pca_tpu.ops.stream import StripedMatrix
    from genomic_pca_tpu.parallel.mesh import make_mesh
    from genomic_pca_tpu.parallel.sharded import ShardedMatrix, pack_int8_rows

    d, n, ell = SIZES["f"]["d"], SIZES["f"]["n"], SIZES["f"]["ell"]
    rng = np.random.default_rng(5)
    g = rng.integers(0, 3, (d, n), dtype=np.int8)
    g[rng.integers(0, 100, (d, n), dtype=np.uint8) == 0] = -127
    valid = g != -127
    cnt = valid.sum(axis=1)
    s1 = np.where(valid, g, 0).sum(axis=1, dtype=np.int64)
    s2 = np.where(valid, g.astype(np.int16) ** 2, 0).sum(axis=1, dtype=np.int64)
    mean = (s1 / cnt).astype(np.float32)
    std = np.sqrt((s2 - cnt * mean.astype(np.float64) ** 2) / (cnt - 1)).astype(np.float32)
    b = jnp.asarray(rng.standard_normal((n, ell)), jnp.float32)

    ref = StripedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                    strip_size=8192)
    want = {
        "gram": np.asarray(ref.gram_apply(b)),
        "tsq": np.asarray(ref.tsq_accumulate(b)),
        "right": ref.right_apply(b),
    }
    del ref
    packed_rows = pack_int8_rows(g)
    mesh = make_mesh(jax.devices()[:1])
    bound = {"f32": 1e-5, "bf16": 2e-2, "q8": 2e-2}
    out = {}
    for layout in ("dense", "packed"):
        for prec in ("f32", "bf16", "q8"):
            if layout == "dense":
                sm = ShardedMatrix.from_arrays(
                    iter([g]), means=[mean], stds=[std], mesh=mesh,
                    kernel_precision=prec,
                )
            else:
                sm = ShardedMatrix.from_packed_rows(
                    packed_rows, mean, std, n, mesh=mesh,
                    kernel_precision=prec,
                )
            args = (sm.geno, sm.mean, sm.inv_std)
            got = {
                "gram": sm.gram_apply(b), "tsq": sm.tsq_accumulate(b),
                "right": sm.right_apply(b),
            }
            row = {p: rel_frob(got[p], want[p]) for p in got}
            row["memory_gram"] = memory_report(sm._gram_k, *args, b)
            row["trace_gram"] = trace_report(lambda: sm.gram_apply(b), 4)
            row["trace_tsq"] = trace_report(lambda: sm.tsq_accumulate(b), 4)
            row["trace_right"] = trace_report(
                lambda: sm._right_k(*args, b), 4
            )
            if prec == "q8":
                bp = jnp.zeros((sm.n_pad, ell), jnp.float32).at[:n].set(b)
                bq, sb, csum = quantize_basis(bp)
                u = sm.mean * sm.inv_std

                def q8_pass():
                    return products.gram_q8(
                        sm.geno, sm.inv_std, u, bq, sb, csum, step=sm.step
                    )

                g_model = np.zeros((sm.d_pad, sm.n_pad), np.int8)
                g_model[:d, :n] = np.maximum(g, 0)
                q_ref = products.gram_q8_reference(
                    g_model, np.asarray(sm.inv_std), np.asarray(u),
                    np.asarray(bq), np.asarray(sb)[0, 0], sm.step,
                )
                row["gram_q8_vs_model"] = rel_frob(q8_pass(), q_ref)
                row["memory_gram_q8"] = memory_report(
                    products.gram_q8, sm.geno, sm.inv_std, u, bq, sb, csum,
                    step=sm.step,
                )
                row["trace_gram_q8"] = trace_report(q8_pass, 4)
                check(row["gram_q8_vs_model"] <= 1e-3, (layout, prec, row))
            out[f"{layout}_{prec}"] = row
            log(f"  (f) {layout} {prec}: " + json.dumps(row, default=str))
            for p in ("gram", "tsq", "right"):
                check(row[p] <= bound[prec], (layout, prec, p, row[p]))
            del sm
    return {key: {p: v[p] for p in ("gram", "tsq", "right")}
            for key, v in out.items()}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only phase (d) on four GPUs vs one")
    args = ap.parse_args(argv)

    devices = require_gpu(4 if args.four else 1)
    log(f"gpu: {nvidia_smi('--query-gpu=name,power.limit', '--format=csv,noheader')}")
    log("env: " + json.dumps({
        k: os.environ.get(k) for k in (
            "XLA_FLAGS", "XLA_PYTHON_CLIENT_MEM_FRACTION",
            "XLA_PYTHON_CLIENT_PREALLOCATE", "XLA_PYTHON_CLIENT_ALLOCATOR",
            "JAX_COMPILATION_CACHE_DIR",
        )
    }))
    sys.path.insert(0, str(REPO))
    from genomic_pca_tpu.io.native import get_lib
    from genomic_pca_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    log(f"native host library: {'loaded' if get_lib() else 'unavailable'}")

    run = {
        "a": phase_a, "b": phase_b, "c": phase_c, "d": phase_d,
        "e": phase_e, "f": phase_f,
        "four": lambda w: phase_d(w, four=True),
    }
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        for name in phases_for(args.four):
            t0 = time.perf_counter()
            res = run[name](Path(td))
            log(f"phase ({name}) ok in {time.perf_counter() - t0:.1f}s: "
                + json.dumps(res, default=str))
    log(f"all phases ok in {time.perf_counter() - t_all:.1f}s")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
