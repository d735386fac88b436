"""Benchmark: standardized-genotype PCA throughput on one GPU.

`--biobank` runs the FULL biobank configuration instead (1M SNPs x
102k samples, k=40 — the BASELINE.md biobank config) via
scripts/biobank_bench.py and prints ITS JSON line.  The default run
includes a compact biobank e2e (wide-N k=40) in `detail`.

Measures the hot loop of the framework — the quantized int8
power-iteration pass (A^T A B) through the PRODUCTION container layout:
PLINK 2-bit packed genotypes resident in device memory (the shape the
EigenSNP pipeline actually runs).  The headline `value` is the
TRACE-DERIVED on-device rate (device busy time per iteration from a
profiler trace); the host-clock marginal rate is kept in
`detail.marginal_snps_per_sec`.  The dense-int8 q8 rate and the bf16
exact rate are reported alongside in `detail`.  Without a GPU the
bench refuses to run.
`vs_baseline` compares
against the reference's own numeric strategy measured on this host: the
numpy f64 Gram accumulation of its exact-PCA oracle
(/root/reference/tests/pca.py:109-111), scaled from a small timed
sample.  (The reference publishes no numbers of its own — BASELINE.md.)

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _host_dosages(rng, n_snps: int, n_samples: int) -> np.ndarray:
    """Small host-side synthetic dosage block (same Bernoulli scheme)."""
    thresh = rng.integers(8, 128, size=(n_snps, 1), dtype=np.uint8)
    r1 = rng.integers(0, 256, size=(n_snps, n_samples), dtype=np.uint8)
    r2 = rng.integers(0, 256, size=(n_snps, n_samples), dtype=np.uint8)
    return ((r1 < thresh).astype(np.int8) + (r2 < thresh)).astype(np.int8)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from genomic_pca_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from jax.sharding import NamedSharding, PartitionSpec as P

    from genomic_pca_tpu.parallel.mesh import VARIANT_AXIS, make_mesh
    from genomic_pca_tpu.parallel.sharded import ShardedMatrix

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX's first device is {platform}."
        )

    # Problem size: biobank-shaped strip stream resident in device
    # memory.  ell = 128 is the PRODUCTION sketch width:
    # models/pca.lane_fill_width widens every hot-loop sketch (rfit and
    # the EigenSNP refinement) to 128 columns.
    n_samples = 2048
    n_snps = 262_144
    ell = 128

    rng = np.random.default_rng(0)

    # Synthetic dosages generated ON DEVICE: two Bernoulli draws via
    # integer thresholds (the frequency spectrum doesn't affect
    # throughput) plus exact device-side moments.  Avoids uploading the
    # 512 MB int8 block from the host.  The packed (2-bit)
    # variant re-encodes the same dosages to PLINK codes on device.
    @jax.jit
    def make_data(key):
        k1, k2, k3 = jax.random.split(key, 3)
        thresh = jax.random.randint(k1, (n_snps, 1), 8, 128, dtype=jnp.int32)
        r1 = jax.random.randint(k2, (n_snps, n_samples), 0, 256, jnp.int32)
        r2 = jax.random.randint(k3, (n_snps, n_samples), 0, 256, jnp.int32)
        g = ((r1 < thresh).astype(jnp.int8) + (r2 < thresh)).astype(jnp.int8)
        n1 = jnp.sum(g == 1, axis=1, dtype=jnp.float32)
        n2 = jnp.sum(g == 2, axis=1, dtype=jnp.float32)
        mean = (n1 + 2.0 * n2) / n_samples
        ssd = (n1 + 4.0 * n2) - n_samples * mean * mean
        std = jnp.sqrt(jnp.maximum(ssd / (n_samples - 1), 0.0))
        inv = jnp.where(std > 0, 1.0 / jnp.where(std > 0, std, 1.0), 0.0)
        return g, mean[:, None], inv[:, None]

    from genomic_pca_tpu.parallel.sharded import pack_codes_device as pack_codes

    mesh = make_mesh(jax.devices()[:1])
    sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
    g_dev, mean_dev, inv_dev = make_data(jax.random.key(0))

    def container(geno, **kw):
        return ShardedMatrix(
            geno=jax.device_put(geno, sh),
            mean=jax.device_put(mean_dev, sh),
            inv_std=jax.device_put(inv_dev, sh),
            n_rows=n_snps,
            n_samples=n_samples,
            mesh=mesh,
            **kw,
        )

    b = jnp.asarray(rng.standard_normal((n_samples, ell)), dtype=jnp.float32)
    flops_per_iter = 4.0 * n_snps * n_samples * ell  # 2 matmuls x 2 flop/MAC

    # Steady-state device throughput via MARGINAL cost: time the same
    # single-dispatch loop at two iteration counts and take the slope,
    # which cancels the fixed dispatch + fetch cost of a call.
    # Warm-up compiles the EXACT programs to be timed (n_iter is a
    # static argument).
    it_lo, it_hi = 64, 192

    def measure(sm):
        """sec/iteration with a noise guard: a noisy sample can push the
        slope to <= 0 or past the direct per-iteration time, so fall
        back to the (overhead-inclusive, conservative) direct rate when
        the slope is not in (0, 1.2x direct]."""
        _ = np.asarray(sm.power_iterate(b, it_lo))
        _ = np.asarray(sm.power_iterate(b, it_hi))

        def _best(n_iter: int) -> float:
            dt = float("inf")
            for _rep in range(3):
                t0 = time.perf_counter()
                out = sm.power_iterate(b, n_iter)  # whole loop, 1 dispatch
                _ = np.asarray(out)
                dt = min(dt, time.perf_counter() - t0)
            return dt

        hi = _best(it_hi)
        slope = (hi - _best(it_lo)) / (it_hi - it_lo)
        direct = hi / it_hi
        if not (0.0 < slope <= 1.2 * direct):
            return direct, "direct_fallback"
        return slope, "marginal"

    def trace_ms_per_iter(sm, tag: str):
        """Trace-derived ON-DEVICE ms/iter: capture one dispatched
        power loop under jax.profiler and read the device busy time from
        the trace (the marginal-cost wall-clock above is the marginal
        HOST cost).
        """
        import shutil
        import tempfile

        from genomic_pca_tpu.utils.xplane import device_busy_ms

        n_tr = it_lo
        _ = np.asarray(sm.power_iterate(b, n_tr))  # warm the program
        td = tempfile.mkdtemp(prefix=f"gptpu_bench_trace_{tag}_")
        try:
            with jax.profiler.trace(td):
                _ = np.asarray(sm.power_iterate(b, n_tr))
            mod_ms, _n, err = device_busy_ms(td)
            if mod_ms is None:
                return None, err
            return mod_ms / n_tr, None
        except Exception as e:  # trace capture must never sink the bench
            return None, str(e)
        finally:
            shutil.rmtree(td, ignore_errors=True)

    # PRODUCTION layout (headline): 2-bit packed + q8 int8 loop.
    sm_packed = container(pack_codes(g_dev), kernel_precision="q8")
    dt_packed, how_packed = measure(sm_packed)
    tr_packed, tr_err = trace_ms_per_iter(sm_packed, "packed_q8")
    # Dense int8 + q8, and the exact bf16 path, for the detail row.
    sm_dense = container(g_dev, kernel_precision="q8")
    dt_dense, how_dense = measure(sm_dense)
    tr_dense, _ = trace_ms_per_iter(sm_dense, "dense_q8")
    sm_bf16 = container(g_dev, kernel_precision="bf16")
    dt_bf16, how_bf16 = measure(sm_bf16)
    tr_bf16, _ = trace_ms_per_iter(sm_bf16, "dense_bf16")

    # HEADLINE value: the trace-derived ON-DEVICE rate.  The marginal
    # wall-clock rate stays in `detail` as the overhead-inclusive view;
    # it is also the fallback when trace capture is unavailable.
    marginal_snps_per_sec = n_snps / dt_packed
    if tr_packed is not None:
        snps_per_sec = n_snps / (tr_packed * 1e-3)
        value_method = "trace_device_time"
    else:
        snps_per_sec = marginal_snps_per_sec
        value_method = f"wall_clock_{how_packed}"
    tflops_packed = flops_per_iter / dt_packed / 1e12

    # Compact EigenSNP end-to-end measurement (QC -> two-stage PCA) on a
    # small synthetic PLINK fileset, for the e2e SNPs/sec view.
    e2e = {}
    try:
        import tempfile

        from genomic_pca_tpu.config import DataPrepConfig, EigenSnpConfig
        from genomic_pca_tpu.io.bed import write_plink
        from genomic_pca_tpu.models.eigensnp import compute_eigensnp_pca
        from genomic_pca_tpu.models.prepare import prepare_data

        with tempfile.TemporaryDirectory(prefix="gptpu_bench_") as td:
            d_e2e, n_e2e = 32_768, 1024
            g2 = _host_dosages(rng, d_e2e, n_e2e)
            write_plink(f"{td}/b", g2, bp=list(range(10, d_e2e * 10 + 10, 10)))
            with open(f"{td}/blocks.tsv", "w") as fh:
                edges = np.linspace(0, d_e2e * 10 + 20, 17, dtype=np.int64)
                for i in range(16):
                    fh.write(f"1 {edges[i]+1} {edges[i+1]}\n")
            cfg = DataPrepConfig(
                bed_path=f"{td}/b", ld_block_path=f"{td}/blocks.tsv",
                min_maf=0.0, max_hwe_p=1.0,
            )
            ecfg = EigenSnpConfig(k_global=10, min_subset_size=256)
            t0 = time.perf_counter()
            prep = prepare_data(cfg)
            res = compute_eigensnp_pca(prep, ecfg)
            e2e_dt = time.perf_counter() - t0
            # Second run hits the jit caches: steady-state pipeline
            # throughput (cold includes one-time compiles + uploads).
            t0 = time.perf_counter()
            prep = prepare_data(cfg)
            res = compute_eigensnp_pca(prep, ecfg)
            warm_dt = time.perf_counter() - t0
            e2e = {
                "eigensnp_e2e_snps": prep.n_pca_snps,
                "eigensnp_e2e_samples": n_e2e,
                "eigensnp_e2e_cold_seconds": round(e2e_dt, 2),
                "eigensnp_e2e_seconds": round(warm_dt, 2),
                "eigensnp_e2e_snps_per_sec": round(prep.n_pca_snps / warm_dt, 1),
            }
    except Exception as e:  # bench must still print its one line
        e2e = {"eigensnp_e2e_error": str(e)}

    # Compact biobank e2e: wide-N k=40 full workflow (BED -> QC ->
    # EigenSNP) — the BASELINE.md biobank config's composition at
    # bench-budget size.  The full-scale run (1M x 102k) is `--biobank`
    # / scripts/biobank_bench.py.
    bio = {}
    try:
        import pathlib
        import sys as _sys
        import tempfile

        _sys.path.insert(
            0, str(pathlib.Path(__file__).resolve().parent / "scripts")
        )
        from biobank_bench import generate, run_workflow, subset_oracle

        d_bio, n_bio = 98_304, 49_152
        bio_dir = pathlib.Path(
            tempfile.gettempdir()) / f"gptpu_bench_bio_{d_bio}x{n_bio}"
        bed = bio_dir / "biobank.bed"
        want = 3 + d_bio * ((n_bio + 3) // 4)
        if not bed.exists() or bed.stat().st_size != want:
            generate(bio_dir, d_bio, n_bio, n_blocks=96, seed=7)
        r = run_workflow(bio_dir, k=40, prefix="bench_run")
        bio = {
            "biobank_e2e_snps": d_bio,
            "biobank_e2e_samples": n_bio,
            "biobank_e2e_k": 40,
            "biobank_e2e_seconds": r["wall_seconds"],
            "biobank_e2e_snps_per_sec": round(
                d_bio / r["wall_seconds"], 1
            ),
        }
        # Correctness bit: cheap subset-oracle concordance (framework on
        # a block-aligned SNP subset x a sample keep-list vs exact
        # float64 PCA) — a throughput number with no accuracy check is
        # unfalsifiable.  Subset size is an eigengap trade-off: 16
        # blocks x 4,096 samples leaves only 2 separated PCs (the
        # certificate covers almost nothing), while 48 blocks at the
        # same sample count separate 13 PCs (min |r| 0.992) for ~68 s
        # (measured; 48 x 8,192 separates 16 but costs 172 s and its
        # prefix-boundary PC sits at 0.96 — worse bar, 2.5x cost).
        try:
            orc = subset_oracle(
                bio_dir, k=40, n_sub_blocks=48, n_sub_samples=4096
            )
            bio["biobank_e2e_per_pc_abs_r_min_separated"] = orc[
                "per_pc_abs_r_min_separated"
            ]
            # Full-k min too: the separated-prefix min alone could mask
            # a genuine mid-spectrum concordance bug behind the
            # degenerate-tail rationale.
            bio["biobank_e2e_per_pc_abs_r_min_all_k"] = orc[
                "per_pc_abs_r_min"
            ]
            bio["biobank_e2e_oracle"] = {
                k_: orc[k_]
                for k_ in (
                    "subset_snps", "subset_samples", "well_separated_k",
                    "subspace_min_principal_cosine_full_k", "seconds",
                )
            }
        except Exception as e:
            bio["biobank_e2e_oracle_error"] = str(e)
    except Exception as e:
        bio = {"biobank_e2e_error": str(e)}

    # Reference-strategy baseline: numpy f64 centered Gram accumulation
    # (X^T X over a sample of strips), the oracle's inner loop.  Best of
    # 3 reps — the shared host's load varies run to run and a single
    # timing can understate the baseline by 3x.
    sample_snps = min(4096, n_snps)
    xs = _host_dosages(rng, sample_snps, n_samples).astype(np.float64)
    xs -= xs.mean(axis=1, keepdims=True)
    base_dt = float("inf")
    for _rep in range(3):
        t0 = time.perf_counter()
        _ = xs.T @ xs
        base_dt = min(base_dt, time.perf_counter() - t0)
    base_snps_per_sec = sample_snps / base_dt

    print(
        json.dumps(
            {
                "metric": "packed_q8_power_iteration_throughput",
                "value": round(snps_per_sec, 1),
                "unit": "SNPs/sec",
                # vs_baseline stays wall-vs-wall (marginal dispatch rate
                # over the numpy-oracle wall rate): the headline `value`
                # is trace-derived ON-DEVICE time, and dividing that by
                # an overhead-inclusive host baseline would inflate the
                # ratio by methodology rather than code.
                "vs_baseline": round(
                    marginal_snps_per_sec / base_snps_per_sec, 3
                ),
                "detail": {
                    "platform": platform,
                    "device_kind": jax.devices()[0].device_kind,
                    "value_method": value_method,
                    "marginal_snps_per_sec": round(marginal_snps_per_sec, 1),
                    "n_snps": n_snps,
                    "n_samples": n_samples,
                    "sketch_width": ell,
                    "layout": "PLINK 2-bit packed (production EigenSNP "
                    "residency), q8 int8 power loop",
                    "tflops_per_sec_packed_q8": round(tflops_packed, 3),
                    "tflops_per_sec_dense_q8": round(
                        flops_per_iter / dt_dense / 1e12, 3
                    ),
                    "tflops_per_sec_dense_bf16": round(
                        flops_per_iter / dt_bf16 / 1e12, 3
                    ),
                    "timing_method": {
                        "packed_q8": how_packed,
                        "dense_q8": how_dense,
                        "dense_bf16": how_bf16,
                    },
                    # ON-DEVICE ms/iter from a profiler trace (device
                    # busy time / iters).
                    "trace_device_ms_per_iter": (
                        {
                            "packed_q8": round(tr_packed, 4),
                            "dense_q8": round(tr_dense, 4),
                            "dense_bf16": round(tr_bf16, 4),
                        }
                        if None not in (tr_packed, tr_dense, tr_bf16)
                        else {"unavailable": tr_err or "partial capture"}
                    ),
                    "trace_tflops_packed_q8": (
                        round(flops_per_iter / (tr_packed * 1e-3) / 1e12, 1)
                        if tr_packed else None
                    ),
                    "trace_tflops_dense_q8": (
                        round(flops_per_iter / (tr_dense * 1e-3) / 1e12, 1)
                        if tr_dense else None
                    ),
                    "baseline": "numpy f64 Gram accumulation "
                    "(reference oracle inner loop) on this host",
                    "baseline_snps_per_sec": round(base_snps_per_sec, 1),
                    **e2e,
                    **bio,
                },
            }
        )
    )


def main_biobank() -> None:
    """Full biobank config (BASELINE.md:29 class): 1M x 102k EigenSNP
    k=40 end-to-end; prints one JSON line."""
    import pathlib
    import sys as _sys
    import tempfile

    _sys.path.insert(
        0, str(pathlib.Path(__file__).resolve().parent / "scripts")
    )
    from biobank_bench import generate, run_workflow

    # 102,400 samples: the 100k-sample biobank class.
    d, n, k = 1_048_576, 102_400, 40
    bio_dir = pathlib.Path(tempfile.gettempdir()) / "gptpu_biobank"
    bed = bio_dir / "biobank.bed"
    want = 3 + d * ((n + 3) // 4)
    if not bed.exists() or bed.stat().st_size != want:
        generate(bio_dir, d, n, n_blocks=1024, seed=2025)
    r = run_workflow(bio_dir, k=k, prefix="bench_run")
    print(
        json.dumps(
            {
                "metric": "biobank_eigensnp_e2e_throughput",
                "value": round(d / r["wall_seconds"], 1),
                "unit": "SNPs/sec",
                "vs_baseline": None,
                "detail": {
                    "n_snps": d, "n_samples": n, "k": k,
                    "wall_seconds": r["wall_seconds"],
                },
            }
        )
    )


if __name__ == "__main__":
    import sys as _sys

    if "--biobank" in _sys.argv:
        main_biobank()
    else:
        main()
