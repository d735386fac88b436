"""Prefetch pipeline and host-streamed matrix tests."""

import dataclasses
import time

import numpy as np
import pytest

from genomic_pca_tpu.io.prefetch import StripPrefetcher
from genomic_pca_tpu.models.pca import streamed_pca
from genomic_pca_tpu.ops.stream import StripedMatrix
from tests.conftest import make_genotypes


def test_prefetcher_in_order_delivery():
    def fetch(i):
        time.sleep(0.001 * ((i * 7) % 3))  # jittered latencies
        return i * 10, 4

    p = StripPrefetcher(fetch, 50, depth=4, max_workers=3)
    got = list(p)
    assert got == [i * 10 for i in range(50)]
    assert p.telemetry.strips_total == 50
    assert p.telemetry.bytes_total == 200


def test_prefetcher_error_propagates():
    def fetch(i):
        if i == 5:
            raise RuntimeError("boom")
        return i, 1

    p = StripPrefetcher(fetch, 10, depth=2)
    out = []
    with pytest.raises(RuntimeError, match="boom"):
        for x in p:
            out.append(x)
    assert out == [0, 1, 2, 3, 4]


def test_prefetcher_autoscale_scales_up_under_slow_producer():
    """Slow producers + fast consumer: the controller must observe the
    starvation at its eval interval and grow the pool (the reference's
    queue > 3x actors rule, prepare.rs:772-822)."""
    def slow_fetch(i):
        time.sleep(0.02)
        return i, 100

    p = StripPrefetcher(
        slow_fetch, 80, depth=4, max_workers=4,
        eval_interval_s=0.05, cooldown_s=0.05,
    )
    _ = list(p)
    assert p.telemetry.scale_ups >= 1
    assert p.telemetry.workers_high_water >= 2
    assert p.throughput_bps() >= 0.0


def test_prefetcher_autoscale_scales_down_under_slow_consumer():
    """Fast producers + slow consumer: the buffer sits full with no
    starvation, so the controller retires workers (the reference's
    queue < 1.5x actors rule, prepare.rs:823-845)."""
    def fetch(i):
        return i, 100

    p = StripPrefetcher(
        fetch, 60, depth=3, max_workers=4, initial_workers=4,
        eval_interval_s=0.05, cooldown_s=0.05,
    )
    for _x in p:
        time.sleep(0.01)  # slow consumer
    assert p.telemetry.scale_downs >= 1
    assert p._target_workers < 4


def test_prefetcher_controller_decision_rules():
    """The controller's decision function, exercised deterministically
    for all three rules (scale-up on starvation, probe revert when the
    extra worker bought no throughput, retire on idle backpressure)."""
    p = StripPrefetcher(lambda i: (i, 1), 100, depth=4, max_workers=4)

    # Starved + under-filled buffer -> scale up, probe records Bps.
    p._target_workers = 1
    action, probe = p._decide(
        backlog=0, starved_since=3, remaining=50, bps=1000.0, probe=None
    )
    assert action == "up" and probe == 1000.0

    # Next eval: starvation stopped, throughput unchanged -> revert.
    p._target_workers = 2
    action, probe = p._decide(
        backlog=2, starved_since=0, remaining=40, bps=1010.0, probe=1000.0
    )
    assert action == "down_probe"

    # Throughput DID improve >= 5% -> keep the worker.
    action, _ = p._decide(
        backlog=2, starved_since=0, remaining=40, bps=1200.0, probe=1000.0
    )
    assert action == "hold"

    # Still starving -> keep the worker even with flat throughput.
    action, _ = p._decide(
        backlog=0, starved_since=2, remaining=40, bps=1000.0, probe=1000.0
    )
    assert action == "up"  # and keeps growing

    # Full buffer, no starvation -> idle retire.
    p._target_workers = 3
    action, _ = p._decide(
        backlog=4, starved_since=0, remaining=40, bps=1000.0, probe=None
    )
    assert action == "down_idle"

    # At one worker, never retire below the floor.
    p._target_workers = 1
    action, _ = p._decide(
        backlog=4, starved_since=0, remaining=40, bps=1000.0, probe=None
    )
    assert action == "hold"


def test_streaming_matrix_matches_resident(tmp_path, rng):
    from genomic_pca_tpu.io.bed import write_plink
    from genomic_pca_tpu.models.prepare import prepare_data
    from genomic_pca_tpu.config import DataPrepConfig

    geno = make_genotypes(rng, 300, 50, missing_rate=0.02)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno, bp=list(range(10, 3010, 10)))
    blocks = tmp_path / "blocks.tsv"
    blocks.write_text("1 1 4000\n")
    cfg = DataPrepConfig(
        bed_path=prefix, ld_block_path=str(blocks),
        min_call_rate=0.5, snp_chunk_size=128,
    )
    prep = prepare_data(cfg)

    # f32 products: the comparison is against the f32 striped reference.
    sm_stream = prep.load_streaming_matrix(
        strip_size=64, kernel_precision="f32"
    )
    sm_resident = prep.load_striped_matrix(strip_size=64)

    import jax.numpy as jnp

    b = jnp.asarray(rng.standard_normal((prep.n_samples, 5)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sm_stream.gram_apply(b)),
        np.asarray(sm_resident.gram_apply(b)),
        rtol=1e-4, atol=1e-2,
    )
    np.testing.assert_allclose(
        np.asarray(sm_stream.tsq_accumulate(b)),
        np.asarray(sm_resident.tsq_accumulate(b)),
        rtol=1e-4, atol=1e-1,
    )
    np.testing.assert_allclose(
        sm_stream.right_apply(b), sm_resident.right_apply(b),
        rtol=1e-4, atol=1e-2,
    )
    assert sm_stream.last_telemetry.strips_total > 0


def test_streamed_pca_on_streaming_matrix(tmp_path, rng):
    from genomic_pca_tpu.io.bed import write_plink
    from genomic_pca_tpu.models.prepare import prepare_data
    from genomic_pca_tpu.config import DataPrepConfig

    geno = make_genotypes(rng, 400, 40, n_pops=5, fst=0.25)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno, bp=list(range(10, 4010, 10)))
    blocks = tmp_path / "blocks.tsv"
    blocks.write_text("1 1 5000\n")
    cfg = DataPrepConfig(bed_path=prefix, ld_block_path=str(blocks))
    prep = prepare_data(cfg)

    r_stream = streamed_pca(
        prep.load_streaming_matrix(strip_size=128), k=3, n_power_iter=5, seed=9
    )
    r_resident = streamed_pca(
        prep.load_striped_matrix(strip_size=128), k=3, n_power_iter=5, seed=9
    )
    for j in range(3):
        r = np.corrcoef(r_stream.scores[:, j], r_resident.scores[:, j])[0, 1]
        assert abs(r) > 0.9999


def test_prefetcher_timeout():
    import threading

    block = threading.Event()

    def fetch(i):
        if i == 3:
            block.wait(timeout=5)  # stalls past the prefetch timeout
        return i, 1

    p = StripPrefetcher(fetch, 6, depth=2, timeout_s=0.5)
    with pytest.raises(TimeoutError, match="Strip 3"):
        list(p)
    block.set()


def test_streaming_matrix_packed_vs_dense(tmp_path, rng):
    """Packed streaming (the packed_pipeline default) == dense streaming
    through every pass, including keep-list repack and a strip size
    that row-pads to whole scan steps."""
    from genomic_pca_tpu.io.bed import write_plink
    from genomic_pca_tpu.models.prepare import prepare_data
    from genomic_pca_tpu.config import DataPrepConfig
    import jax.numpy as jnp

    geno = make_genotypes(rng, 310, 50, missing_rate=0.02)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno, bp=list(range(10, 3110, 10)))
    blocks = tmp_path / "blocks.tsv"
    blocks.write_text("1 1 4000\n")
    keep = tmp_path / "keep.txt"
    keep.write_text("".join(f"sample{i}\n" for i in range(0, 50, 2)))

    for keep_path in (None, str(keep)):
        cfg = DataPrepConfig(
            bed_path=prefix, ld_block_path=str(blocks),
            min_call_rate=0.5, snp_chunk_size=128,
            sample_keep_path=keep_path,
        )
        prep = prepare_data(cfg)
        cfg_dense = dataclasses.replace(cfg, packed_pipeline=False)
        prep_dense = prepare_data(cfg_dense)

        sm_pk = prep.load_streaming_matrix(strip_size=60)
        assert sm_pk.packed
        sm_dn = prep_dense.load_streaming_matrix(strip_size=60)
        assert not sm_dn.packed

        b = jnp.asarray(
            rng.standard_normal((prep.n_samples, 5)).astype(np.float32)
        )
        np.testing.assert_allclose(
            np.asarray(sm_pk.gram_apply(b)), np.asarray(sm_dn.gram_apply(b)),
            rtol=1e-4, atol=1e-2,
        )
        np.testing.assert_allclose(
            np.asarray(sm_pk.tsq_accumulate(b)),
            np.asarray(sm_dn.tsq_accumulate(b)), rtol=1e-4, atol=1e-1,
        )
        np.testing.assert_allclose(
            sm_pk.right_apply(b), sm_dn.right_apply(b), rtol=1e-4, atol=1e-2
        )

        # 32-row scan steps on 60-row packed strips: the row padding to
        # 64 rows must stay inert (against an f32 dense reference).
        sm_dn32 = prep_dense.load_streaming_matrix(
            strip_size=60, kernel_precision="f32"
        )
        sm_i = prep.load_streaming_matrix(
            strip_size=60, tile_d=32, kernel_precision="f32"
        )
        assert sm_i.step == 32 and sm_i.strip_rows == 64
        np.testing.assert_allclose(
            np.asarray(sm_i.gram_apply(b)),
            np.asarray(sm_dn32.gram_apply(b)), rtol=1e-4, atol=1e-2,
        )
        np.testing.assert_allclose(
            sm_i.right_apply(b), sm_dn32.right_apply(b),
            rtol=1e-4, atol=1e-2,
        )


def test_streaming_matrix_packed_missing_policy_error(tmp_path, rng):
    from genomic_pca_tpu.io.bed import write_plink
    from genomic_pca_tpu.models.prepare import prepare_data
    from genomic_pca_tpu.config import DataPrepConfig
    from genomic_pca_tpu.errors import DataPrepError
    import jax.numpy as jnp
    import pytest as _pytest

    geno = make_genotypes(rng, 100, 30, missing_rate=0.05)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno, bp=list(range(10, 1010, 10)))
    blocks = tmp_path / "blocks.tsv"
    blocks.write_text("1 1 2000\n")
    cfg = DataPrepConfig(
        bed_path=prefix, ld_block_path=str(blocks),
        min_call_rate=0.5, missing_policy="error",
    )
    prep = prepare_data(cfg)
    sm = prep.load_streaming_matrix(strip_size=64)
    b = jnp.asarray(np.zeros((prep.n_samples, 2), np.float32))
    with _pytest.raises(DataPrepError, match="missing_policy"):
        np.asarray(sm.gram_apply(b))


def test_streamed_pca_fused_loadings_match(tmp_path, rng):
    """tsq_and_capture (fused tsq + A B pass) must give the same loadings
    as the separate right_apply pass."""
    from genomic_pca_tpu.io.bed import write_plink
    from genomic_pca_tpu.models.prepare import prepare_data
    from genomic_pca_tpu.config import DataPrepConfig

    geno = make_genotypes(rng, 300, 40, n_pops=4, fst=0.25)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno, bp=list(range(10, 3010, 10)))
    blocks = tmp_path / "blocks.tsv"
    blocks.write_text("1 1 4000\n")
    cfg = DataPrepConfig(bed_path=prefix, ld_block_path=str(blocks))
    prep = prepare_data(cfg)

    r_stream = streamed_pca(
        prep.load_streaming_matrix(strip_size=64, kernel_precision="f32"),
        k=3,
        n_power_iter=5, seed=9, compute_loadings=True,
    )
    r_resident = streamed_pca(
        prep.load_striped_matrix(strip_size=64), k=3,
        n_power_iter=5, seed=9, compute_loadings=True,
    )
    assert r_stream.loadings.shape == (prep.n_pca_snps, 3)
    for j in range(3):
        r = np.corrcoef(r_stream.loadings[:, j], r_resident.loadings[:, j])[0, 1]
        assert abs(r) > 0.9999, (j, r)
    np.testing.assert_allclose(
        r_stream.singular_values, r_resident.singular_values, rtol=1e-4
    )


def test_streaming_strips_round_robin_across_devices(tmp_path, rng):
    """Multi-chip streaming: strips land on mesh devices round-robin and
    the merged factors match a single-device streaming run."""
    import jax
    import jax.numpy as jnp
    from genomic_pca_tpu.io.bed import write_plink
    from genomic_pca_tpu.models.prepare import prepare_data
    from genomic_pca_tpu.config import DataPrepConfig

    devs = jax.local_devices()
    assert len(devs) >= 2, "conftest provides 8 virtual devices"

    geno = make_genotypes(rng, 300, 40, missing_rate=0.01)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, geno, bp=list(range(10, 3010, 10)))
    blocks = tmp_path / "blocks.tsv"
    blocks.write_text("1 1 4000\n")
    cfg = DataPrepConfig(bed_path=prefix, ld_block_path=str(blocks))
    prep = prepare_data(cfg)

    sm_multi = prep.load_streaming_matrix(strip_size=64)
    sm_single = prep.load_streaming_matrix(strip_size=64, devices=devs[:1])
    assert len(sm_multi.devices) == len(devs)

    # _fetch returns HOST payloads; the consumer-side generator commits
    # strip i to device i mod D.
    (g0h, _m0, _iv0), _ = sm_multi._fetch(0)
    assert isinstance(g0h, np.ndarray)
    it = sm_multi._prefetcher()
    g0, _, _ = next(it)
    g1, _, _ = next(it)
    assert list(g0.devices())[0] == devs[0]
    assert list(g1.devices())[0] == devs[1]
    for _ in it:  # drain so worker threads retire cleanly
        pass

    b = jnp.asarray(rng.standard_normal((prep.n_samples, 5)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sm_multi.gram_apply(b)),
        np.asarray(sm_single.gram_apply(b)),
        rtol=1e-5, atol=1e-3,
    )
    g_m, ab_m = sm_multi.tsq_and_capture(b)
    g_s, ab_s = sm_single.tsq_and_capture(b)
    np.testing.assert_allclose(np.asarray(g_m), np.asarray(g_s),
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(ab_m, ab_s, rtol=1e-5, atol=1e-3)
