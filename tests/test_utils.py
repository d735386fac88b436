"""Utility module tests: timing, logging, rng, system, jaxcache."""

import logging

import numpy as np


def test_stage_timer_collects(caplog):
    from genomic_pca_tpu.utils.timing import StageTimer

    t = StageTimer()
    with t.stage("alpha"):
        pass
    t.record("beta", 1.5)
    assert set(t.stages) == {"alpha", "beta"}
    assert t.stages["beta"] == 1.5
    with caplog.at_level(logging.INFO):
        t.log_summary()
    assert any("TOTAL" in r.message for r in caplog.records)


def test_setup_logging_levels():
    from genomic_pca_tpu.utils.logsetup import setup_logging

    setup_logging("Debug")
    assert logging.getLogger().level == logging.DEBUG
    setup_logging("Warn")
    assert logging.getLogger().level == logging.WARNING
    setup_logging("not-a-level")
    assert logging.getLogger().level == logging.INFO
    setup_logging("Off")
    assert logging.getLogger().level > logging.CRITICAL
    setup_logging("Warn")  # leave sane for other tests


def test_rng_fold_in_determinism():
    import jax

    from genomic_pca_tpu.utils.rng import key_for_stage

    k1 = key_for_stage(7, "rfit_sketch")
    k2 = key_for_stage(7, "rfit_sketch")
    k3 = key_for_stage(7, "eigensnp_local_sketch", unit=3)
    assert jax.random.key_data(k1).tolist() == jax.random.key_data(k2).tolist()
    assert jax.random.key_data(k1).tolist() != jax.random.key_data(k3).tolist()


def test_seed_words_bit_equivalence():
    """`seed_words`/`key_from_words` must reproduce the eager
    `jax.random.key` + `fold_in` bits exactly (incl. the x32 seed
    truncation) — the cold path derives all EigenSNP keys in-program
    from these words (VALIDATION.md round 4)."""
    import jax
    import numpy as np

    from genomic_pca_tpu.utils.rng import (
        key_for_stage, key_from_words, seed_words,
    )

    for seed in (0, 1, 2025, 2**31, 2**31 + 7, 2**40 + 123, -1, -12345):
        ref = np.asarray(jax.random.key_data(jax.random.key(seed)))
        assert np.array_equal(ref, seed_words(seed)), seed

        stage_ref = np.asarray(
            jax.random.key_data(key_for_stage(seed, "eigensnp_global_sketch"))
        )
        got = np.asarray(
            jax.random.key_data(
                jax.jit(
                    lambda w: key_from_words(w, "eigensnp_global_sketch")
                )(seed_words(seed))
            )
        )
        assert np.array_equal(stage_ref, got), seed


def test_rlimit_preflight_logs(caplog):
    from genomic_pca_tpu.utils.system import preflight, rlimit_soft

    assert rlimit_soft("nofile") != 0
    with caplog.at_level(logging.INFO):
        preflight(4)
    assert any("Resource preflight" in r.message for r in caplog.records)


def test_maybe_trace_noop(tmp_path):
    from genomic_pca_tpu.utils.profiling import maybe_trace

    with maybe_trace(None):
        pass  # no-op path
    # active path writes trace files
    import jax.numpy as jnp

    with maybe_trace(str(tmp_path / "trace")):
        _ = np.asarray(jnp.ones(4) + 1)
    assert (tmp_path / "trace").exists()


def test_enable_persistent_cache_respects_optout(monkeypatch):
    from genomic_pca_tpu.utils import jaxcache

    monkeypatch.setattr(jaxcache, "_done", False)
    monkeypatch.setenv("GENOMIC_PCA_TPU_NO_CACHE", "1")
    jaxcache.enable_persistent_cache()  # must not raise or set anything


def test_cache_dir_follows_env(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: JAX uses it and nothing is set in
    code."""
    from genomic_pca_tpu.utils import jaxcache

    calls = []
    monkeypatch.setattr(jaxcache, "_done", False)
    monkeypatch.delenv("GENOMIC_PCA_TPU_NO_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    import jax

    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert jaxcache.cache_dir() is None
    jaxcache.enable_persistent_cache()
    assert calls == []


def test_cache_dir_defaults_to_checkout(monkeypatch, tmp_path):
    """Unset: a fixed `.jax_cache/` at the checkout root."""
    from pathlib import Path

    from genomic_pca_tpu.utils import jaxcache

    root = Path(__file__).resolve().parent.parent
    assert jaxcache.CHECKOUT_CACHE_DIR == root / ".jax_cache"
    calls = []
    monkeypatch.setattr(jaxcache, "_done", False)
    monkeypatch.delenv("GENOMIC_PCA_TPU_NO_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jaxcache, "CHECKOUT_CACHE_DIR", tmp_path / "c")
    import jax

    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert jaxcache.cache_dir() == tmp_path / "c"
    jaxcache.enable_persistent_cache()
    assert ("jax_compilation_cache_dir", str(tmp_path / "c")) in calls
    assert (tmp_path / "c").is_dir()


class _Ev:
    def __init__(self, name, start, dur):
        self.name, self.start_ns, self.duration_ns = name, start, dur


class _Line:
    def __init__(self, name, events):
        self.name, self.events = name, events


class _Plane:
    def __init__(self, name, lines):
        self.name, self.lines = name, lines


def test_device_busy_is_the_union_of_device_events(monkeypatch):
    """Overlapping kernels on two streams count once; host planes and
    idle gaps not at all."""
    from genomic_pca_tpu.utils import xplane

    planes = [
        _Plane("/device:GPU:0", [
            _Line("Stream #13", [_Ev("gemm", 0, 4_000_000),
                                 _Ev("fusion", 6_000_000, 1_000_000)]),
            _Line("Stream #14", [_Ev("copy", 3_000_000, 2_000_000)]),
        ]),
        _Plane("/host:CPU", [_Line("python", [_Ev("x", 0, 50_000_000)])]),
    ]
    monkeypatch.setattr(xplane, "load_planes", lambda d: (planes, None))
    busy, n, err = xplane.device_busy_ms("unused")
    assert (busy, n, err) == (6.0, 3, None)  # [0,5) + [6,7) ms
    rows, _ = xplane.device_op_table("unused")
    assert rows[0] == ("gemm", 4.0, 1)


def test_device_busy_without_device_events(monkeypatch):
    from genomic_pca_tpu.utils import xplane

    monkeypatch.setattr(xplane, "load_planes", lambda d: ([], None))
    assert xplane.device_busy_ms("unused") == (None, 0, "no device events")


def test_warm_backend_async_single_thread_object():
    from genomic_pca_tpu.utils import warmup

    t1 = warmup.warm_backend_async()
    t2 = warmup.warm_backend_async()  # idempotent: same thread
    assert t1 is t2
    t1.join(timeout=60)
    assert not t1.is_alive()


def test_process_count_nodevice_matches_jax():
    import jax

    from genomic_pca_tpu.utils.warmup import process_count_nodevice

    # Single-controller test env: must report 1 (and, after the backend
    # exists, must agree with the real call).
    assert process_count_nodevice() == 1
    assert process_count_nodevice() == jax.process_count()
