"""Quantized (int8) power-iteration path.

The q8 steering pass (ops/products.gram_q8) runs the subspace-iteration
passes as s8 x s8 -> s32 matmuls with standardization hoisted to exact
rank-1/diagonal corrections; the power loop polishes with the exact bf16
products before the Rayleigh-Ritz (parallel/sharded.py `power_loop`).
These tests pin end-to-end PC concordance of kernel_precision="q8" vs
the float64 oracle — including missing genotypes, whose sentinel the
quantized passes approximate as raw 0 (ops/products.py q8 notes), and
strips bounded below the row tile (wide sample axes).  The pass itself
is pinned against its quantization model in tests/test_products.py.
"""

import numpy as np
import pytest

from genomic_pca_tpu.models.pca import streamed_pca
from genomic_pca_tpu.ops import products
from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu.parallel.sharded import ShardedMatrix
from tests.conftest import make_genotypes


def _exact_pcs(g, k):
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    cnt = valid.sum(axis=1)
    mean = g0.sum(axis=1) / cnt
    ssd = (((g0 - mean[:, None]) ** 2) * valid).sum(axis=1)
    std = np.sqrt(ssd / (cnt - 1)) + 1e-12
    a = np.where(valid, (g0 - mean[:, None]) / std[:, None], 0.0)
    evals, evecs = np.linalg.eigh(a.T @ a)
    return evecs[:, ::-1][:, :k], evals[::-1][:k]


def test_q8_pca_concordance_vs_f64(rng):
    # 8 pops -> k=6 separated PCs; 2% missing exercises the sentinel
    # approximation in the quantized passes.
    d, n, k = 1024, 192, 6
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=8, fst=0.12)
    v_true, _ = _exact_pcs(g, k)
    mesh = make_mesh()
    sm = ShardedMatrix.from_arrays(
        iter([g]), mesh=mesh, kernel_precision="q8", tile_d=128,
    )
    res = streamed_pca(sm, k=k, n_power_iter=6, seed=11)
    for i in range(k):
        v = res.scores[:, i] / np.linalg.norm(res.scores[:, i])
        r = abs(float(np.dot(v, v_true[:, i])))
        assert r > 0.999, (i, r)


def test_q8_matches_bf16_path(rng):
    """q8 and plain-bf16 containers agree on the same data (no missing).

    Layout note: the row-padding granule is tile_d for every precision,
    so both containers distribute rows identically across the 8-device
    mesh (a precision-dependent granule once shifted PC4 concordance to
    0.99986 via f32 summation-order changes alone)."""
    d, n, k = 768, 128, 4
    g = make_genotypes(rng, d, n, missing_rate=0.0, n_pops=6, fst=0.15)
    mesh = make_mesh()
    kw = dict(mesh=mesh, tile_d=128)
    sm_b = ShardedMatrix.from_arrays(iter([g]), kernel_precision="bf16", **kw)
    sm_q = ShardedMatrix.from_arrays(iter([g]), kernel_precision="q8", **kw)
    rb = streamed_pca(sm_b, k=k, n_power_iter=5, seed=3)
    rq = streamed_pca(sm_q, k=k, n_power_iter=5, seed=3)
    for i in range(k):
        r = abs(float(
            np.dot(rb.scores[:, i], rq.scores[:, i])
            / (np.linalg.norm(rb.scores[:, i])
               * np.linalg.norm(rq.scores[:, i]))
        ))
        assert r > 0.9999, (i, r)
    np.testing.assert_allclose(
        rq.eigenvalues, rb.eigenvalues, rtol=5e-3
    )


def test_q8_packed_matches_dense_q8(rng):
    """Packed (2-bit) q8 container agrees with the dense q8 container."""
    from genomic_pca_tpu.parallel.sharded import pack_int8_rows

    d, n, k = 512, 128, 4
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=6, fst=0.15)
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    cnt = valid.sum(axis=1)
    mean = (g0.sum(axis=1) / cnt).astype(np.float32)
    std = np.sqrt(
        (((g0 - mean[:, None]) ** 2) * valid).sum(axis=1) / (cnt - 1)
    ).astype(np.float32)
    mesh = make_mesh()
    kw = dict(mesh=mesh, tile_d=128, kernel_precision="q8")
    sm_d = ShardedMatrix.from_arrays(
        iter([g]), means=[mean], stds=[std], **kw
    )
    sm_p = ShardedMatrix.from_packed_rows(
        pack_int8_rows(g), mean, std, n, **kw
    )
    assert sm_p.packed and not sm_d.packed
    rd = streamed_pca(sm_d, k=k, n_power_iter=5, seed=3)
    rp = streamed_pca(sm_p, k=k, n_power_iter=5, seed=3)
    for i in range(k):
        r = abs(float(
            np.dot(rd.scores[:, i], rp.scores[:, i])
            / (np.linalg.norm(rd.scores[:, i])
               * np.linalg.norm(rp.scores[:, i]))
        ))
        assert r > 0.9999, (i, r)


# ---------------------------------------------------------------------------
# Bounded strips (wide sample axes): STRIP_BYTES caps the f32 strip, so
# the scan steps shrink below tile_d and z re-quantizes per smaller
# strip.  Shrinking the budget reproduces that regime at test size.


@pytest.fixture
def small_strips(monkeypatch):
    monkeypatch.setattr(products, "STRIP_BYTES", 32 << 10)


def test_q8_bounded_strips_concordance_vs_f64(rng, small_strips):
    """Resident q8 with strips bounded below tile_d matches float64."""
    d, n, k = 1024, 192, 6
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=8, fst=0.12)
    v_true, _ = _exact_pcs(g, k)
    sm = ShardedMatrix.from_arrays(
        iter([g]), mesh=make_mesh(), kernel_precision="q8", tile_d=128,
    )
    assert sm.step < sm.tile_d
    res = streamed_pca(sm, k=k, n_power_iter=6, seed=11)
    for i in range(k):
        v = res.scores[:, i] / np.linalg.norm(res.scores[:, i])
        r = abs(float(np.dot(v, v_true[:, i])))
        assert r > 0.999, (i, r)


def test_q8_bounded_strips_packed_matches_dense(rng, small_strips):
    """Packed q8 with bounded strips agrees with the dense container."""
    from genomic_pca_tpu.parallel.sharded import pack_int8_rows

    d, n, k = 512, 192, 4
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=6, fst=0.15)
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    cnt = valid.sum(axis=1)
    mean = (g0.sum(axis=1) / cnt).astype(np.float32)
    std = np.sqrt(
        (((g0 - mean[:, None]) ** 2) * valid).sum(axis=1) / (cnt - 1)
    ).astype(np.float32)
    kw = dict(mesh=make_mesh(), tile_d=128, kernel_precision="q8")
    sm_d = ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std], **kw)
    sm_p = ShardedMatrix.from_packed_rows(
        pack_int8_rows(g), mean, std, n, **kw
    )
    assert sm_p.packed and sm_p.step < sm_p.tile_d
    rd = streamed_pca(sm_d, k=k, n_power_iter=5, seed=3)
    rp = streamed_pca(sm_p, k=k, n_power_iter=5, seed=3)
    for i in range(k):
        r = abs(float(
            np.dot(rd.scores[:, i], rp.scores[:, i])
            / (np.linalg.norm(rd.scores[:, i])
               * np.linalg.norm(rp.scores[:, i]))
        ))
        assert r > 0.9999, (i, r)


def _streaming_from_dense(g, strip, packed, **kw):
    from genomic_pca_tpu.ops.streaming import StreamingMatrix
    from genomic_pca_tpu.parallel.sharded import inv_std_of, pack_int8_rows

    d, n = g.shape
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    cnt = np.maximum(valid.sum(axis=1), 1)
    mean = (g0.sum(axis=1) / cnt).astype(np.float32)
    std = np.sqrt(
        (((g0 - mean[:, None]) ** 2) * valid).sum(axis=1)
        / np.maximum(cnt - 1, 1)
    ).astype(np.float32)
    n_strips = -(-d // strip)

    def source(i):
        lo, hi = i * strip, min((i + 1) * strip, d)
        gs = g[lo:hi]
        ms, ss = mean[lo:hi], std[lo:hi]
        if hi - lo < strip:
            gs = np.pad(gs, ((0, strip - (hi - lo)), (0, 0)))
            ms = np.pad(ms, (0, strip - (hi - lo)))
            ss = np.pad(ss, (0, strip - (hi - lo)))
        if packed:
            return pack_int8_rows(gs), ms, ss
        return gs, ms, ss

    return StreamingMatrix(
        source, n_strips=n_strips, n_rows=d, n_samples=n,
        strip_size=strip, packed=packed, **kw
    ), inv_std_of


def test_streaming_q8_concordance_vs_f64(rng):
    """StreamingMatrix with q8 steering + exact polish matches the f64
    oracle (the bigger-than-device-memory container)."""
    d, n, k = 1024, 192, 5
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=8, fst=0.12)
    v_true, _ = _exact_pcs(g, k)
    for packed in (False, True):
        sm, _ = _streaming_from_dense(
            g, strip=256, packed=packed, kernel_precision="q8", tile_d=128,
        )
        assert sm.q8_polish == 1
        res = streamed_pca(sm, k=k, n_power_iter=6, seed=11)
        for i in range(k):
            v = res.scores[:, i] / np.linalg.norm(res.scores[:, i])
            r = abs(float(np.dot(v, v_true[:, i])))
            assert r > 0.999, (packed, i, r)


def test_streaming_q8_bounded_strips(rng, small_strips):
    """Streaming q8 with strips split into bounded scan steps."""
    d, n, k = 512, 192, 4
    g = make_genotypes(rng, d, n, missing_rate=0.0, n_pops=6, fst=0.15)
    v_true, _ = _exact_pcs(g, k)
    sm, _ = _streaming_from_dense(
        g, strip=256, packed=True, kernel_precision="q8", tile_d=128,
    )
    assert sm.step < 256 and sm.strip_rows == 256
    res = streamed_pca(sm, k=k, n_power_iter=5, seed=7)
    for i in range(k):
        v = res.scores[:, i] / np.linalg.norm(res.scores[:, i])
        r = abs(float(np.dot(v, v_true[:, i])))
        assert r > 0.999, (i, r)


def test_q8_high_missingness_polish(rng):
    """10% missing (call-rate gate 0.90 admits this): the adaptive
    polish (2 exact passes) keeps per-PC |r| vs float64 at the bar."""
    from genomic_pca_tpu.parallel.sharded import resolve_q8_polish

    assert resolve_q8_polish(None, None) == 1
    assert resolve_q8_polish(None, 0.02) == 1
    assert resolve_q8_polish(None, 0.10) == 2
    assert resolve_q8_polish(3, 0.0) == 3
    with pytest.raises(ValueError):
        resolve_q8_polish(0, None)

    d, n, k = 1024, 192, 5
    g = make_genotypes(rng, d, n, missing_rate=0.10, n_pops=8, fst=0.12)
    v_true, _ = _exact_pcs(g, k)
    mesh = make_mesh()
    sm = ShardedMatrix.from_arrays(
        iter([g]), mesh=mesh, kernel_precision="q8", tile_d=128, missing_fraction=0.10,
    )
    assert sm.q8_polish == 2
    res = streamed_pca(sm, k=k, n_power_iter=6, seed=11)
    for i in range(k):
        v = res.scores[:, i] / np.linalg.norm(res.scores[:, i])
        r = abs(float(np.dot(v, v_true[:, i])))
        assert r > 0.999, (i, r)
