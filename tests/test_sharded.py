"""Multi-device sharded engine on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from genomic_pca_tpu.models.pca import streamed_pca
from genomic_pca_tpu.ops.stream import StripedMatrix
from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu.parallel.sharded import ShardedMatrix
from tests.conftest import make_genotypes


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def _build(geno, mesh, tile_d=64, kernel_precision="f32", **kw):
    """Layout and sharding checks compare against f32 references, so
    the container runs f32 products."""
    return ShardedMatrix.from_arrays(
        iter([geno]), mesh=mesh, tile_d=tile_d,
        kernel_precision=kernel_precision, **kw
    )


def test_sharded_matches_striped(rng):
    geno = make_genotypes(rng, 500, 40, missing_rate=0.02)
    sm = _build(geno, make_mesh())
    ref = StripedMatrix.from_arrays(iter([geno]), strip_size=64)
    b = jnp.asarray(rng.standard_normal((40, 6)).astype(np.float32))

    np.testing.assert_allclose(
        np.asarray(sm.gram_apply(b)), np.asarray(ref.gram_apply(b)),
        rtol=1e-4, atol=1e-2,
    )
    np.testing.assert_allclose(
        np.asarray(sm.tsq_accumulate(b)), np.asarray(ref.tsq_accumulate(b)),
        rtol=1e-4, atol=1e-1,
    )
    np.testing.assert_allclose(
        sm.right_apply(b), ref.right_apply(b), rtol=1e-4, atol=1e-2
    )


def test_sharded_device_count_invariance(rng):
    geno = make_genotypes(rng, 300, 30)
    sm1 = _build(geno, make_mesh(jax.devices()[:1]))
    sm8 = _build(geno, make_mesh())
    b = jnp.asarray(rng.standard_normal((30, 4)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sm1.gram_apply(b)), np.asarray(sm8.gram_apply(b)),
        rtol=1e-5, atol=1e-3,
    )


def test_streamed_pca_on_sharded_matrix(rng):
    geno = make_genotypes(rng, 600, 50, n_pops=6, fst=0.25)
    sm = _build(geno, make_mesh())
    ref = StripedMatrix.from_arrays(iter([geno]), strip_size=128)
    r_sh = streamed_pca(sm, k=4, n_power_iter=6, seed=3, compute_loadings=True)
    r_st = streamed_pca(ref, k=4, n_power_iter=6, seed=3, compute_loadings=True)
    for j in range(4):
        r = np.corrcoef(r_sh.scores[:, j], r_st.scores[:, j])[0, 1]
        assert abs(r) > 0.9999
    np.testing.assert_allclose(
        r_sh.singular_values, r_st.singular_values, rtol=1e-4
    )
    assert r_sh.loadings.shape == (600, 4)


def test_padding_shapes(rng):
    # 70 rows, tile 64, 8 devices -> d_pad = 512; 20 samples -> n_pad 128
    geno = make_genotypes(rng, 70, 20)
    sm = _build(geno, make_mesh())
    assert sm.d_pad % (8 * sm.tile_d) == 0
    assert sm.n_pad % 128 == 0
    assert sm.n_rows == 70 and sm.n_samples == 20
    b = jnp.asarray(rng.standard_normal((20, 3)).astype(np.float32))
    assert sm.right_apply(b).shape == (70, 3)
    assert np.asarray(sm.gram_apply(b)).shape == (20, 3)
    assert np.asarray(sm.tsq_accumulate(b)).shape == (3, 3)


def test_missing_sample_padding_inert(rng):
    """Padded sample columns must not affect results."""
    geno = make_genotypes(rng, 100, 20)
    sm = _build(geno, make_mesh())
    ref = StripedMatrix.from_arrays(iter([geno]), strip_size=64)
    b = jnp.asarray(rng.standard_normal((20, 4)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sm.gram_apply(b)), np.asarray(ref.gram_apply(b)),
        rtol=1e-4, atol=1e-2,
    )


def test_from_local_rows_matches_from_arrays(rng):
    """Single-process path through the multi-host constructor."""
    import jax.numpy as jnp

    geno = make_genotypes(rng, 200, 30, missing_rate=0.02)
    n1 = (geno == 1).sum(axis=1)
    n2 = (geno == 2).sum(axis=1)
    nv = n1 + n2 + (geno == 0).sum(axis=1)
    mean = np.where(nv > 0, (n1 + 2.0 * n2) / np.maximum(nv, 1), 0.0)
    ssd = (n1 + 4.0 * n2) - nv * mean * mean
    std = np.sqrt(np.where(nv >= 2, ssd / np.maximum(nv - 1, 1), 0.0))

    def read_rows(lo, hi):
        return geno[lo:hi], mean[lo:hi], std[lo:hi]

    mesh = make_mesh()
    sm_local = ShardedMatrix.from_local_rows(
        read_rows, n_rows=200, n_samples=30, mesh=mesh, tile_d=64,
        kernel_precision="f32",
    )
    sm_pack = _build(geno, mesh)
    b = jnp.asarray(rng.standard_normal((30, 4)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(sm_local.gram_apply(b)), np.asarray(sm_pack.gram_apply(b)),
        rtol=1e-4, atol=1e-2,
    )
    np.testing.assert_allclose(
        sm_local.right_apply(b), sm_pack.right_apply(b), rtol=1e-4, atol=1e-2
    )


def test_pca_core_matches_decomposed(rng):
    """Fused single-program PCA equals the decomposed pass sequence."""
    geno = make_genotypes(rng, 300, 40, n_pops=5, fst=0.25)
    sm = _build(geno, make_mesh())
    k, n_iter = 4, 5
    b0 = jnp.asarray(rng.standard_normal((40, k + 10)).astype(np.float32))

    v, sigma, evals, loadings = sm.pca_core(b0, n_iter, k)

    # decomposed: power_iterate -> tsq -> eigh -> right_apply
    q = sm.power_iterate(b0, n_iter)
    g = np.asarray(sm.tsq_accumulate(q))
    w_evals, w = np.linalg.eigh(g)
    order = np.argsort(-w_evals)
    sig_ref = np.sqrt(np.maximum(w_evals[order], 0))[:k]

    np.testing.assert_allclose(np.asarray(sigma), sig_ref, rtol=1e-4)
    assert loadings.shape == (300, k)
    np.testing.assert_allclose(
        np.linalg.norm(loadings, axis=0), np.ones(k), atol=1e-3
    )
    # scores == A^T @ loadings (definition check against dense math)
    from tests.test_stream_pca import _dense_standardized

    a = _dense_standardized(geno)
    scores = np.asarray(v) * np.asarray(sigma)[None, :]
    ref_scores = a.T @ loadings
    for j in range(k):
        r = np.corrcoef(scores[:, j], ref_scores[:, j])[0, 1]
        assert abs(r) > 0.9999
