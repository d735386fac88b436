"""Randomized SVD correctness vs exact decomposition."""

import jax
import jax.numpy as jnp
import numpy as np

from genomic_pca_tpu.ops.rsvd import exact_svd, rsvd, sign_canonicalize


def _concordance(a, b):
    """Per-column |correlation| between two matrices."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a = a - a.mean(0)
    b = b - b.mean(0)
    num = (a * b).sum(0)
    den = np.sqrt((a**2).sum(0) * (b**2).sum(0))
    return np.abs(num / den)


def test_rsvd_matches_exact_lowrank(rng):
    m, n, true_rank, k = 300, 200, 12, 8
    u = rng.standard_normal((m, true_rank))
    v = rng.standard_normal((true_rank, n))
    scales = np.geomspace(100, 1, true_rank)
    x = jnp.asarray((u * scales) @ v, dtype=jnp.float32)

    key = jax.random.key(7)
    u_r, s_r, vt_r = rsvd(x, key, k=k, n_oversamples=10, n_power_iter=2)
    u_e, s_e, vt_e = exact_svd(x, k)

    np.testing.assert_allclose(np.asarray(s_r), np.asarray(s_e), rtol=1e-3)
    conc = _concordance(np.asarray(u_r), np.asarray(u_e))
    assert (conc > 0.999).all(), conc


def test_rsvd_deterministic(rng):
    x = jnp.asarray(rng.standard_normal((100, 80)), dtype=jnp.float32)
    key = jax.random.key(2025)
    out1 = rsvd(x, key, k=5)
    out2 = rsvd(x, key, k=5)
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rsvd_different_seed_same_subspace(rng):
    m, n, k = 200, 150, 6
    u = rng.standard_normal((m, k * 2))
    x = jnp.asarray(u @ rng.standard_normal((k * 2, n)), dtype=jnp.float32)
    s1 = rsvd(x, jax.random.key(1), k=k, n_power_iter=3)[1]
    s2 = rsvd(x, jax.random.key(2), k=k, n_power_iter=3)[1]
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-3)


def test_sign_canonicalize():
    u = jnp.asarray(np.diag([1.0, -2.0, 3.0]))
    vt = jnp.asarray(np.ones((3, 4)))
    u2, vt2 = sign_canonicalize(u, vt)
    assert np.asarray(u2).max() > 0
    np.testing.assert_allclose(np.asarray(u2[1, 1]), 2.0)
    np.testing.assert_allclose(np.asarray(vt2[1]), -np.ones(4))


def test_rsvd_k_larger_than_rank(rng):
    x = jnp.asarray(
        rng.standard_normal((50, 3)) @ rng.standard_normal((3, 40)),
        dtype=jnp.float32,
    )
    u, s, vt = rsvd(x, jax.random.key(0), k=10, n_power_iter=2)
    s = np.asarray(s)
    assert s.shape == (10,)
    # trailing components sit at the f32 noise floor
    assert (s[3:] < s[0] * 1e-2).all()
    assert s[2] > s[0] * 0.01 or s[2] > 10 * s[3]


def test_rfit_tolerance_early_exit(rng):
    """rfit API parity: a loose tolerance stops the power loop early
    with per-PC concordance intact; None runs every iteration
    (/root/reference/src/main.rs:648-656 tolerance contract)."""
    from genomic_pca_tpu.models.pca import streamed_pca
    from genomic_pca_tpu.parallel.mesh import make_mesh
    from genomic_pca_tpu.parallel.sharded import ShardedMatrix
    from tests.conftest import make_genotypes

    g = make_genotypes(rng, 1024, 128, n_pops=4, fst=0.25)
    mesh = make_mesh()
    k, n_iter = 4, 8
    sm = ShardedMatrix.from_arrays(iter([g]), mesh=mesh, tile_d=128)
    full = streamed_pca(sm, k=k, n_power_iter=n_iter, seed=1)
    assert full.n_iter_done == n_iter
    loose = streamed_pca(
        sm, k=k, n_power_iter=n_iter, seed=1, tolerance=5e-2
    )
    assert loose.n_iter_done < n_iter, loose.n_iter_done
    r = _concordance(full.scores[:, :k], loose.scores[:, :k])
    assert (r > 0.999).all(), r

    # Tight tolerance never exits early.
    tight = streamed_pca(
        sm, k=k, n_power_iter=n_iter, seed=1, tolerance=1e-12
    )
    assert tight.n_iter_done == n_iter


def test_rfit_tolerance_q8(rng):
    """Tolerance composes with the q8 steering + polish discipline."""
    from genomic_pca_tpu.models.pca import streamed_pca
    from genomic_pca_tpu.parallel.mesh import make_mesh
    from genomic_pca_tpu.parallel.sharded import ShardedMatrix
    from tests.conftest import make_genotypes

    g = make_genotypes(rng, 512, 128, n_pops=4, fst=0.25)
    sm = ShardedMatrix.from_arrays(
        iter([g]), mesh=make_mesh(), kernel_precision="q8", tile_d=128,
    )
    res = streamed_pca(sm, k=4, n_power_iter=8, seed=1, tolerance=5e-2)
    assert res.n_iter_done < 8
    full = streamed_pca(sm, k=4, n_power_iter=8, seed=1)
    r = _concordance(full.scores[:, :4], res.scores[:, :4])
    assert (r > 0.999).all(), r


def test_rfit_tolerance_streaming_q8(rng):
    """Tolerance on the STREAMING container: steering passes early-exit
    but the mandated exact polish always runs; n_iter_done reported."""
    from genomic_pca_tpu.models.pca import streamed_pca
    from tests.test_q8 import _streaming_from_dense
    from tests.conftest import make_genotypes

    g = make_genotypes(rng, 768, 128, n_pops=4, fst=0.25)
    sm, _ = _streaming_from_dense(
        g, strip=256, packed=True, kernel_precision="q8", tile_d=128,
    )
    n_iter = 8
    res = streamed_pca(sm, k=4, n_power_iter=n_iter, seed=1, tolerance=5e-2)
    assert res.n_iter_done is not None and res.n_iter_done < n_iter
    full = streamed_pca(sm, k=4, n_power_iter=n_iter, seed=1)
    assert full.n_iter_done == n_iter
    r = _concordance(full.scores[:, :4], res.scores[:, :4])
    assert (r > 0.999).all(), r
