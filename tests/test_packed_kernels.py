"""Packed (PLINK 2-bit) containers vs the int8 containers.

Packed genotypes upload as raw BED bytes and unpack in original sample
order inside the products (ops/products.py); with f32 products every
pass must match the int8 container to accumulation noise.
"""

import jax.numpy as jnp
import numpy as np

from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu.parallel.sharded import ShardedMatrix, pack_int8_rows
from genomic_pca_tpu.parallel.sharded import pack_int8_rows as pack_rows
from tests.conftest import make_genotypes



def _pair(rng, d=300, n=70, tile_d=32):
    geno = make_genotypes(rng, d, n, missing_rate=0.03, n_pops=3, fst=0.2)
    mean = np.where(geno == -127, np.nan, geno.astype(np.float64))
    mu = np.nan_to_num(np.nanmean(mean, axis=1)).astype(np.float32)
    sd = np.nan_to_num(np.nanstd(mean, axis=1, ddof=1)).astype(np.float32)
    mesh = make_mesh()
    kw = dict(mesh=mesh, tile_d=tile_d, kernel_precision="f32")
    sm_i = ShardedMatrix.from_arrays(
        iter([geno]), means=[mu], stds=[sd], **kw
    )
    sm_p = ShardedMatrix.from_packed_rows(pack_int8_rows(geno), mu, sd, n, **kw)
    assert sm_p.packed and not sm_i.packed
    return sm_i, sm_p


def test_packed_sharded_matches_int8(rng):
    sm_i, sm_p = _pair(rng)
    b = jnp.asarray(
        np.random.default_rng(5).standard_normal((70, 9)), jnp.float32
    )
    np.testing.assert_allclose(
        np.asarray(sm_p.gram_apply(b)), np.asarray(sm_i.gram_apply(b)),
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(sm_p.tsq_accumulate(b)), np.asarray(sm_i.tsq_accumulate(b)),
        rtol=1e-4, atol=1e-3,
    )
    np.testing.assert_allclose(
        sm_p.right_apply(b), sm_i.right_apply(b), rtol=1e-4, atol=1e-4
    )


def test_packed_power_and_pca_core_match(rng):
    sm_i, sm_p = _pair(rng)
    b0 = jnp.asarray(
        np.random.default_rng(6).standard_normal((70, 8)), jnp.float32
    )
    q_i = np.asarray(sm_i.power_iterate(b0, 4))
    q_p = np.asarray(sm_p.power_iterate(b0, 4))
    # orthonormal bases: compare up to column sign
    for j in range(q_i.shape[1]):
        r = np.corrcoef(q_i[:, j], q_p[:, j])[0, 1]
        assert abs(r) > 0.9999, (j, r)

    v_i, s_i, e_i, l_i = sm_i.pca_core(b0, 3, 5)
    v_p, s_p, e_p, l_p = sm_p.pca_core(b0, 3, 5)
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_i), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(e_p), np.asarray(e_i), rtol=1e-4)
    for j in range(5):
        r = np.corrcoef(np.asarray(v_i)[:, j], np.asarray(v_p)[:, j])[0, 1]
        assert abs(r) > 0.9999
        rl = np.corrcoef(l_i[:, j], l_p[:, j])[0, 1]
        assert abs(rl) > 0.9999


def test_packed_fetch_blocks_and_missing(rng):
    sm_i, sm_p = _pair(rng)
    assert sm_p.count_missing() == sm_i.count_missing() > 0
    starts = np.array([0, 50, 200])
    lens = np.array([50, 64, 100])
    # full-width fetches differ in PAD column count (packed lanes are
    # 128-byte = 512-sample granular); real columns must agree.
    bi = np.asarray(sm_i.fetch_blocks_device(starts, lens, 128))[:, :, :70]
    bp = np.asarray(sm_p.fetch_blocks_device(starts, lens, 128))[:, :, :70]
    np.testing.assert_allclose(bp, bi, rtol=1e-5, atol=1e-5)
    cols = jnp.asarray(np.array([3, 9, 11, 40], dtype=np.int32))
    bi = np.asarray(sm_i.fetch_blocks_device(starts, lens, 128, cols))
    bp = np.asarray(sm_p.fetch_blocks_device(starts, lens, 128, cols))
    np.testing.assert_allclose(bp, bi, rtol=1e-5, atol=1e-5)


def test_pack_int8_rows_trailing_fields_missing(rng):
    """Trailing 2-bit fields of a partial last byte must be the inert
    01 (missing) code, not PLINK's zero-fill (00 = dosage 2)."""
    g = rng.integers(0, 3, size=(5, 7)).astype(np.int8)
    packed = pack_rows(g)
    assert packed.shape == (5, 2)
    # samples 4,5,6 occupy fields 0-2 of byte 1; field 3 must be 01
    assert np.all((packed[:, 1] >> 6) == 1)


def test_from_packed_strips_matches_from_packed_rows(rng):
    """Strip-streamed constructor == one-shot constructor bit-for-bit
    (multi-device mesh, partial trailing byte, row padding)."""
    from genomic_pca_tpu.parallel.sharded import (
        ShardedMatrix, sanitize_partial_byte,
    )

    d, n = 700, 37
    geno = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    geno[rng.random((d, n)) < 0.05] = -127
    packed = pack_rows(geno)
    mean = rng.random(d).astype(np.float32)
    std = (rng.random(d).astype(np.float32) + 0.5)

    sm_a = ShardedMatrix.from_packed_rows(packed, mean, std, n)

    def read_strip(lo, hi):
        return sanitize_partial_byte(packed[lo:hi], n)

    sm_b = ShardedMatrix.from_packed_strips(
        read_strip, n_rows=d, mean=mean, std=std, n_samples=n,
        strip_rows=96,
    )
    assert sm_b.packed and sm_b.n_rows == d
    np.testing.assert_array_equal(np.asarray(sm_a.geno), np.asarray(sm_b.geno))
    np.testing.assert_array_equal(np.asarray(sm_a.mean), np.asarray(sm_b.mean))
    np.testing.assert_array_equal(
        np.asarray(sm_a.inv_std), np.asarray(sm_b.inv_std)
    )
