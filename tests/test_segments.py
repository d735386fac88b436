"""Segmented row layout (multi-process fused assembly) + LD-block
aligned scan splitting.

The segmented layout places each process's QC survivors in its own
matrix-row segment with inert padding between segments
(parallel/sharded.py `row_segments`); these tests validate, on one
process, that a segmented matrix is numerically identical to the
prefix-layout matrix, and that `block_aligned_ranges` never bisects an
LD block (io/ldblocks.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from genomic_pca_tpu.io.ldblocks import (
    assign_first_containing_block,
    block_aligned_ranges,
)
from genomic_pca_tpu.ops.stream import MISSING
from genomic_pca_tpu.parallel.mesh import VARIANT_AXIS, make_mesh
from genomic_pca_tpu.parallel.sharded import ShardedMatrix, inv_std_of
from tests.conftest import make_genotypes


# ---------------------------------------------------------------------
# block_aligned_ranges
# ---------------------------------------------------------------------

def _mk_blocks(edges):
    return [
        ("1", int(edges[i]) + 1, int(edges[i + 1]), f"1:{edges[i]+1}-{edges[i+1]}")
        for i in range(len(edges) - 1)
    ]


def test_aligned_ranges_cover_and_respect_blocks():
    n = 503
    bp = np.arange(10, n * 10 + 10, 10)
    chroms = ["1"] * n
    blocks = _mk_blocks(np.linspace(0, n * 10 + 10, 8, dtype=np.int64))
    for n_parts in (2, 3, 4):
        ranges = block_aligned_ranges(chroms, bp, blocks, n_parts)
        assert len(ranges) == n_parts
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        for (l0, h0), (l1, _h1) in zip(ranges, ranges[1:]):
            assert h0 == l1 and l0 <= h0
        assignment = assign_first_containing_block(chroms, bp, blocks)
        for _lo, hi in ranges[:-1]:
            if 0 < hi < n:
                # boundary never splits one block
                assert not (
                    assignment[hi - 1] == assignment[hi]
                    and assignment[hi] >= 0
                )


def test_aligned_ranges_degenerate_single_block():
    # One block covering everything: no valid internal split -> even
    # fallback, and the caller's runtime guard handles the crossing.
    n = 100
    bp = np.arange(10, n * 10 + 10, 10)
    blocks = _mk_blocks([0, n * 10 + 10])
    ranges = block_aligned_ranges(["1"] * n, bp, blocks, 2)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert ranges[0][1] == ranges[1][0]


def test_aligned_ranges_single_part():
    assert block_aligned_ranges(["1"], [5], [], 1) == [(0, 1)]


# ---------------------------------------------------------------------
# Segmented ShardedMatrix == prefix ShardedMatrix
# ---------------------------------------------------------------------

def _segmented_matrix(geno, mesh, seg_break, rows_pp, tile_d=64):
    """Build a 2-segment matrix: pca rows [0, seg_break) at matrix rows
    [0, ...), pca rows [seg_break, d) at matrix rows [rows_pp, ...)."""
    d, n = geno.shape
    n_dev = mesh.devices.size
    assert rows_pp % (tile_d * n_dev // 2) == 0 or True
    d_pad = 2 * rows_pp
    n_pad = -(-n // 128) * 128

    n1 = (geno == 1).sum(axis=1)
    n2 = (geno == 2).sum(axis=1)
    nv = n1 + n2 + (geno == 0).sum(axis=1)
    mean = np.where(nv > 0, (n1 + 2.0 * n2) / np.maximum(nv, 1), 0.0)
    ssd = (n1 + 4.0 * n2) - nv * mean * mean
    std = np.sqrt(np.maximum(np.where(nv >= 2, ssd / np.maximum(nv - 1, 1), 0.0), 0.0))

    g_pad = np.full((d_pad, n_pad), MISSING, dtype=np.int8)
    m_pad = np.zeros((d_pad, 1), dtype=np.float32)
    iv_pad = np.zeros((d_pad, 1), dtype=np.float32)
    inv = inv_std_of(std.astype(np.float32))
    segs = [(0, 0, seg_break), (rows_pp, seg_break, d - seg_break)]
    for mstart, pstart, cnt in segs:
        g_pad[mstart : mstart + cnt, :n] = geno[pstart : pstart + cnt]
        m_pad[mstart : mstart + cnt, 0] = mean[pstart : pstart + cnt]
        iv_pad[mstart : mstart + cnt, 0] = inv[pstart : pstart + cnt]

    sh = NamedSharding(mesh, P(VARIANT_AXIS, None))
    return ShardedMatrix(
        geno=jax.device_put(g_pad, sh),
        mean=jax.device_put(m_pad, sh),
        inv_std=jax.device_put(iv_pad, sh),
        n_rows=d,
        n_samples=n,
        mesh=mesh,
        tile_d=tile_d,
        kernel_precision="f32",
        row_segments=np.asarray(segs, dtype=np.int64),
    )


@pytest.fixture
def seg_pair(rng):
    geno = make_genotypes(rng, 200, 40, missing_rate=0.02)
    mesh = make_mesh()
    prefix = ShardedMatrix.from_arrays(
        iter([geno]), mesh=mesh, tile_d=64, kernel_precision="f32"
    )
    seg = _segmented_matrix(geno, mesh, seg_break=120, rows_pp=512)
    return geno, prefix, seg


def test_segmented_matches_prefix_passes(rng, seg_pair):
    geno, prefix, seg = seg_pair
    b = jnp.asarray(rng.standard_normal((40, 6)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(seg.gram_apply(b)), np.asarray(prefix.gram_apply(b)),
        rtol=1e-4, atol=1e-2,
    )
    np.testing.assert_allclose(
        np.asarray(seg.tsq_accumulate(b)),
        np.asarray(prefix.tsq_accumulate(b)),
        rtol=1e-4, atol=1e-1,
    )
    # right_apply returns rows in PcaSnpId order despite the segment gap.
    np.testing.assert_allclose(
        seg.right_apply(b), prefix.right_apply(b), rtol=1e-4, atol=1e-2
    )


def test_segmented_pca_core_matches(rng, seg_pair):
    _geno, prefix, seg = seg_pair
    b0 = jnp.asarray(rng.standard_normal((40, 8)).astype(np.float32))
    v1, s1, e1, l1 = prefix.pca_core(b0, 3, 4)
    v2, s2, e2, l2 = seg.pca_core(b0, 3, 4)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-4)
    for j in range(4):
        r = np.corrcoef(np.asarray(v1)[:, j], np.asarray(v2)[:, j])[0, 1]
        assert abs(r) > 0.9999
        rl = np.corrcoef(l1[:, j], l2[:, j])[0, 1]
        assert abs(rl) > 0.9999


def test_segmented_count_missing(seg_pair):
    geno, prefix, seg = seg_pair
    true_missing = int((geno == MISSING).sum())
    assert prefix.count_missing() == true_missing
    # Inter-segment padding is MISSING-filled and must NOT be counted.
    assert seg.count_missing() == true_missing


def test_segmented_fetch_blocks_and_translation(rng, seg_pair):
    _geno, prefix, seg = seg_pair
    starts = np.array([0, 60, 130], dtype=np.int64)
    lens = np.array([50, 60, 70], dtype=np.int64)
    out_p = np.asarray(prefix.fetch_blocks_device(starts, lens, 128))
    out_s = np.asarray(seg.fetch_blocks_device(starts, lens, 128))
    np.testing.assert_allclose(out_s, out_p, rtol=1e-5, atol=1e-5)

    runs_ok = np.stack([starts, lens], axis=1)
    assert seg.runs_device_sliceable(runs_ok)
    # A run crossing the pca-row 120 segment boundary is rejected.
    runs_bad = np.array([[100, 40]], dtype=np.int64)
    assert not seg.runs_device_sliceable(runs_bad)
    with pytest.raises(ValueError):
        seg.translate_row_runs(runs_bad[:, 0], runs_bad[:, 1])
    # Zero-length batch-padding runs are always fine.
    assert seg.runs_device_sliceable(np.array([[0, 0], [130, 0]]))


def test_assignment_fast_path_matches_bruteforce(rng):
    """Non-overlapping searchsorted fast path == brute-force first-
    containing-block walk; overlapping files use the reference walk."""
    n = 2000
    bp = np.sort(rng.integers(1, 100_000, size=n)).astype(np.int64)
    chroms = np.where(rng.random(n) < 0.5, "1", "2").tolist()

    def brute(blocks):
        out = np.full(n, -1, dtype=np.int64)
        for i in range(n):
            for b, (c, s, e, _t) in enumerate(blocks):
                if c == str(chroms[i]) and s <= bp[i] <= e:
                    out[i] = b
                    break
        return out

    # Non-overlapping per chromosome (fast path).
    edges = np.sort(rng.choice(np.arange(1, 100_000), size=40, replace=False))
    blocks = []
    for c in ("1", "2"):
        for j in range(0, len(edges) - 1, 2):
            blocks.append((c, int(edges[j]), int(edges[j + 1]) - 1, f"{c}:{j}"))
    got = assign_first_containing_block(chroms, bp, blocks)
    np.testing.assert_array_equal(got, brute(blocks))

    # Overlapping blocks (reference file-order walk).
    blocks_ov = [
        ("1", 10, 50_000, "a"),
        ("1", 40_000, 90_000, "b"),
        ("2", 1, 99_999, "c"),
        ("2", 500, 600, "d"),
    ]
    got_ov = assign_first_containing_block(chroms, bp, blocks_ov)
    np.testing.assert_array_equal(got_ov, brute(blocks_ov))


# ---------------------------------------------------------------------
# from_owned_units (per-host unit-sharded ingestion, single-process)
# ---------------------------------------------------------------------

def test_from_owned_units_matches_from_arrays(rng):
    """Unit-sharded assembly (the per-host VCF file-sharding layout) must
    match the plain concatenated pack numerically: same gram/tsq
    outputs, loadings in global unit order."""
    from genomic_pca_tpu.ops.qc import (
        dosage_mean_from_counts, genotype_counts_int8_host,
    )
    from genomic_pca_tpu.parallel.sharded import pack_int8_rows

    n_samples = 40
    counts = [70, 0, 45, 33]
    genos = [
        make_genotypes(rng, c, n_samples, missing_rate=0.0) if c else
        np.zeros((0, n_samples), np.int8)
        for c in counts
    ]
    mesh = make_mesh(jax.devices()[:2])

    local_units = {}
    for u, g in enumerate(genos):
        if len(g) == 0:
            continue
        m = dosage_mean_from_counts(genotype_counts_int8_host(g))
        local_units[u] = (pack_int8_rows(g), m.astype(np.float32), None)
    seg = ShardedMatrix.from_owned_units(
        np.asarray(counts), np.zeros(4, np.int64), local_units,
        n_samples=n_samples, mesh=mesh, tile_d=32, packed=True,
        center_only=True,
    )
    ref = ShardedMatrix.from_arrays(
        iter([np.concatenate(genos)]), center_only=True, mesh=mesh,
        tile_d=32,
    )
    assert seg.row_segments is not None and len(seg.row_segments) == 3
    b = jnp.asarray(
        np.random.default_rng(3).standard_normal((n_samples, 6)),
        dtype=jnp.float32,
    )
    np.testing.assert_allclose(
        np.asarray(seg.gram_apply(b)), np.asarray(ref.gram_apply(b)),
        rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(seg.tsq_accumulate(b)), np.asarray(ref.tsq_accumulate(b)),
        rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        seg.right_apply(b), ref.right_apply(b), rtol=1e-5, atol=1e-4,
    )


def test_from_owned_units_rejects_foreign_unit(rng):
    g = make_genotypes(rng, 8, 16, missing_rate=0.0)
    mesh = make_mesh(jax.devices()[:1])
    with pytest.raises(ValueError, match="no devices"):
        ShardedMatrix.from_owned_units(
            np.asarray([8]), np.asarray([3]), {0: (g, np.zeros(8), None)},
            n_samples=16, mesh=mesh, tile_d=8, center_only=True,
        )


def test_segmented_left_apply_matches_prefix(rng, seg_pair):
    """left_apply (the device projection path) places row-space inputs
    through the segment map — w rows must land beside their genotype
    rows despite the inter-segment padding gap."""
    _geno, prefix, seg = seg_pair
    w = rng.standard_normal((prefix.n_rows, 5)).astype(np.float32)
    np.testing.assert_allclose(
        seg.left_apply(w), prefix.left_apply(w), rtol=1e-4, atol=1e-2
    )
