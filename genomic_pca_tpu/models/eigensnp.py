"""EigenSNP two-stage PCA: per-LD-block local bases -> condensed global
eigensolve -> streamed refinement.

Re-creation of `efficient_pca::eigensnp::EigenSNPCoreAlgorithm`, whose
contract is characterized from its call sites and config
(/root/reference/src/main.rs:311-327, 359-366; SURVEY §2.4):

  Stage 1 — for each LD block, learn a local SNP basis by randomized SVD
  of the standardized block restricted to a deterministic sample subset
  (subset_factor x N clamped to [min,max], main.rs:314-316), with
  `components_per_block` components and local oversampling / power
  iterations.

  Stage 2 — project ALL samples through every block basis, stack the
  condensed (sum_b c_b) x N feature matrix, and run a global randomized
  PCA (global oversampling / power iterations) for `k_global` PCs.

  Refinement — `refine_passes` subspace-iteration passes over the FULL
  standardized matrix, streamed in `snp_strip_size` strips
  (the reference streams loadings/score re-estimation the same way);
  a final small eigensolve extracts scores, eigenvalues and loadings.

Device mapping: every stage is matmuls over static-shaped blocks (ragged
LD blocks are zero-padded to coarse row buckets so XLA compiles a handful
of kernel shapes, not one per block — padded rows standardize to zero and
drop out of the math).  The refinement operates on the StripedMatrix
engine, so it shards over the variant axis unchanged (parallel/).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from genomic_pca_tpu.config import EigenSnpConfig
from genomic_pca_tpu.errors import ComputeError
from genomic_pca_tpu.models.pca import lane_fill_width
from genomic_pca_tpu.models.prepare import PreparedData
from genomic_pca_tpu.ops.rsvd import rsvd
from genomic_pca_tpu.utils.rng import (
    key_for_stage, key_from_words, seed_words,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EigenSnpResult:
    """Equivalent of `EigenSNPCoreOutput` (main.rs:389-407)."""

    scores: np.ndarray  # (N, K) f32 final sample PC scores
    eigenvalues: np.ndarray  # (K,) f64
    loadings: np.ndarray  # (D, K) f32 per-SNP loadings
    diagnostics: Optional[Dict] = None
    # Always-on stage wall-clocks (matrix_load / stages_1_2 / global_pca
    # / refinement_finalize) — the diagnostics run records the same
    # table but takes the per-pass code path; this field attributes the
    # PRODUCTION (fused pca_core) path.
    stage_seconds: Optional[Dict[str, float]] = None


def _bucket_rows(d: int, bucket: int = 512) -> int:
    """Next bucket multiple >= d (caps the number of compiled shapes)."""
    return max(bucket, ((d + bucket - 1) // bucket) * bucket)


def _dot_hi(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.dot(
        a, b, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


@jax.jit
def _project_blocks_batched(u: jax.Array, x: jax.Array) -> jax.Array:
    """Batched U_b^T X_b: (B, bucket, c) x (B, bucket, N) -> (B, c, N)."""
    return jax.lax.dot_general(
        u, x,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


@functools.partial(jax.jit, static_argnames=("n_cols",))
def _standardize_packed_stack(
    pk8: jax.Array,  # (B, R, n4) uint8 PLINK bytes
    mean: jax.Array,  # (B, R) f32
    inv: jax.Array,  # (B, R) f32
    n_cols: int,
) -> jax.Array:
    """(B, R, n_cols) f32 standardized blocks unpacked on device —
    ORIGINAL sample order (interleave reshape).  Missing (code 01) and
    inert rows (inv_std 0) standardize to zero."""
    c = pk8.astype(jnp.int32)
    b, r, n4 = c.shape
    cs = jnp.stack(
        [(c >> (2 * p)) & 3 for p in range(4)], axis=-1
    ).reshape(b, r, 4 * n4)
    x = ((4 - cs) >> 1).astype(jnp.float32) * inv[..., None] + (
        -mean * inv
    )[..., None]
    return jnp.where(cs != 1, x, 0.0)[:, :, :n_cols]


@jax.jit
def _standardize_packed_stack_cols(
    pk8: jax.Array,  # (B, R, n4) uint8
    mean: jax.Array,  # (B, R) f32
    inv: jax.Array,  # (B, R) f32
    col_idx: jax.Array,  # (C,) int32 sample columns
) -> jax.Array:
    """(B, R, C) f32 standardized blocks restricted to `col_idx` — the
    subset is extracted straight from the packed bytes (byte gather +
    per-column plane shift), never materializing the full width."""
    c = pk8.astype(jnp.int32)
    byte = col_idx // 4
    shift = (2 * (col_idx % 4)).astype(jnp.int32)
    cb = jnp.take(c, byte, axis=2)  # (B, R, C)
    cp = (cb >> shift[None, None, :]) & 3
    x = ((4 - cp) >> 1).astype(jnp.float32) * inv[..., None] + (
        -mean * inv
    )[..., None]
    return jnp.where(cp != 1, x, 0.0)


@functools.lru_cache(maxsize=None)
def _fused_stage12_device_prog(
    packed: bool,
    bucket: int,
    c_b: int,
    n_os: int,
    n_pi: int,
    full_cols: bool,
):
    """ONE compiled program for a whole stage-1+2 block group: slice the
    blocks from the resident matrix, restrict to the sample subset,
    batched local rSVD, and project ALL samples through the bases.

    Replaces four separate programs per group (subset slice, full
    slice, rsvd, projection) — fewer compiles and dispatches, and the
    full-width f32 blocks never leave the program.
    """
    from genomic_pca_tpu.parallel.sharded import (
        _slice_blocks_impl, _slice_blocks_packed_impl,
    )

    impl = _slice_blocks_packed_impl if packed else _slice_blocks_impl

    @jax.jit
    def run(geno, mean, inv, starts, lens, subset_idx, kwords, units):
        keys = _unit_keys(kwords, units)
        xs_full = impl(geno, mean, inv, starts, lens, None, bucket)
        if full_cols:
            xs_sub = xs_full[:, :, : subset_idx.shape[0]]
        else:
            xs_sub = impl(geno, mean, inv, starts, lens, subset_idx, bucket)

        def one(x, key):
            # cholqr2 stabilizer: Householder QR under vmap compiles to
            # a large batched loop (seconds of XLA time per fused
            # program on the cold path) and is latency-bound.
            return rsvd(x, key, k=c_b, n_oversamples=n_os,
                        n_power_iter=n_pi, orth="cholqr2")

        u, s, _ = jax.vmap(one)(xs_sub, keys)
        out = jax.lax.dot_general(
            u, xs_full,
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return u, s, out

    return run


@functools.lru_cache(maxsize=None)
def _fused_stage12_host_packed_prog(
    c_b: int, n_os: int, n_pi: int, n_cols: int, full_cols: bool
):
    """Fused stage-1+2 for host-accessor PACKED batches: each block's
    raw PLINK bytes upload ONCE and both the subset rSVD and the
    all-samples projection happen in one program — the previous
    structure uploaded every block twice (stage-1 subset fetch, then
    stage-2 full fetch), which doubled the streaming path's link
    traffic."""

    @jax.jit
    def run(pk8, mean, inv, subset_idx, kwords, units):
        keys = _unit_keys(kwords, units)
        xs_full = _standardize_packed_stack(pk8, mean, inv, n_cols)
        if full_cols:
            xs_sub = xs_full
        else:
            xs_sub = _standardize_packed_stack_cols(pk8, mean, inv, subset_idx)

        def one(x, key):
            # cholqr2 stabilizer: Householder QR under vmap compiles to
            # a large batched loop (seconds of XLA time per fused
            # program on the cold path) and is latency-bound.
            return rsvd(x, key, k=c_b, n_oversamples=n_os,
                        n_power_iter=n_pi, orth="cholqr2")

        u, s, _ = jax.vmap(one)(xs_sub, keys)
        out = _project_blocks_batched(u, xs_full)
        return u, s, out

    return run


@functools.lru_cache(maxsize=None)
def _fused_stage12_host_dense_prog(
    c_b: int, n_os: int, n_pi: int, full_cols: bool
):
    """Fused stage-1+2 for host-accessor DENSE (f32) batches: the
    full-width standardized block uploads once; the subset extracts on
    device (saves the separate subset-width upload)."""

    @jax.jit
    def run(xs_full, subset_idx, kwords, units):
        keys = _unit_keys(kwords, units)
        xs_sub = (
            xs_full if full_cols else jnp.take(xs_full, subset_idx, axis=2)
        )

        def one(x, key):
            # cholqr2 stabilizer: Householder QR under vmap compiles to
            # a large batched loop (seconds of XLA time per fused
            # program on the cold path) and is latency-bound.
            return rsvd(x, key, k=c_b, n_oversamples=n_os,
                        n_power_iter=n_pi, orth="cholqr2")

        u, s, _ = jax.vmap(one)(xs_sub, keys)
        out = _project_blocks_batched(u, xs_full)
        return u, s, out

    return run


def _unit_keys(kwords, units) -> jax.Array:
    """In-program per-unit sketch keys from raw seed words (trace-safe;
    unit 0 is the bare stage key, used for batch padding).  Same values
    as the scalar `key_for_stage(seed, "eigensnp_local_sketch", unit=u)`
    convention — deriving keys inside the fused programs keeps the
    eager `jax.random.key`/`fold_in` op compiles (one each, cold) off
    the critical path entirely."""
    stage_key = key_from_words(kwords, "eigensnp_local_sketch")

    def one(u):
        return jax.lax.cond(
            u != 0,
            lambda: jax.random.fold_in(stage_key, u),
            lambda: stage_key,
        )

    return jax.vmap(one)(units)


@functools.partial(
    jax.jit, static_argnames=("k", "n_os", "n_pi", "ell_ref")
)
def _global_basis_prog(y, kwords, k, n_os, n_pi, ell_ref):
    """Stage-2 global rSVD + lane-fill widening as ONE program: rsvd of
    the condensed matrix, orthonormal score basis, random widening to
    the refinement width, final QR.  (Previously ~6 separate small
    programs — each a compile on cold start.)  Takes raw seed
    words; the sketch/fill keys derive in-program (no eager key-op
    compiles on the cold path)."""
    n = y.shape[1]
    gkey = key_from_words(kwords, "eigensnp_global_sketch")
    fkey = key_from_words(kwords, "eigensnp_refine_fill")
    _, _, vt_g = rsvd(y, gkey, k=k, n_oversamples=n_os, n_power_iter=n_pi)
    s_basis, _ = jnp.linalg.qr(vt_g.T)  # (N, k)
    if ell_ref > k:
        extra = jax.random.normal(fkey, (n, ell_ref - k), dtype=jnp.float32)
        s_basis, _ = jnp.linalg.qr(
            jnp.concatenate([s_basis, extra], axis=1)
        )
    return s_basis


@functools.lru_cache(maxsize=None)
def _finish_parts_jit(n: int):
    """Fetch-side assembly as ONE program: flatten every base and
    singular-value batch, and gather the condensed matrix rows.  Shapes
    differ per run layout; jit retraces per layout (one program per
    workflow shape instead of ~10 reshape/concat programs)."""

    @jax.jit
    def run(us, ss, outs, perm):
        u_flat = jnp.concatenate([u.reshape(-1) for u in us]) if us else None
        s_flat = jnp.concatenate([s.reshape(-1) for s in ss]) if ss else None
        y_cat = jnp.concatenate(
            [o.reshape(o.shape[0] * o.shape[1], -1)[:, :n] for o in outs]
        )
        y = jnp.take(y_cat, perm, axis=0)
        return u_flat, s_flat, y

    return run


def _finish_parts_prog(us, ss, outs, perm, n: int):
    return _finish_parts_jit(n)(us, ss, outs, perm)


@functools.lru_cache(maxsize=None)
def _y_update_jit():
    """Donated row-block update of the condensed matrix: the (C, N)
    buffer is written in place per chunk, so per-chunk projection
    outputs never accumulate and no concat transient exists (the
    one-shot gather assembly peaks at 3x (C, N) device bytes at genome
    block counts — observed ResourceExhausted on shared-HBM pools)."""
    import functools as _ft

    @_ft.partial(jax.jit, donate_argnums=0)
    def upd(y, o, j, r0):
        # Select + trim the chunk's j-th block INSIDE the program: an
        # eager `o[j, :, :n]` would compile one slice program per
        # distinct j on the cold path.
        rows = jax.lax.dynamic_index_in_dim(
            o, j, axis=0, keepdims=False
        )[:, : y.shape[1]]
        return jax.lax.dynamic_update_slice(y, rows, (r0, jnp.int32(0)))

    return upd


@functools.lru_cache(maxsize=None)
def _finish_us_jit():
    """Flatten every base / singular-value batch into ONE transfer each
    (per-chunk fetches would sync the host with the device per
    chunk)."""

    @jax.jit
    def run(us, ss):
        return (
            jnp.concatenate([u.reshape(-1) for u in us]),
            jnp.concatenate([s.reshape(-1) for s in ss]),
        )

    return run


def _assemble_condensed(parts, n: int, n_blocks: int):
    """Shared stage-1+2 finisher: fetch all bases/singular values in ONE
    flattened transfer each, and assemble the condensed matrix on device
    with a single permutation gather — all in one compiled program.

    `parts` is [(chunk, c_b, u_dev, s_dev or None, out_dev)] in any
    order; returns (bases dict, svals dict, y device (C, n)).
    """
    bases: Dict[int, np.ndarray] = {}
    svals: Dict[int, np.ndarray] = {}
    with_s = [p for p in parts if p[3] is not None]

    # Permutation over the PADDED concatenation of all out batches
    # (batch-padding rows are skipped, real rows land in block order).
    row_start: Dict[int, int] = {}
    row_cnt: Dict[int, int] = {}
    cursor = 0
    for chunk, c_b, _u, _s, out in parts:
        for j, i in enumerate(chunk):
            row_start[i] = cursor + j * c_b
            row_cnt[i] = c_b
        cursor += out.shape[0] * c_b
    perm = np.concatenate(
        [
            np.arange(row_start[i], row_start[i] + row_cnt[i], dtype=np.int32)
            for i in range(n_blocks)
        ]
    )

    # perm passes as numpy: jit transfers it at dispatch with no eager
    # convert program (and it matches the precompile's np.zeros aval).
    u_flat, s_flat, y = _finish_parts_prog(
        [p[2] for p in with_s],
        [p[3] for p in with_s],
        [p[4] for p in parts],
        perm,
        n,
    )
    if with_s:
        u_flat = np.asarray(u_flat)
        s_flat = np.asarray(s_flat)
        u_ofs = s_ofs = 0
        for chunk, _c_b, u_dev, s_dev, _out in with_s:
            u_np = u_flat[u_ofs : u_ofs + u_dev.size].reshape(u_dev.shape)
            s_np = s_flat[s_ofs : s_ofs + s_dev.size].reshape(s_dev.shape)
            u_ofs += u_dev.size
            s_ofs += s_dev.size
            for j, i in enumerate(chunk):
                bases[i] = u_np[j]
                svals[i] = s_np[j]
    return bases, svals, y


_STAGE12_BUDGET_ELEMS = 256 * 1024 * 1024


def _device_group_plan(a, prep, cfg: EigenSnpConfig, subset: np.ndarray):
    """Ordered [(bucket, c_b, n_blocks, chunk_b)] — exactly the grouping
    and batch size `_stages12_device` will execute, shared with the
    background precompiler so lowered signatures match the real calls."""
    groups: Dict[tuple, List[int]] = {}
    for b_idx, block in enumerate(prep.blocks):
        d_b = len(block.pca_snp_ids)
        c_b = min(cfg.components_per_block, d_b, len(subset))
        bucket = min(_bucket_rows(d_b), a.d_pad)
        groups.setdefault((bucket, c_b), []).append(b_idx)
    plan = []
    for (bucket, c_b), idxs in sorted(groups.items()):
        b_cap = max(1, _STAGE12_BUDGET_ELEMS // (bucket * a.n_pad))
        chunk_b = _pow2_at_most(min(b_cap, max(len(idxs), 1)))
        plan.append((bucket, c_b, len(idxs), chunk_b))
    return plan


def _pow2_at_most(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def _choose_sample_subset(cfg: EigenSnpConfig, n_samples: int) -> np.ndarray:
    """Deterministic sample subset for local basis learning (sorted)."""
    n_subset = cfg.subset_size(n_samples)
    if n_subset >= n_samples:
        return np.arange(n_samples, dtype=np.int64)
    perm = np.asarray(_subset_perm_prog(seed_words(cfg.seed), n_samples))
    return np.sort(perm[:n_subset]).astype(np.int64)


@functools.partial(jax.jit, static_argnames=("n_samples",))
def _subset_perm_prog(kwords, n_samples: int):
    """Sample-subset permutation as ONE program (same values as the
    previous eager `key_for_stage` + `jax.random.permutation` chain,
    which cost ~3 cold compiles)."""
    return jax.random.permutation(
        key_from_words(kwords, "eigensnp_sample_subset"), n_samples
    )


def _blocks_as_runs(blocks) -> Optional[np.ndarray]:
    """(B, 2) [start, len] when every block is a contiguous PcaSnpId run.

    LD blocks are disjoint genomic intervals over position-sorted BIM
    rows, so in practice each block's dense PcaSnpId set is a contiguous
    run; nested/overlapping block files (first-containing-block
    semantics) can break that, hence the runtime check.  Returns None if
    any block is not a run — callers fall back to the host accessor.
    """
    runs = np.empty((len(blocks), 2), dtype=np.int64)
    for i, b in enumerate(blocks):
        ids = b.pca_snp_ids
        if len(ids) == 0 or int(ids[-1]) - int(ids[0]) + 1 != len(ids):
            return None
        runs[i] = (int(ids[0]), len(ids))
    return runs


def _stage_units(chunk: List[int], chunk_b: int) -> np.ndarray:
    """Host-side per-block unit ids feeding `_unit_keys` inside the
    fused programs (unit 0 = bare stage key, used for batch padding)."""
    units = np.zeros(chunk_b, dtype=np.int32)
    units[: len(chunk)] = np.asarray(chunk, dtype=np.int32) + 1
    return units


def _stages12_device(
    a,  # ShardedMatrix (HBM-resident int8 + moments)
    prep: PreparedData,
    cfg: EigenSnpConfig,
    subset: np.ndarray,
    runs: np.ndarray,
    saved_bases: Optional[List[np.ndarray]],
):
    """Stages 1+2 sliced from the device-resident matrix.

    The genotypes were already decoded and uploaded once for the
    refinement engine; re-using them here removes the two extra BED
    passes and the standardized-f32 host->device uploads of the host
    accessor path (4x the int8 bytes).  Numerics are identical: same
    standardization, same per-block sketch keys, same batched rSVD.

    Returns (local_bases [np arrays], svals or None, y device (C, N)).
    """
    n = prep.n_samples
    groups: Dict[tuple, List[int]] = {}
    for b_idx, block in enumerate(prep.blocks):
        d_b = len(block.pca_snp_ids)
        c_b = min(cfg.components_per_block, d_b, len(subset))
        bucket = min(_bucket_rows(d_b), a.d_pad)
        groups.setdefault((bucket, c_b), []).append(b_idx)

    # device_put (a pure transfer) rather than jnp.asarray (whose eager
    # dtype-convert is a compiled program — one more cold compile).
    subset_dev = jax.device_put(np.asarray(subset, dtype=np.int32))
    kwords = seed_words(cfg.seed)
    full_cols = len(subset) >= n  # subset == all samples: reuse the full fetch
    budget_elems = _STAGE12_BUDGET_ELEMS
    saved: Dict[int, np.ndarray] = {}
    # All device work enqueues asynchronously; NOTHING is fetched inside
    # the loop (a mid-loop np.asarray is a host-device sync, and two
    # per chunk serialize the whole stage at genome-wide block counts).
    # Each group
    # chunk is ONE fused program (slice + subset + batched rSVD +
    # projection); bases and singular values come back in ONE flattened
    # transfer each at the end, and the condensed matrix is assembled on
    # device with a single permutation gather.
    def run_group(item) -> List[tuple]:
        (bucket, c_b), idxs = item
        b_cap = max(1, budget_elems // (bucket * a.n_pad))
        chunk_b = _pow2_at_most(min(b_cap, max(len(idxs), 1)))
        out_parts: List[tuple] = []
        for pos in range(0, len(idxs), chunk_b):
            chunk = idxs[pos : pos + chunk_b]
            starts = np.zeros(chunk_b, dtype=np.int64)
            lens = np.zeros(chunk_b, dtype=np.int64)
            starts[: len(chunk)] = runs[chunk, 0]
            lens[: len(chunk)] = runs[chunk, 1]
            if saved_bases is not None:
                xs_full = a.fetch_blocks_device(starts, lens, bucket, None)
                us = [saved_bases[i] for i in chunk]
                us += [np.zeros_like(us[0])] * (chunk_b - len(chunk))
                u_batch = jnp.asarray(np.stack(us))
                for j, i in enumerate(chunk):
                    saved[i] = us[j]
                out = _project_blocks_batched(u_batch, xs_full)
                out_parts.append((list(chunk), c_b, u_batch, None, out))
            else:
                run = _fused_stage12_device_prog(
                    a.packed, bucket, c_b,
                    cfg.local_oversampling, cfg.local_power_iter, full_cols,
                )
                mstarts = a.translate_row_runs(starts, lens)
                # Small integer operands pass as numpy: jit transfers
                # them at dispatch with NO eager convert compile.
                u_batch, s_batch, out = run(
                    a.geno, a.mean, a.inv_std,
                    np.asarray(mstarts, dtype=np.int32),
                    np.asarray(lens, dtype=np.int32),
                    subset_dev,
                    kwords,
                    _stage_units(chunk, chunk_b),
                )
                out_parts.append((list(chunk), c_b, u_batch, s_batch, out))
        return out_parts

    # Distinct (bucket, c_b) groups use DISTINCT compiled programs, so
    # running groups on a small thread pool overlaps their first-use
    # compile/executable-load round-trips (the cold-start cost on
    # remote-compile backends); dispatch order within a group — and the
    # assembled part order — is unchanged, so results are identical.
    groups_sorted = sorted(groups.items())
    parts: List[tuple] = []
    if len(groups_sorted) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(4, len(groups_sorted))) as ex:
            for out_parts in ex.map(run_group, groups_sorted):
                parts.extend(out_parts)
    else:
        parts.extend(run_group(groups_sorted[0]))

    bases, svals, y = _assemble_condensed(parts, n, len(prep.blocks))
    if saved_bases is not None:
        bases = saved
    local_bases = [bases[i] for i in range(len(prep.blocks))]
    return local_bases, (svals if saved_bases is None else None), y


def _stages12_host(
    prep: PreparedData,
    cfg: EigenSnpConfig,
    subset: np.ndarray,
    saved_bases: Optional[List[np.ndarray]],
):
    """Stages 1+2 through the host accessor (streaming / non-run blocks).

    With the packed pipeline and a full sample set, blocks upload as RAW
    PLINK bytes and standardize on device
    (`prep.fetch_block_packed` + `_standardize_packed_stack*`) — 16x
    less host->device traffic than standardized-f32 blocks, which is
    what makes bigger-than-HBM (streaming-matrix) EigenSNP runs viable.
    Keep-list runs fall back to the decoded f32 accessor.

    Returns (local_bases, svals or None, y device (C, N))."""
    n = prep.n_samples
    packed = getattr(prep, "supports_packed_blocks", False)
    # device_put (pure transfer) rather than jnp.asarray (whose eager
    # dtype-convert is a compiled program — one more cold compile).
    subset_dev = jax.device_put(np.asarray(subset, dtype=np.int32))
    kwords = seed_words(cfg.seed)

    def fetch_batch(chunk: List[int], bucket: int, chunk_b: int, cols):
        """(chunk_b, bucket, C) f32 standardized batch on device.

        `cols` is the subset array or None for all samples; batch
        padding uses inert blocks (all-missing / zero)."""
        if packed:
            raws, ms, ivs = zip(
                *(
                    prep.fetch_block_packed(
                        prep.blocks[i].pca_snp_ids, pad_rows_to=bucket
                    )
                    for i in chunk
                )
            )
            raws, ms, ivs = list(raws), list(ms), list(ivs)
            while len(raws) < chunk_b:  # inert all-missing blocks
                raws.append(np.full_like(raws[0], 0x55))
                ms.append(np.zeros_like(ms[0]))
                ivs.append(np.zeros_like(ivs[0]))
            pk8 = jnp.asarray(np.stack(raws))
            mean = jnp.asarray(np.stack(ms))
            inv = jnp.asarray(np.stack(ivs))
            if cols is None:
                return _standardize_packed_stack(pk8, mean, inv, n)
            return _standardize_packed_stack_cols(pk8, mean, inv, subset_dev)
        xs = [
            prep.fetch_block_standardized(
                prep.blocks[i].pca_snp_ids, cols, pad_rows_to=bucket
            )
            for i in chunk
        ]
        while len(xs) < chunk_b:  # batch padding: inert zero blocks
            xs.append(np.zeros_like(xs[0]))
        return jnp.asarray(np.stack(xs))

    groups: Dict[tuple, List[int]] = {}
    for b_idx, block in enumerate(prep.blocks):
        d_b = len(block.pca_snp_ids)
        c_b = min(cfg.components_per_block, d_b, len(subset))
        groups.setdefault((_bucket_rows(d_b), c_b), []).append(b_idx)

    budget_elems = 256 * 1024 * 1024
    full_cols = len(subset) >= n
    parts: List[tuple] = []  # (chunk, c_b, u_dev, s_dev or None, out_dev)

    if saved_bases is None:
        # Each block's bytes upload ONCE and run through one fused
        # program (standardize + subset rSVD + all-samples projection);
        # nothing is fetched inside the loop (a mid-loop np.asarray is a
        # host-device sync) — bases and singular
        # values return in one flattened transfer each at the end.
        def fetch_raw(chunk, bucket, chunk_b):
            """HOST-side only (runs on prefetch worker threads): mmap
            gather + stack.  The device upload happens on the MAIN
            thread, in dispatch order."""
            raws, ms, ivs = zip(
                *(
                    prep.fetch_block_packed(
                        prep.blocks[i].pca_snp_ids, pad_rows_to=bucket
                    )
                    for i in chunk
                )
            )
            raws, ms, ivs = list(raws), list(ms), list(ivs)
            while len(raws) < chunk_b:  # inert all-missing blocks
                raws.append(np.full_like(raws[0], 0x55))
                ms.append(np.zeros_like(ms[0]))
                ivs.append(np.zeros_like(ivs[0]))
            return (np.stack(raws), np.stack(ms), np.stack(ivs))

        # Flatten (group, chunk) work items so the HOST side (mmap
        # gather + stack + upload enqueue) double-buffers ahead of the
        # device dispatches: at genome block counts the serialized
        # per-chunk fetch+upload round trip dominates this stage, and
        # prefetching it on worker threads hides it under the
        # in-flight dispatch.  Dispatch order — and therefore results —
        # is unchanged.
        tasks: List[tuple] = []
        for (bucket, c_b), idxs in sorted(groups.items()):
            b_cap = max(1, budget_elems // (bucket * max(n, 1)))
            chunk_b = _pow2_at_most(min(b_cap, max(len(idxs), 1)))
            for pos in range(0, len(idxs), chunk_b):
                tasks.append((bucket, c_b, idxs[pos : pos + chunk_b], chunk_b))

        from concurrent.futures import ThreadPoolExecutor

        def _fetch_task(t):
            """HOST-side gather only — the device transfer happens at
            dispatch time on the main thread."""
            bucket, _c_b, chunk, chunk_b = t
            if packed:
                return fetch_raw(chunk, bucket, chunk_b)
            xs = [
                prep.fetch_block_standardized(
                    prep.blocks[i].pca_snp_ids, None, pad_rows_to=bucket
                )
                for i in chunk
            ]
            while len(xs) < chunk_b:  # batch padding: inert zero blocks
                xs.append(np.zeros_like(xs[0]))
            return np.stack(xs)

        # Incremental condensed assembly: each chunk's projection rows
        # land in ONE preallocated (C_total, n) buffer via donated
        # in-place updates, in block order.  Outs never accumulate and
        # the finisher has no multi-GB concat/gather transient.
        row0_of: Dict[int, int] = {}
        cursor = 0
        for b_idx, block in enumerate(prep.blocks):
            c_b0 = min(
                cfg.components_per_block, len(block.pca_snp_ids),
                len(subset),
            )
            row0_of[b_idx] = cursor
            cursor += c_b0
        y_dev = jnp.zeros((cursor, n), dtype=jnp.float32)
        y_upd = _y_update_jit()

        depth = 2  # chunks in flight beyond the current dispatch
        window = 6  # dispatched-but-unconfirmed chunks before a fence
        with ThreadPoolExecutor(depth) as ex:
            futs = [ex.submit(_fetch_task, t) for t in tasks[:depth]]
            for i, (bucket, c_b, chunk, chunk_b) in enumerate(tasks):
                fetched = futs[i].result()
                # Drop the Future: it retains its result, and at genome
                # chunk counts the retained per-chunk upload buffers sum
                # to more than HBM (observed ResourceExhausted ~300
                # chunks into a 512-chunk biobank stage 1).
                futs[i] = None
                if i + depth < len(tasks):
                    futs.append(ex.submit(_fetch_task, tasks[i + depth]))
                if i >= window and i % window == 0:
                    # Backpressure: force execution (and input-buffer
                    # release) through chunk i - window before enqueuing
                    # more — unbounded async enqueue piles every chunk's
                    # uploaded input into device buffers
                    # (observed ResourceExhausted at genome block
                    # counts).  The fence fetches a tiny (B, c_b)
                    # singular-value block — a true host sync, ~bytes —
                    # once per window, bounding in-flight chunks to
                    # ~2x window without serializing every dispatch.
                    _fence = parts[i - window][3]
                    if _fence is not None:
                        np.asarray(_fence[:1, :1])
                units = _stage_units(chunk, chunk_b)
                if packed:
                    pk8, mean, inv = fetched
                    run = _fused_stage12_host_packed_prog(
                        c_b, cfg.local_oversampling, cfg.local_power_iter,
                        n, full_cols,
                    )
                    u_batch, s_batch, out = run(
                        pk8, mean, inv, subset_dev, kwords, units
                    )
                else:
                    run = _fused_stage12_host_dense_prog(
                        c_b, cfg.local_oversampling, cfg.local_power_iter,
                        full_cols,
                    )
                    u_batch, s_batch, out = run(
                        fetched, subset_dev, kwords, units
                    )
                for j, b_idx in enumerate(chunk):
                    y_dev = y_upd(
                        y_dev, out, np.int32(j), np.int32(row0_of[b_idx])
                    )
                parts.append((list(chunk), c_b, u_batch, s_batch, None))

        u_flat, s_flat = _finish_us_jit()(
            [p[2] for p in parts], [p[3] for p in parts]
        )
        u_flat = np.asarray(u_flat)
        s_flat = np.asarray(s_flat)
        bases: Dict[int, np.ndarray] = {}
        svals: Dict[int, np.ndarray] = {}
        u_ofs = s_ofs = 0
        for chunk, _c_b, u_dev, s_dev, _out in parts:
            u_np = u_flat[u_ofs : u_ofs + u_dev.size].reshape(u_dev.shape)
            s_np = s_flat[s_ofs : s_ofs + s_dev.size].reshape(s_dev.shape)
            u_ofs += u_dev.size
            s_ofs += s_dev.size
            for j, b_idx in enumerate(chunk):
                bases[b_idx] = u_np[j]
                svals[b_idx] = s_np[j]
        local_bases = [bases[i] for i in range(len(prep.blocks))]
        return local_bases, svals, y_dev

    # Checkpoint resume: stage 2 only — project ALL samples through the
    # saved bases, batched by base shape.
    local_bases = saved_bases
    proj_groups: Dict[tuple, List[int]] = {}
    for b_idx, u_b in enumerate(local_bases):
        proj_groups.setdefault((u_b.shape[0], u_b.shape[1]), []).append(b_idx)

    for (bucket, c_b), idxs in sorted(proj_groups.items()):
        b_cap = max(1, budget_elems // (bucket * max(n, 1)))
        chunk_b = _pow2_at_most(min(b_cap, max(len(idxs), 1)))
        for pos in range(0, len(idxs), chunk_b):
            chunk = idxs[pos : pos + chunk_b]
            us = [local_bases[i] for i in chunk]
            while len(us) < chunk_b:
                us.append(np.zeros_like(us[0]))
            out = _project_blocks_batched(
                jnp.asarray(np.stack(us)),
                fetch_batch(chunk, bucket, chunk_b, None),
            )  # (B, c_b, N)
            parts.append((list(chunk), c_b, jnp.asarray(np.stack(us)), None, out))
    _bases, _svals, y = _assemble_condensed(parts, n, len(prep.blocks))
    return local_bases, None, y


def _ckpt_stop(ckpt, name: str, stop_after: Optional[str]) -> bool:
    """True when the run should exit after saving checkpoint `name`."""
    if stop_after != name:
        return False
    log.info(
        "EigenSNP stopping after checkpoint %r (stop_after_checkpoint); "
        "re-run with the same checkpoint dir to resume.", name,
    )
    return True


def compute_eigensnp_pca(
    prep: PreparedData,
    cfg: EigenSnpConfig,
    strip_size: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    mesh=None,
    force_streaming: bool = False,
    compile_only: bool = False,
    stop_after_checkpoint: Optional[str] = None,
) -> Optional[EigenSnpResult]:
    """Run the full two-stage pipeline on prepared data.

    `checkpoint_dir` enables stage checkpoint/resume for preemptible
    runs (utils/checkpoint.py — capability absent in the reference).
    `stop_after_checkpoint` (requires `checkpoint_dir`) exits cleanly —
    returning None — right after the named checkpoint
    (`stage1_bases`, `stage2_basis`, `refine_pass_<p>`) is saved: for
    scheduled preemption, and for bounding a single process's footprint
    on backends whose clients retain a host mirror per device upload
    (a later invocation resumes where this one stopped, and a resume
    that finds `stage2_basis` skips BOTH stage-1/2 matrix passes).
    `mesh` overrides the device mesh the matrix loads onto (default:
    all devices).  `force_streaming` takes the host-streamed container
    regardless of the HBM budget (what load_matrix would do
    automatically past it) — for validation and for pinning memory on
    shared devices.  `compile_only` pre-seeds the persistent
    compilation cache: every device program of this (shape, config)
    AOT-compiles — the background plan runs to completion — and the
    function returns None WITHOUT executing the algorithm; a later run
    at the same shape starts with a fully warm cache.
    """
    from genomic_pca_tpu.utils.checkpoint import StageCheckpointer, fingerprint

    n = prep.n_samples
    d = prep.n_pca_snps
    if d == 0 or not prep.blocks:
        raise ComputeError("No PCA SNPs / LD blocks available for EigenSNP.")
    k = min(cfg.k_global, max(n - 1, 1), d)
    strip_size = strip_size or cfg.snp_strip_size

    ckpt = StageCheckpointer(
        checkpoint_dir,
        fingerprint(cfg, n, d, [b.tag for b in prep.blocks]),
    )
    if stop_after_checkpoint is not None:
        if not ckpt.enabled:
            raise ComputeError(
                "stop_after_checkpoint requires a checkpoint_dir "
                "(--eigensnp-checkpoint-dir)."
            )
        valid = {"stage1_bases", "stage2_basis"} | {
            f"refine_pass_{p}" for p in range(cfg.refine_passes)
        }
        if stop_after_checkpoint not in valid:
            raise ComputeError(
                f"stop_after_checkpoint {stop_after_checkpoint!r} is not "
                f"a checkpoint of this run (have {sorted(valid)})."
            )
        # A retried leg (preempted between ckpt.save and clean exit, or
        # a scheduler re-running it) must NOT fall through and run the
        # remaining pipeline in one process — that defeats the
        # per-process memory bound the split legs exist for.  The leg is
        # complete when its checkpoint exists OR when any LATER stage's
        # checkpoint does (e.g. a retried stage-1 leg whose
        # stage1_bases.npz was lost but whose stage2_basis survived:
        # the pipeline is already past the requested stopping point,
        # and re-running from stage2 would stream the full tail).
        _order = ["stage1_bases", "stage2_basis"] + [
            f"refine_pass_{p}" for p in range(cfg.refine_passes)
        ]
        _at = _order.index(stop_after_checkpoint)
        _done = next(
            (s for s in _order[_at:] if ckpt.has(s)), None
        )
        if _done is not None:
            log.info(
                "EigenSNP checkpoint %r already present in %s (stop "
                "point %r); this stop-after leg is complete — exiting "
                "(the next leg resumes from it).",
                _done, checkpoint_dir, stop_after_checkpoint,
            )
            return None

    # diagnostic_block_tag implies collection (it writes INTO the
    # diagnostics JSON) — the Option<> sub-field relationship of the
    # reference's diagnostic_block_list_id_to_trace (main.rs:326).
    diag: Optional[Dict] = (
        {"blocks": []}
        if (cfg.collect_diagnostics or cfg.diagnostic_block_tag is not None)
        else None
    )
    if cfg.diagnostic_block_tag is not None:
        _tags = [b.tag for b in prep.blocks]
        if cfg.diagnostic_block_tag not in _tags:
            raise ComputeError(
                f"--eigensnp-diagnostic-block-tag {cfg.diagnostic_block_tag!r}"
                f" matches no LD block (have {len(_tags)} blocks, e.g. "
                f"{_tags[:3]})."
            )
    import time as _time

    stage_seconds: Dict[str, float] = {}
    _t_stage = _time.perf_counter()

    # ---- Matrix container (loaded FIRST) ------------------------------
    # When the int8 matrix is device-resident (ShardedMatrix), stages 1-2
    # slice their blocks straight from it: one BED pass + one upload for
    # the whole algorithm, instead of two extra BED passes + standardized
    # f32 uploads through the host accessor.  Streaming containers and
    # non-contiguous block files keep the host accessor path.
    if force_streaming:
        prep.qc_capture = None  # streaming never consumes the capture
        a = prep.load_streaming_matrix(
            strip_size=strip_size,
            # Honor an explicit mesh: stream only over ITS devices
            # (otherwise StreamingMatrix round-robins all local ones).
            devices=(list(mesh.devices.flat) if mesh is not None else None),
        )
    else:
        a = prep.load_matrix(strip_size=strip_size, mesh=mesh)
    runs = _blocks_as_runs(prep.blocks)
    use_device = runs is not None and hasattr(a, "fetch_blocks_device")
    if use_device and getattr(a, "row_segments", None) is not None:
        # Segmented (multi-process fused) layout: device slicing needs
        # every block inside one segment; block-aligned scan ranges
        # guarantee this except for degenerate block files.
        if not a.runs_device_sliceable(runs):
            log.warning(
                "LD blocks cross row segments; using the host accessor "
                "path for stages 1-2."
            )
            use_device = False
    if use_device and prep.config.missing_policy == "error":
        n_miss = a.count_missing()
        if n_miss:
            from genomic_pca_tpu.errors import DataPrepError

            raise DataPrepError(
                f"{n_miss} missing genotypes present post-QC with "
                "missing_policy='error' (reference accessor semantics, "
                "prepare.rs:1906-1911)."
            )
    stage_seconds["matrix_load"] = _time.perf_counter() - _t_stage
    log.info(
        "EigenSNP matrix loaded (%s path) in %.1fs.",
        "device-resident" if use_device else "host-accessor",
        stage_seconds["matrix_load"],
    )
    _t_stage = _time.perf_counter()

    # Refinement subspace width (decided up-front so the pre-warm below
    # can target the exact refinement program): widened to 128 columns
    # for better subspace convergence (models/pca.lane_fill_width);
    # `refine_width` overrides.
    ell_ref = (
        lane_fill_width(k, n, d)
        if cfg.refine_width is None
        else max(k, min(cfg.refine_width, n, d))
    )

    # Cold-start overlap: AOT-compile the LATER programs of the run in
    # the background while stages 1-2 execute.  `.lower().compile()`
    # populates the (persistent + in-process) compilation caches without
    # executing anything, so this is safe at any scale, and the
    # compiles overlap device work and each other.
    use_pca_core = (
        hasattr(a, "pca_core")
        and not ckpt.enabled
        and diag is None
        and cfg.refine_passes >= 1
    )
    import threading

    aot_threads: List[threading.Thread] = []

    def _spawn(name, fn):
        def _run():
            try:
                fn()
            except Exception:  # pragma: no cover - best-effort
                log.debug("%s precompile failed", name, exc_info=True)

        t = threading.Thread(target=_run, daemon=True, name=name)
        t.start()
        aot_threads.append(t)

    # Abstract args must carry the SAME shardings the real calls will
    # see — the lowered module embeds sharding annotations, and a
    # mismatch makes the precompile a cache MISS (verified: replicated
    # NamedSharding on the container mesh reproduces the real modules
    # text-identically).
    rep_sh = (
        NamedSharding(a.mesh, P(None, None))
        if hasattr(a, "mesh") else None
    )

    def rep_sh3(a_):
        return NamedSharding(a_.mesh, P(None, None, None))

    # Spawn order = need order (finish-parts -> global-basis ->
    # pca-core): the program the main thread will block on FIRST starts
    # compiling first.
    if not ckpt.enabled and rep_sh is not None and use_device:
        # The stage-1 fetch-side assembly program (_finish_parts_jit):
        # its whole signature follows from the group plan, and it is one
        # of the two largest compiles of the cold path — compile it
        # concurrently with the fused group programs (whose own
        # first-use compiles already overlap via the group thread pool)
        # instead of serially after them.
        subset_pre = _choose_sample_subset(cfg, n)
        plan = _device_group_plan(a, prep, cfg, subset_pre)
        full_cols_pre = len(subset_pre) >= n
        u_sds, s_sds, o_sds = [], [], []
        perm_len = 0
        for bucket, c_b, n_blocks, chunk_b in plan:
            n_chunks = -(-n_blocks // chunk_b)
            perm_len += n_blocks * c_b
            for _ in range(n_chunks):
                u_sds.append(jax.ShapeDtypeStruct(
                    (chunk_b, bucket, c_b), jnp.float32, sharding=rep_sh3(a)
                ))
                s_sds.append(jax.ShapeDtypeStruct(
                    (chunk_b, c_b), jnp.float32,
                    sharding=NamedSharding(a.mesh, P(None, None)),
                ))
                o_sds.append(jax.ShapeDtypeStruct(
                    (chunk_b, c_b, a.n_pad), jnp.float32, sharding=rep_sh3(a)
                ))
        _spawn(
            "precompile-finish-parts",
            lambda: _finish_parts_jit(n).lower(
                u_sds, s_sds, o_sds,
                np.zeros(perm_len, np.int32),
            ).compile(),
        )
    if not ckpt.enabled and rep_sh is not None:
        # Stage-2 global program: its condensed input shape (C, N) is
        # known before stage 1 runs (sum of per-block component counts).
        subset_n = len(_choose_sample_subset(cfg, n))
        c_total_pre = sum(
            min(cfg.components_per_block, len(b.pca_snp_ids), subset_n)
            for b in prep.blocks
        )
        k_pre = min(k, c_total_pre)
        _spawn(
            "precompile-global-basis",
            lambda: _global_basis_prog.lower(
                jax.ShapeDtypeStruct(
                    (c_total_pre, n), jnp.float32, sharding=rep_sh
                ),
                seed_words(cfg.seed),
                k=k_pre, n_os=cfg.global_oversampling,
                n_pi=cfg.global_power_iter, ell_ref=ell_ref,
            ).compile(),
        )
    if use_pca_core and rep_sh is not None:
        _spawn(
            "precompile-pca-core",
            lambda: a._pca_core_k.lower(
                a.geno, a.mean, a.inv_std,
                jax.ShapeDtypeStruct(
                    (n, ell_ref), jnp.float32, sharding=rep_sh
                ),
                cfg.refine_passes, k, None,
            ).compile(),
        )
    if (
        compile_only
        and not ckpt.enabled and rep_sh is not None and use_device
    ):
        # The fused stage-1+2 group programs: ONLY for compile_only cache
        # seeding.  In a normal run the main thread reaches the first
        # group well inside these programs' compile time, so a racing
        # background compile of the same program is pure duplicate load
        # on the (mostly serialized) compile service — it makes cold
        # starts slower, not faster.
        subset_pre_dev = jax.device_put(
            np.asarray(subset_pre, dtype=np.int32)
        )
        for bucket, c_b, _n_blocks, chunk_b in plan:
            runp = _fused_stage12_device_prog(
                a.packed, bucket, c_b, cfg.local_oversampling,
                cfg.local_power_iter, full_cols_pre,
            )
            _spawn(
                f"precompile-stage12-{bucket}-{c_b}",
                lambda runp=runp, chunk_b=chunk_b: runp.lower(
                    a.geno, a.mean, a.inv_std,
                    np.zeros(chunk_b, np.int32),
                    np.zeros(chunk_b, np.int32),
                    subset_pre_dev,
                    seed_words(cfg.seed),
                    _stage_units([], chunk_b),
                ).compile(),
            )

    if compile_only:
        # First-run cache seeding: wait for the full AOT plan (every
        # program lands in the persistent cache) and return without
        # executing.  The matrix load + QC programs compiled above as a
        # side effect of preparing the container.
        t0c = _time.perf_counter()
        for t in aot_threads:
            t.join()
        log.info(
            "Compile-only: %d AOT program(s) compiled in %.1fs; "
            "persistent cache seeded for shape (%d x %d, k=%d).",
            len(aot_threads), _time.perf_counter() - t0c, d, n, k,
        )
        return None

    # ---- Stages 1+2: local bases -> condensed projection --------------
    # Blocks are grouped by (padded-bucket, c_b) and each group runs
    # through a vmapped randomized SVD + batched projection — one device
    # dispatch per batch instead of one per block (genome-wide runs have
    # ~1,400 blocks; per-block dispatch latency would dominate).  Padded
    # rows are exactly zero, so U keeps exact zero rows there; batch
    # padding uses zero blocks whose outputs are discarded.
    subset = _choose_sample_subset(cfg, n)
    if ckpt.load("stage2_basis") is not None and diag is None:
        # Resume past stage 2: the only stage-1/2 products consumed
        # downstream are the condensed matrix (feeds the global PCA,
        # already checkpointed) and diagnostics detail — so skip BOTH
        # full-matrix passes of stages 1+2 entirely.  On streamed
        # bigger-than-memory runs this makes each resume leg a
        # single-pass process (matters on preemptible capacity).
        local_bases, svals = None, None
        saved_bases = None
        y = None
        c_total_skip = sum(
            min(cfg.components_per_block, len(b.pca_snp_ids), len(subset))
            for b in prep.blocks
        )
        log.info(
            "EigenSNP stages 1+2 skipped (stage2_basis checkpoint "
            "present; condensed rank %d).", c_total_skip,
        )
    else:
        c_total_skip = None
        saved = ckpt.load("stage1_bases")
        saved_bases: Optional[List[np.ndarray]] = None
        if saved is not None and len(saved) == len(prep.blocks):
            saved_bases = [
                saved[f"block_{i}"] for i in range(len(prep.blocks))
            ]
        else:
            log.info(
                "EigenSNP stage 1: %d blocks, sample subset %d / %d.",
                len(prep.blocks),
                len(subset),
                n,
            )

        if use_device:
            local_bases, svals, y = _stages12_device(
                a, prep, cfg, subset, runs, saved_bases
            )
        else:
            local_bases, svals, y = _stages12_host(
                prep, cfg, subset, saved_bases
            )

    if y is not None and saved_bases is None:
        if diag is not None and svals is not None:
            for b_idx, block in enumerate(prep.blocks):
                d_b = len(block.pca_snp_ids)
                ids = block.pca_snp_ids
                diag["blocks"].append(
                    {
                        "tag": block.tag,
                        "num_snps": int(d_b),
                        "num_local_components": int(
                            min(cfg.components_per_block, d_b, len(subset))
                        ),
                        "pca_snp_id_start": int(ids[0]) if d_b else -1,
                        "pca_snp_id_end": int(ids[-1]) if d_b else -1,
                        "local_singular_values": svals[b_idx].tolist(),
                    }
                )
        ckpt.save(
            "stage1_bases",
            {f"block_{i}": u for i, u in enumerate(local_bases)},
        )
        if _ckpt_stop(ckpt, "stage1_bases", stop_after_checkpoint):
            return None
    if diag is not None and cfg.diagnostic_block_tag is not None:
        # Deep trace of ONE selected block's full stage-1 intermediates
        # (diagnostic_block_list_id_to_trace analog, main.rs:326):
        # subset indices, SNP ids, local basis, singular values, and the
        # block's rows of the condensed projection (y is assembled in
        # block order with c_b rows per block).
        b_idx = [b.tag for b in prep.blocks].index(cfg.diagnostic_block_tag)
        block = prep.blocks[b_idx]

        def _c_of(b):
            return min(cfg.components_per_block, len(b.pca_snp_ids),
                       len(subset))

        off = sum(_c_of(prep.blocks[i]) for i in range(b_idx))
        c_b = _c_of(block)
        diag["block_trace"] = {
            "tag": block.tag,
            "block_index": int(b_idx),
            "num_snps": int(len(block.pca_snp_ids)),
            "num_local_components": int(c_b),
            "subset_sample_indices": [int(x) for x in subset],
            "pca_snp_ids": [int(x) for x in block.pca_snp_ids],
            # Bases come back bucket-padded (exact zero rows past d_b);
            # the trace records the real (d_b, c_b) basis.
            "local_basis": np.asarray(local_bases[b_idx])[
                : len(block.pca_snp_ids)
            ].tolist(),
            "local_singular_values": (
                np.asarray(svals[b_idx]).tolist()
                if svals is not None else None
            ),
            "condensed_projection": np.asarray(
                y[off : off + c_b]
            ).tolist(),
        }
    stage_seconds["stages_1_2"] = _time.perf_counter() - _t_stage
    if y is not None:
        log.info(
            "EigenSNP stages 1+2: condensed matrix %s in %.1fs.",
            tuple(y.shape),
            stage_seconds["stages_1_2"],
        )
    _t_stage = _time.perf_counter()

    condensed_spectrum: Optional[np.ndarray] = None
    if diag is not None:
        # Full singular spectrum of the condensed (C, N) matrix via an
        # eigensolve over its smaller Gram (diagnostics-gated; the
        # production path never materializes this).
        c_rows = int(y.shape[0])
        gram_small = (
            _dot_hi(y, y.T) if c_rows <= n else _dot_hi(y.T, y)
        )
        sp = jnp.sqrt(jnp.maximum(jnp.linalg.eigvalsh(gram_small), 0.0))
        condensed_spectrum = np.asarray(sp)[::-1].copy()

    c_total = int(y.shape[0]) if y is not None else int(c_total_skip)
    if c_total < k:
        log.warning(
            "Condensed feature rank %d < requested k_global %d; "
            "returning %d components (raise components_per_block or add "
            "LD blocks for more).",
            c_total,
            k,
            c_total,
        )
        k = c_total

    saved = ckpt.load("stage2_basis")
    if saved is None and not ckpt.enabled:
        # Global rSVD + lane-fill widening as ONE compiled program (the
        # sketch/fill keys derive in-program from the raw seed words).
        s_basis = _global_basis_prog(
            y, seed_words(cfg.seed), k=k,
            n_os=cfg.global_oversampling, n_pi=cfg.global_power_iter,
            ell_ref=ell_ref,
        )
    else:
        gkey = key_for_stage(cfg.seed, "eigensnp_global_sketch")
        fkey = key_for_stage(cfg.seed, "eigensnp_refine_fill")
        # Checkpoint runs keep the decomposed path so the k-wide stage-2
        # basis is a saveable/resumable artifact.
        if saved is not None:
            s_basis = jnp.asarray(saved["s_basis"])
        else:
            _, _, vt_g = rsvd(
                y,
                gkey,
                k=k,
                n_oversamples=cfg.global_oversampling,
                n_power_iter=cfg.global_power_iter,
            )
            s_basis, _ = jnp.linalg.qr(vt_g.T)  # (N, k) score basis
            ckpt.save("stage2_basis", {"s_basis": np.asarray(s_basis)})
            if _ckpt_stop(ckpt, "stage2_basis", stop_after_checkpoint):
                return None
        if ell_ref > int(s_basis.shape[1]):
            extra = jax.random.normal(
                fkey, (n, ell_ref - int(s_basis.shape[1])), dtype=jnp.float32
            )
            s_basis, _ = jnp.linalg.qr(
                jnp.concatenate([s_basis, extra], axis=1)
            )

    stage_seconds["global_pca"] = _time.perf_counter() - _t_stage
    log.info(
        "EigenSNP global PCA done in %.1fs.", stage_seconds["global_pca"]
    )
    _t_stage = _time.perf_counter()

    # ---- Refinement + final eigensolve + loadings --------------------
    # The refinement is subspace iteration seeded with the stage-2 basis —
    # exactly the fused single-program PCA core (power loop -> condensed
    # eigensolve -> loadings in ONE compile/dispatch) on the matrix
    # container loaded above.  Streamed/striped containers without
    # pca_core fall back to per-pass dispatches with per-pass
    # checkpointing; diagnostics runs also take the per-pass path so
    # refinement convergence (subspace residual per pass) is observable.
    refine_residuals: List[float] = []
    if use_pca_core:
        v_k, sigma_k, evals_k, loadings = a.pca_core(
            s_basis, cfg.refine_passes, k
        )
        # Finalization math on HOST (the arrays download anyway): eager
        # device multiply/convert here each cost a cold remote compile.
        sigma_np = np.asarray(sigma_k)
        scores = (
            np.asarray(v_k) * sigma_np[None, :]
        ).astype(np.float32)
        loadings = np.asarray(loadings).astype(np.float32)
        eigenvalues = np.asarray(evals_k, dtype=np.float64) / max(n - 1, 1)
        sigma = sigma_np
    else:
        start_pass = 0
        for p in reversed(range(cfg.refine_passes)):
            saved = ckpt.load(f"refine_pass_{p}")
            if saved is not None:
                s_basis = jnp.asarray(saved["s_basis"])
                start_pass = p + 1
                break
        for p in range(start_pass, cfg.refine_passes):
            t = a.gram_apply(s_basis)  # A^T A S, one streamed pass
            s_new, _ = jnp.linalg.qr(t)
            if diag is not None:
                # Subspace residual: sin of the largest principal angle
                # between consecutive bases — the convergence series of
                # the refinement (FullPcaRunDetailedDiagnostics analog,
                # /root/reference/src/main.rs:410-432).
                cosines = jnp.linalg.svd(
                    _dot_hi(s_new.T, s_basis), compute_uv=False
                )
                smin = float(jnp.clip(jnp.min(cosines), 0.0, 1.0))
                refine_residuals.append(float(np.sqrt(max(0.0, 1.0 - smin**2))))
            s_basis = s_new
            ckpt.save(f"refine_pass_{p}", {"s_basis": np.asarray(s_basis)})
            log.info(
                "EigenSNP refinement pass %d/%d done.", p + 1, cfg.refine_passes
            )
            if _ckpt_stop(ckpt, f"refine_pass_{p}", stop_after_checkpoint):
                return None

        # Streaming containers fuse the condensed Gram with an A B
        # capture: loadings are (A B) W / sigma, so the separate
        # right_apply pass (a full re-read + re-upload of the matrix) is
        # unnecessary.  Preferred variant: the capture stays ON DEVICE
        # and projects to (D, k) there before download — 3.2x fewer D2H
        # bytes at the default widths (falls back to the host capture
        # past the HBM budget).
        project = None
        ab = None
        fused = hasattr(a, "tsq_and_capture")
        if hasattr(a, "tsq_and_project"):
            got = a.tsq_and_project(s_basis)
            if got is not None:
                g, project = got  # (l, l), closure -> (D, k) host
        if project is None and fused:
            g, ab = a.tsq_and_capture(s_basis)  # (l, l), (D, l) host
        elif project is None:
            g = a.tsq_accumulate(s_basis)  # (l, l)
        evals, w = jnp.linalg.eigh(g)
        order = jnp.argsort(-evals)
        # Top-k of the (possibly lane-filled) refinement subspace.
        evals = jnp.maximum(evals[order][:k], 0.0)
        w = w[:, order][:, :k]
        sigma = jnp.sqrt(evals)
        v = _dot_hi(s_basis, w)  # (N, k) right singular vectors of A

        scores = np.asarray(v * sigma[None, :], dtype=np.float32)
        inv_sigma = np.asarray(
            jnp.where(sigma > 0, 1.0 / jnp.where(sigma > 0, sigma, 1.0), 0.0)
        )
        if project is not None:
            loadings = (
                project(np.asarray(w)) * inv_sigma[None, :]
            ).astype(np.float32)
        elif fused:
            loadings = (
                (ab @ np.asarray(w)) * inv_sigma[None, :]
            ).astype(np.float32)
        else:
            loadings = (a.right_apply(v) * inv_sigma[None, :]).astype(
                np.float32
            )
        eigenvalues = np.asarray(evals, dtype=np.float64) / max(n - 1, 1)

    stage_seconds["refinement_finalize"] = _time.perf_counter() - _t_stage
    log.info(
        "EigenSNP refinement + finalization done in %.1fs.",
        stage_seconds["refinement_finalize"],
    )

    if diag is not None:
        # Faithful analog of the reference's FullPcaRunDetailedDiagnostics
        # dump (/root/reference/src/main.rs:410-432): per-block stage-1
        # detail, condensed spectrum, refinement convergence, stage
        # wall-times, and the final spectrum.
        diag["global"] = {
            "condensed_features": int(y.shape[0]),
            "k_global": int(k),
            "refine_passes": int(cfg.refine_passes),
            "refine_width": int(ell_ref),
            "sample_subset_size": int(len(subset)),
            "singular_values": np.asarray(sigma).tolist(),
            "final_eigenvalues": np.asarray(eigenvalues).tolist(),
            "condensed_spectrum": (
                condensed_spectrum.tolist()
                if condensed_spectrum is not None
                else []
            ),
        }
        diag["refinement"] = {
            "passes_run": int(cfg.refine_passes),
            "subspace_residual_per_pass": refine_residuals,
        }
        diag["stage_seconds"] = {
            s: round(t, 3) for s, t in stage_seconds.items()
        }
        diag["num_pca_snps"] = int(d)
        diag["num_qc_samples"] = int(n)
        diag["num_ld_blocks"] = int(len(prep.blocks))
        diag["matrix_path"] = (
            "device-resident" if use_device else "host-accessor"
        )

    return EigenSnpResult(
        scores=scores,
        eigenvalues=eigenvalues,
        loadings=loadings,
        diagnostics=diag,
        stage_seconds={s: round(t, 3) for s, t in stage_seconds.items()},
    )
