"""Deterministic PRNG derivation.

The reference threads explicit u64 seeds (`--rfit-seed`, `--eigensnp-seed`,
/root/reference/src/main.rs:528-529, 581-582) into ChaCha-based RNGs.  Here
every random draw derives from `jax.random.key(seed)` through a documented
fold-in order so the same seed reproduces identical PCs at any mesh size:

    root = key(seed)
    stage key   = fold_in(root, STAGE_ID[stage])
    per-unit    = fold_in(stage_key, unit_index)   # e.g. LD-block index

Reduction orders in the algorithms are fixed (shard index order), which
together with this scheme gives run-to-run determinism.
"""

from __future__ import annotations

import jax

# Stable stage identifiers — appending is fine, re-ordering is a breaking
# change to reproducibility.
STAGE_IDS = {
    "rfit_sketch": 0,
    "eigensnp_sample_subset": 1,
    "eigensnp_local_sketch": 2,
    "eigensnp_global_sketch": 3,
    "synthetic_data": 4,
    "bench": 5,
    "eigensnp_refine_fill": 6,
}


def key_for_stage(seed: int, stage: str, unit: int = 0) -> jax.Array:
    root = jax.random.key(seed)
    k = jax.random.fold_in(root, STAGE_IDS[stage])
    if unit:
        k = jax.random.fold_in(k, unit)
    return k


def seed_words(seed: int):
    """Raw threefry key-data words of `jax.random.key(seed)` — computed
    HOST-side with no device ops.

    `jax.random.key` / `fold_in` called eagerly each cost a compile on
    a cold persistent cache, so cold-start-critical paths pass these words
    into their jitted programs and derive keys there via
    `key_from_words` instead.  Bit-identical to `threefry_seed`:
    with x64 disabled JAX truncates the seed to its low 32 bits
    (verified across 0, 2**31, 2**40+123, negative seeds)."""
    import numpy as np

    if jax.config.jax_enable_x64:
        return np.array(
            [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32
        )
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def key_from_words(words, stage: str) -> jax.Array:
    """In-program stage key from `seed_words` output (trace-safe): wrap
    the raw words and fold in the stage id.  Same values as
    `key_for_stage(seed, stage)`."""
    root = jax.random.wrap_key_data(words)
    return jax.random.fold_in(root, STAGE_IDS[stage])
