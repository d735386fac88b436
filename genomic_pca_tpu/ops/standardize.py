"""Standardization of int8 dosage strips on device.

Equivalent of the reference's fused SIMD standardize kernel
(/root/reference/src/prepare.rs:1899-2013): x -> (x - mu) * (1/sigma) with
zero-sigma rows forced to 0.  Differences by design:

* Missing genotypes (-127) surviving QC are imputed to the mean (i.e. 0
  after standardization) by default — the reference accessor hard-errors
  (prepare.rs:1906-1911) while its own Python oracle imputes
  (tests/pca.py:110); we follow the oracle.  `DataPrepConfig.missing_policy
  = "error"` restores strict parity (checked host-side at load).

* The multiply-add uses the same factorization as the reference:
  g * inv_sigma + (-mu * inv_sigma), fused by XLA into the consuming
  products (the hot-path form, with the 2-bit unpack, is
  ops/products.standardize).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MISSING = -127


@jax.jit
def standardize_strip(
    strip_i8: jax.Array, mean: jax.Array, inv_std: jax.Array
) -> jax.Array:
    """(snps, samples) int8 -> float32 standardized, missing imputed to 0.

    `mean`/`inv_std` are float32 (snps,) vectors; rows dropped by QC carry
    inv_std == 0 and standardize to all-zeros (matching the zero-sigma
    semantics of prepare.rs:1946-1955).
    """
    g = strip_i8.astype(jnp.float32)
    valid = strip_i8 != MISSING
    scale = inv_std[:, None]
    shift = (-mean * inv_std)[:, None]
    x = g * scale + shift
    return jnp.where(valid, x, 0.0)


def standardize_rows(
    g_i8: jax.Array, mean: jax.Array, inv_std: jax.Array
) -> jax.Array:
    """Row-vector form used by the streamed engines (not jitted on its
    own — callers fuse it into their compiled programs)."""
    g = g_i8.astype(jnp.float32)
    x = g * inv_std[:, None] + (-mean * inv_std)[:, None]
    return jnp.where(g_i8 != MISSING, x, 0.0)


def inv_std_from_std(std) -> jax.Array:
    std = jnp.asarray(std, dtype=jnp.float32)
    return jnp.where(std > 0, 1.0 / jnp.where(std > 0, std, 1.0), 0.0)
