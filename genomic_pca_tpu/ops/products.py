"""Products of the standardized genotype operator, in plain XLA.

The implicit operator is A = diag(s) (G - mu 1^T), D x N (variants x
samples), with s = 1/std (0 for inert rows) and missing genotypes
standardizing to 0.  G is stored either as int8 dosages (missing =
-127) or as PLINK 2-bit packed bytes (uint8, 4 samples per byte, low
bits first; count_A1 codes 00 -> 2, 01 -> missing, 10 -> 1, 11 -> 0).
Every workflow runs on five products, each with ONE implementation here
shared by the resident (parallel/sharded.py) and host-streamed
(ops/streaming.py) containers:

  gram(B)    = A^T (A B)        (N, L)  one power-iteration pass
  tsq(B)     = (A B)^T (A B)    (L, L)  condensed Gram
  right(B)   = A B              (D, L)  loadings
  left(W)    = A^T W            (N, K)  projection of new samples
  gram_q8(B) ~ A^T (A B)        (N, L)  quantized steering pass

Each is a `lax.scan` over row strips of `step` rows: a strip is
unpacked and standardized, then multiplied.  `strip_rows` bounds the
step so one f32 standardized strip stays within STRIP_BYTES at any
sample count.

Precision (the containers' `kernel_precision`):
  "f32"  - f32 operands, every matmul at Precision.HIGHEST (no TF32).
  "bf16" - the standardized strip and B cast to bf16, f32 accumulation
           (`preferred_element_type`).  Dosages 0/1/2 are exact in
           bf16; the per-SNP scale and shift round to ~0.4%, which the
           D-long contraction averages out (|r| >= 0.999 vs float64).
  "q8"   - bf16 for every product above, plus `gram_q8` for the
           steering passes of the power loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MISSING = -127

# Byte budget of one f32 standardized strip (see `strip_rows`).
STRIP_BYTES = 256 << 20

PRECISIONS = ("f32", "bf16", "q8")


def strip_rows(n_cols: int, cap: int) -> int:
    """Rows per scan step: `cap`, halved while one f32 standardized
    strip of `n_cols` columns exceeds STRIP_BYTES and the half is still
    a whole number of rows.  The result divides `cap`."""
    step = cap
    while step % 2 == 0 and step * n_cols * 4 > STRIP_BYTES:
        step //= 2
    return step


def exact_precision(kernel_precision: str) -> str:
    """Precision of the exact products: "q8" steers only the power
    loop; every other product runs bf16."""
    if kernel_precision not in PRECISIONS:
        raise ValueError(
            f"kernel_precision must be one of {PRECISIONS}, "
            f"got {kernel_precision!r}"
        )
    return "f32" if kernel_precision == "f32" else "bf16"


def unpack_codes(packed: jax.Array) -> jax.Array:
    """(S, n4) uint8 PLINK bytes -> (S, 4*n4) uint8 2-bit codes in
    ORIGINAL sample order (sample 4j + p is field p of byte j)."""
    s, n4 = packed.shape
    return jnp.stack(
        [(packed >> (2 * p)) & 3 for p in range(4)], axis=-1
    ).reshape(s, 4 * n4)


def dosages(g: jax.Array):
    """Genotype strip -> (int8 dosages with missing as 0, valid mask).
    Accepts int8 dosages or uint8 packed bytes."""
    if g.dtype == jnp.uint8:
        c = unpack_codes(g)
        valid = c != 1
        return jnp.where(valid, (4 - c) >> 1, 0).astype(jnp.int8), valid
    return jnp.maximum(g, jnp.int8(0)), g != MISSING


def standardize(g: jax.Array, m: jax.Array, iv: jax.Array) -> jax.Array:
    """(S, cols) genotypes + (S, 1) mean / inv_std -> f32 standardized
    strip; missing entries and inert rows (inv_std = 0) are 0."""
    d, valid = dosages(g)
    x = d.astype(jnp.float32) * iv + (-m * iv)
    return jnp.where(valid, x, 0.0)


def _compute_dtype(precision: str):
    return jnp.float32 if precision == "f32" else jnp.bfloat16


def _dot(a, b, precision: str):
    return jnp.dot(
        a, b, preferred_element_type=jnp.float32,
        precision=(
            jax.lax.Precision.HIGHEST if precision == "f32"
            else jax.lax.Precision.DEFAULT
        ),
    )


def _strips(step: int, *arrays):
    """Split the row axis of each array into (rows / step, step, ...)."""
    rows = arrays[0].shape[0]
    assert rows % step == 0, (rows, step)
    return tuple(a.reshape((rows // step, step) + a.shape[1:]) for a in arrays)


def _accumulate(body, init, xs):
    acc, _ = jax.lax.scan(lambda acc, x: (acc + body(*x), None), init, xs)
    return acc


def _right_strip(g, m, iv, b, precision):
    dt = _compute_dtype(precision)
    return _dot(standardize(g, m, iv).astype(dt), b.astype(dt), precision)


def tsq_of(w: jax.Array, precision: str) -> jax.Array:
    """(A B)^T (A B) from A B, in the product precision."""
    wc = w.astype(_compute_dtype(precision))
    return _dot(wc.T, wc, precision)


@functools.partial(jax.jit, static_argnames=("precision", "step"))
def gram(g, m, iv, b, *, precision: str, step: int) -> jax.Array:
    """A^T (A B): (cols, L) f32."""
    dt = _compute_dtype(precision)
    bc = b.astype(dt)

    def body(gg, mm, ii):
        x = standardize(gg, mm, ii).astype(dt)
        w = _dot(x, bc, precision)
        return _dot(x.T, w.astype(dt), precision)

    init = jnp.zeros((b.shape[0], b.shape[1]), jnp.float32)
    return _accumulate(body, init, _strips(step, g, m, iv))


@functools.partial(jax.jit, static_argnames=("precision", "step"))
def tsq(g, m, iv, b, *, precision: str, step: int) -> jax.Array:
    """(A B)^T (A B): (L, L) f32."""
    def body(gg, mm, ii):
        return tsq_of(_right_strip(gg, mm, ii, b, precision), precision)

    init = jnp.zeros((b.shape[1], b.shape[1]), jnp.float32)
    return _accumulate(body, init, _strips(step, g, m, iv))


@functools.partial(jax.jit, static_argnames=("precision", "step"))
def right(g, m, iv, b, *, precision: str, step: int) -> jax.Array:
    """A B: (rows, L) f32."""
    def body(_, xs):
        return None, _right_strip(*xs, b, precision)

    _, out = jax.lax.scan(body, None, _strips(step, g, m, iv))
    return out.reshape(g.shape[0], b.shape[1])


@functools.partial(jax.jit, static_argnames=("step",))
def left(g, m, iv, w, *, step: int) -> jax.Array:
    """A^T W for a row-space W (rows, K): (cols, K) f32 at HIGHEST
    (a projection lands in user-visible scores)."""
    def body(gg, mm, ii, ww):
        return _dot(standardize(gg, mm, ii).T, ww, "f32")

    cols = 4 * g.shape[1] if g.dtype == jnp.uint8 else g.shape[1]
    init = jnp.zeros((cols, w.shape[1]), jnp.float32)
    return _accumulate(body, init, _strips(step, g, m, iv, w))


# ---------------------------------------------------------------------------
# Quantized steering pass.
#
# The genotype matrix is already small integers; standardization is
# hoisted out of the matmuls as exact rank-1 / diagonal corrections on
# the small (S, L) intermediate:
#
#     A = diag(s) G0 - u 1^T            (s = 1/std, u = mean/std)
#     A b       = s . (G0 b)  - u (1^T b)
#     A^T y     = G0^T (s . y) - 1 (u^T y)
#
# so one pass T = A^T (A b) is two s8 x s8 -> s32 matmuls on the raw
# genotype strip G0 (missing -> 0) plus O(S x L) elementwise work.
#
# Quantization: b quantizes to int8 with one global scale
# (ops/rsvd.quantize_basis: orthonormal columns share magnitude); the
# intermediate z = s . y re-quantizes PER STRIP.  The int32 accumulators
# are exact for the quantized operands, so the only error is the two
# 8-bit roundings, ~0.4% relative per pass, which subspace iteration
# absorbs: the power loop runs its last pass(es) and the Rayleigh-Ritz
# eigensolve through the exact products (`resolve_q8_polish`).
#
# Missing genotypes contribute -u_i instead of 0 during the quantized
# passes (raw 0 after the rank-1 correction): a small operator
# perturbation (<= 2% of entries at the default call-rate gate) that the
# exact polish passes remove.  No quantized product reaches a
# user-visible output.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("step",))
def gram_q8(g, iv, u, bq, sb, csum, *, step: int) -> jax.Array:
    """Quantized A^T (A b): (cols, L) f32.

    `iv`, `u` are (rows, 1) inv_std and mean * inv_std; `bq`, `sb`,
    `csum` come from `ops.rsvd.quantize_basis` (int8 basis, (1, 1)
    scale, (1, L) scaled column sums)."""
    def body(gg, ii, uu):
        g0, _ = dosages(gg)
        w = jax.lax.dot_general(
            g0, bq, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        y = ii * (w.astype(jnp.float32) * sb[0, 0]) - uu * csum
        z = ii * y
        sz = jnp.max(jnp.abs(z)) * (1.0 / 127.0) + 1e-30
        z8 = jnp.clip(jnp.round(z * (1.0 / sz)), -127.0, 127.0).astype(jnp.int8)
        t = jax.lax.dot_general(
            g0, z8, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        # The rank-1 term 1 (u^T y) broadcasts over every sample row.
        return t.astype(jnp.float32) * sz - jnp.sum(uu * y, axis=0, keepdims=True)

    cols = 4 * g.shape[1] if g.dtype == jnp.uint8 else g.shape[1]
    init = jnp.zeros((cols, bq.shape[1]), jnp.float32)
    return _accumulate(body, init, _strips(step, g, iv, u))


def gram_q8_reference(g, iv, u, bq, sb, step: int) -> np.ndarray:
    """numpy float64 replay of `gram_q8`'s exact quantization model.

    `g` is (rows, cols) int8 dosages (missing = -127, or already 0),
    `iv`, `u` (rows, 1); `bq` (cols, L) int8 with scale `sb`.  Works
    strip by strip, so host memory stays O(step x cols)."""
    bqf = np.asarray(bq, np.float64) * float(sb)
    t = np.zeros((g.shape[1], bq.shape[1]))
    ru = np.zeros((1, bq.shape[1]))
    for lo in range(0, g.shape[0], step):
        g0 = np.maximum(g[lo: lo + step], 0).astype(np.float64)
        ivs = np.asarray(iv[lo: lo + step], np.float64)
        us = np.asarray(u[lo: lo + step], np.float64)
        y = ivs * (g0 @ bqf) - us * bqf.sum(axis=0)[None, :]
        z = ivs * y
        sz = np.abs(z).max() / 127.0 + 1e-30
        t += g0.T @ (np.clip(np.round(z / sz), -127, 127) * sz)
        ru += (us * y).sum(axis=0)[None, :]
    return t - ru
