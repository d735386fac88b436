"""Randomized SVD.

Re-creation of the compute contract of the external `efficient_pca` crate's
`rfit` (API characterized at /root/reference/src/main.rs:648-660 and SURVEY
§2.4): sketch -> power iterations with QR re-orthonormalization -> small
exact SVD.  Shapes are static, and the PRNG is an explicit key so
results are bitwise-reproducible for a fixed seed at any device count.

Convention: `rsvd(X)` treats X as (rows x cols) and returns (U, s, Vt) with
U: rows x k, s: k, Vt: k x cols — the rank-k truncated SVD approximation.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


def _qr_q(a: jax.Array) -> jax.Array:
    """Thin-QR orthonormal factor (reduced mode)."""
    q, _ = jnp.linalg.qr(a)
    return q


def cholqr2_q(t: jax.Array) -> jax.Array:
    """Two-pass Cholesky-QR orthonormal factor.

    Householder QR of a tall-skinny block is latency-bound and compiles
    to a large batched loop under vmap (seconds of XLA compile per fused
    stage-1 program); CholQR2 is two small HIGHEST-precision matmuls +
    an (l, l) Cholesky per pass — compile-light, matmul-dense, and
    stable to cond(T) ~ 1e4 with the column pre-normalization +
    second pass (same discipline as the sharded power loop,
    parallel/sharded.py cholqr2)."""
    eps = jnp.asarray(1e-12, t.dtype)
    for _ in range(2):
        t = t / (jnp.linalg.norm(t, axis=0, keepdims=True) + eps)
        gram = jnp.dot(
            t.T, t, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        ell = gram.shape[0]
        r = jnp.linalg.cholesky(gram + 1e-6 * jnp.eye(ell, dtype=t.dtype))
        t = jax.lax.linalg.triangular_solve(
            r, t, left_side=False, lower=True, transpose_a=True
        )
    return t


@partial(
    jax.jit, static_argnames=("k", "n_oversamples", "n_power_iter", "orth")
)
def rsvd(
    x: jax.Array,
    key: jax.Array,
    k: int,
    n_oversamples: int = 10,
    n_power_iter: int = 2,
    orth: str = "qr",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Randomized truncated SVD of a dense device matrix.

    Halko-Martinsson-Tropp with per-iteration re-orthonormalization; the
    sketch width is k + n_oversamples (reference uses n_oversamples=10,
    main.rs:651).  `orth` picks the stabilizer: "qr" (Householder,
    exact) or "cholqr2" (matmul-only, compile-light — what the vmapped
    fused stage-1 programs use; see `cholqr2_q`).  The small exact SVD
    of the projected matrix is unchanged either way.
    """
    m, n = x.shape
    ell = min(k + n_oversamples, min(m, n))
    orth_q = _qr_q if orth == "qr" else cholqr2_q
    # Every product at HIGHEST: the blocks are small (bucket x subset),
    # so full f32 costs little, and without it a GPU runs them in TF32
    # (~3 decimal digits) that the local bases would carry into the
    # condensed stage-2 matrix.
    dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    omega = jax.random.normal(key, (n, ell), dtype=x.dtype)
    y = dot(x, omega)  # (m, ell)
    q = orth_q(y)
    for _ in range(n_power_iter):
        z = dot(x.T, q)  # (n, ell)
        z = orth_q(z)
        y = dot(x, z)
        q = orth_q(y)
    b = dot(q.T, x)  # (ell, n)
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = dot(q, ub)
    return u[:, :k], s[:k], vt[:k, :]


@partial(jax.jit, static_argnames=("k",))
def exact_svd(x: jax.Array, k: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Exact truncated SVD (for small matrices / tests)."""
    u, s, vt = jnp.linalg.svd(x, full_matrices=False)
    return u[:, :k], s[:k], vt[:k, :]


@jax.jit
def quantize_basis(bp: jax.Array):
    """Padded f32 basis -> (int8 basis, (1,1) scale, (1,L) scaled column
    sums) with ONE global scale (orthonormal columns share magnitude).
    THE canonical basis quantization of the q8 power path — every
    container's steering pass must use it so the quantization model
    stays identical across resident/streaming/2-D regimes."""
    sb = jnp.maximum(jnp.max(jnp.abs(bp)), 1e-30) / 127.0
    bq = jnp.clip(jnp.round(bp / sb), -127.0, 127.0).astype(jnp.int8)
    csum = (jnp.sum(bq, axis=0, dtype=jnp.float32) * sb)[None, :]
    return bq, sb.reshape(1, 1), csum


def subspace_residual(b: jax.Array, t: jax.Array) -> jax.Array:
    """||T - B(B^T T)||_F / ||T||_F — the rfit tolerance metric
    (DEVIATIONS.md §10).  `b` is the pre-update (orthonormal after the
    first pass) basis, `t` the new power-pass output; ONE definition
    shared by every container's early-exit check."""
    proj = jnp.dot(
        b.T, t, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    fit = jnp.dot(b, proj, precision=jax.lax.Precision.HIGHEST)
    return jnp.linalg.norm(t - fit) / (jnp.linalg.norm(t) + 1e-30)


def sign_canonicalize(u: jax.Array, vt: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Fix the sign ambiguity of singular pairs for comparisons.

    Convention: for each component, the entry of largest |value| in the
    column of U is made positive (applied consistently to Vt).
    """
    idx = jnp.argmax(jnp.abs(u), axis=0)
    signs = jnp.sign(u[idx, jnp.arange(u.shape[1])])
    signs = jnp.where(signs == 0, 1.0, signs)
    return u * signs[None, :], vt * signs[:, None]
