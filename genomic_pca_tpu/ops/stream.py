"""Strip kernels + the reference (test-oracle) operator container.

Two things live here:

1. The jitted per-strip f32 primitives `_strip_gram_apply` /
   `_strip_right_apply` — the reference form of the standardize-and-
   multiply pass, used by `StripedMatrix` and the compile-check entry
   (`__graft_entry__.entry`).
2. `StripedMatrix` — the SIMPLEST implementation of the
   `ops.operator.StandardizedOperator` contract (a Python list of
   device strips, f32 at HIGHEST, no mesh, no prefetch).  It exists as the
   independent, obviously-correct oracle the production containers
   (`parallel.sharded.ShardedMatrix`, `ops.streaming.StreamingMatrix`)
   are cross-checked against in tests; no production workflow
   constructs it.  See ops/operator.py for the role split.

The operator semantics replace both the reference's dense in-memory
matrix path (/root/reference/src/vcf.rs:317-345 + efficient_pca `rfit`)
and its lazy block accessor (/root/reference/src/prepare.rs:1838-2029):

* Genotypes live as int8 SNP-major strips (missing = -127, the reference
  sentinel, prepare.rs:1224) either resident in device HBM or streamed
  from host with prefetch.
* The implicit operator is A = diag(inv_std) * (G - mean), shape D x N
  (variants x samples), never materialized.  Standardization fuses into
  each consuming matmul (the XLA analog of the reference's fused SIMD
  standardize at prepare.rs:1946-2013).
* Every product is expressed as a per-strip matmul plus a sum over
  strips, so the variant axis shards trivially: on a mesh, each shard
  owns its strips and partial results merge with `psum`
  (parallel/sharded.py).

Core primitives (all jitted, static strip shapes — strips are padded to a
fixed size so one compiled program serves every strip):

  gram_apply(strips, B)  ->  A^T (A B)   (N x l) — one power-iteration pass
  right_apply(strips, B) ->  per-strip A_s B  (for loadings / projections)
  tsq_accumulate(strips, B) -> (A B)^T (A B)  (l x l) condensed Gram
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Iterator, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from genomic_pca_tpu.ops.standardize import standardize_rows as _standardize

MISSING = -127

# The reference products pin HIGHEST: without it an f32 matmul may run
# reduced-precision passes (TF32 on a GPU), and this container is the
# f32 yardstick the production products are checked against.
_PRECISION = jax.lax.Precision.HIGHEST


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.dot(
        a, b, preferred_element_type=jnp.float32, precision=_PRECISION
    )


@jax.jit
def _strip_gram_apply(
    g_i8: jax.Array, mean: jax.Array, inv_std: jax.Array, b: jax.Array
) -> jax.Array:
    """A_s^T (A_s B) for one strip: (N, l) partial result."""
    a = _standardize(g_i8, mean, inv_std)
    w = _dot(a, b)  # (d_s, l)
    return _dot(a.T, w)  # (N, l)


@jax.jit
def _strip_right_apply(
    g_i8: jax.Array, mean: jax.Array, inv_std: jax.Array, b: jax.Array
) -> jax.Array:
    """A_s B for one strip: (d_s, l)."""
    a = _standardize(g_i8, mean, inv_std)
    return _dot(a, b)


@dataclasses.dataclass
class Strip:
    """One padded SNP strip: device int8 block + standardization vectors.

    `n_rows` is the number of real (unpadded) SNP rows; padded rows have
    inv_std == 0 so they standardize to zero and contribute nothing.
    """

    geno: jax.Array  # int8 (strip_size, n_samples)
    mean: jax.Array  # f32 (strip_size,)
    inv_std: jax.Array  # f32 (strip_size,)
    n_rows: int


class StripedMatrix:
    """The implicit standardized matrix A (D x N) as a list of strips."""

    def __init__(self, strips: List[Strip], n_samples: int):
        self.strips = strips
        self.n_samples = n_samples
        self.n_rows = sum(s.n_rows for s in strips)

    @staticmethod
    def from_arrays(
        geno_strips: Iterator[np.ndarray],
        means: Optional[Sequence[np.ndarray]] = None,
        stds: Optional[Sequence[np.ndarray]] = None,
        strip_size: int = 2048,
        center_only: bool = False,
        device=None,
    ) -> "StripedMatrix":
        """Build from host int8 arrays, repacking/padding to `strip_size`.

        If `means`/`stds` are None they are computed from the data
        (exact integer-histogram moments).  `center_only=True` sets all
        inv_std to 1 (the VCF workflow's center-without-scale semantics,
        matching the oracle tests/pca.py:109).
        """
        from genomic_pca_tpu.ops.qc import genotype_counts

        pend_g: List[np.ndarray] = []
        pend_m: List[np.ndarray] = []
        pend_s: List[np.ndarray] = []
        strips: List[Strip] = []
        n_samples = None

        def flush(final: bool) -> None:
            nonlocal pend_g, pend_m, pend_s
            if not pend_g:
                return
            g = np.concatenate(pend_g, axis=0)
            m = np.concatenate(pend_m, axis=0)
            s = np.concatenate(pend_s, axis=0)
            pos = 0
            while g.shape[0] - pos >= strip_size or (final and pos < g.shape[0]):
                end = min(pos + strip_size, g.shape[0])
                strips.append(
                    _make_strip(
                        g[pos:end], m[pos:end], s[pos:end], strip_size, device
                    )
                )
                pos = end
            pend_g = [g[pos:]] if pos < g.shape[0] else []
            pend_m = [m[pos:]] if pos < g.shape[0] else []
            pend_s = [s[pos:]] if pos < g.shape[0] else []

        for i, g in enumerate(geno_strips):
            g = np.asarray(g, dtype=np.int8)
            if n_samples is None:
                n_samples = g.shape[1]
            if means is not None and stds is not None:
                m = np.asarray(means[i], dtype=np.float32)
                s = np.asarray(stds[i], dtype=np.float32)
            else:
                n0, n1, n2, nv = (
                    np.asarray(a) for a in genotype_counts(jnp.asarray(g))
                )
                with np.errstate(divide="ignore", invalid="ignore"):
                    m = np.where(nv > 0, (n1 + 2.0 * n2) / np.maximum(nv, 1), 0.0)
                    ssd = (n1 + 4.0 * n2) - nv * m * m
                    var = np.where(nv >= 2, ssd / np.maximum(nv - 1, 1), 0.0)
                    s = np.sqrt(np.maximum(var, 0.0))
                m = m.astype(np.float32)
                s = s.astype(np.float32)
            if center_only:
                s = np.ones_like(m)
            pend_g.append(g)
            pend_m.append(m)
            pend_s.append(s)
            flush(final=False)
        flush(final=True)
        if n_samples is None:
            raise ValueError("No strips provided.")
        return StripedMatrix(strips, n_samples)

    # ---- linear-algebra passes -------------------------------------

    def gram_apply(self, b: jax.Array) -> jax.Array:
        """A^T (A B): one full streaming pass. B is (N, l)."""
        acc = jnp.zeros((self.n_samples, b.shape[1]), dtype=jnp.float32)
        for s in self.strips:
            acc = acc + _strip_gram_apply(s.geno, s.mean, s.inv_std, b)
        return acc

    def right_apply_strips(self, b: jax.Array) -> List[jax.Array]:
        """A B computed per strip; padded rows included (zero)."""
        return [_strip_right_apply(s.geno, s.mean, s.inv_std, b) for s in self.strips]

    def right_apply(self, b: jax.Array) -> np.ndarray:
        """A B materialized on host with padding removed: (D, l)."""
        outs = []
        for s, c in zip(self.strips, self.right_apply_strips(b)):
            outs.append(np.asarray(c)[: s.n_rows])
        return np.concatenate(outs, axis=0)

    def tsq_accumulate(self, b: jax.Array) -> jax.Array:
        """(A B)^T (A B) = B^T A^T A B accumulated strip-wise: (l, l)."""
        acc = jnp.zeros((b.shape[1], b.shape[1]), dtype=jnp.float32)
        for s in self.strips:
            c = _strip_right_apply(s.geno, s.mean, s.inv_std, b)
            acc = acc + _dot(c.T, c)
        return acc


def _make_strip(
    g: np.ndarray, mean: np.ndarray, std: np.ndarray, strip_size: int, device
) -> Strip:
    n_rows, n_samples = g.shape
    if n_rows < strip_size:
        pad = strip_size - n_rows
        g = np.concatenate([g, np.zeros((pad, n_samples), dtype=np.int8)], axis=0)
        mean = np.concatenate([mean, np.zeros(pad, dtype=np.float32)])
        std = np.concatenate([std, np.zeros(pad, dtype=np.float32)])
    from genomic_pca_tpu.parallel.sharded import inv_std_of

    inv_std = inv_std_of(std).astype(np.float32)
    put = partial(jax.device_put, device=device) if device is not None else jax.device_put
    return Strip(
        geno=put(g),
        mean=put(mean.astype(np.float32)),
        inv_std=put(inv_std),
        n_rows=n_rows,
    )
