"""The standardized-genotype operator contract.

ONE duck-typed interface backs every PCA model in the framework — the
replacement for the reference's `PcaReadyGenotypeAccessor`
trait (/root/reference/src/prepare.rs:1838-2029), lifted from
"fetch me a standardized block" (pull-based, host-side) to "apply the
implicit operator A = diag(1/std) (G - mean)" (push-based, device-side
matmuls), which is the shape matrix hardware wants.

Three containers implement it, each with a distinct, documented role:

* `parallel.sharded.ShardedMatrix` — PRODUCTION, device-resident.  The
  genotype block (int8 or PLINK 2-bit packed) lives sharded over the
  variant axis of a device mesh; passes run under `shard_map` through
  the XLA strip products (ops/products.py) with one `psum` per pass.
  Fastest; used whenever the (packed) matrix fits aggregate device
  memory.
* `ops.streaming.StreamingMatrix` — PRODUCTION, bigger-than-memory.
  Strips live on host (disk/RAM) and stream through the prefetch
  pipeline each pass, round-robin across mesh devices; the condensed
  factors merge once per pass.  Used when the dataset exceeds device
  memory.
* `ops.stream.StripedMatrix` — TEST ORACLE.  The simplest possible
  implementation (a Python list of device strips, plain XLA matmuls,
  f32 at HIGHEST, no mesh, no prefetch).  It exists so the two production
  containers can be cross-checked against an independent
  obviously-correct implementation; it is not reachable from any
  production workflow.

Models (`models.pca.streamed_pca`, `models.eigensnp`) accept any
implementation and feature-detect the optional fast paths.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import jax
import numpy as np


@runtime_checkable
class StandardizedOperator(Protocol):
    """Implicit standardized matrix A (n_rows x n_samples).

    Required: the three streamed products below.  Optional fast paths
    models feature-detect with `hasattr`:

    * `power_iterate(b0, n_iter) -> (N, l)` — the whole subspace-
      iteration loop in one device dispatch.
    * `pca_core(b0, n_iter, k) -> (v, sigma, evals, loadings)` — the
      ENTIRE randomized PCA (power loop, condensed eigensolve,
      loadings) as one compiled program.
    * `tsq_and_capture(b) -> ((l, l), (n_rows, l) host)` — condensed
      Gram fused with an A·B capture so streaming containers finalize
      without an extra full pass.
    """

    n_rows: int
    n_samples: int

    def gram_apply(self, b: jax.Array) -> jax.Array:
        """A^T (A B): (n_samples, l) — one power-iteration pass."""
        ...

    def tsq_accumulate(self, b: jax.Array) -> jax.Array:
        """(A B)^T (A B): (l, l) condensed Gram."""
        ...

    def right_apply(self, b: jax.Array) -> np.ndarray:
        """A B on host with padding removed: (n_rows, l)."""
        ...
