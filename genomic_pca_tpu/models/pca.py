"""Streamed randomized PCA — the `rfit`/`transform` equivalent.

Re-creates the compute contract of `efficient_pca::PCA` as used by the VCF
workflow (/root/reference/src/main.rs:595-680): fit a rank-k PCA of the
(samples x variants) dosage matrix by randomized SVD and project samples
into PC space.  Input validation mirrors pca_runner::run_genomic_pca
(main.rs:607-634): k >= 1, n_samples >= 2, n_features >= 1, and k is
clamped to min(n, d) with a warning.

Formulation: the matrix lives as int8 or 2-bit strips (ops/products.py)
and the randomized SVD runs as subspace iteration in the small sample
dimension —

    B_0   = N(0,1) sketch  (n_samples x l),  l = k + oversamples
    B_t+1 = qr( A^T A B_t )          # one streamed pass per iteration
    G     = B^T A^T A B;  eigh(G) -> (W, sigma^2)
    V     = B W  (right singular vectors);  scores = V * sigma
    U     = A V / sigma   (loadings, streamed)

so device memory stays O(N*l) however many variants stream through, and
every FLOP is a matmul over standardized strips.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from genomic_pca_tpu.errors import ComputeError
from genomic_pca_tpu.ops.operator import StandardizedOperator
from genomic_pca_tpu.utils.rng import key_from_words, seed_words

log = logging.getLogger(__name__)

SKETCH_FILL = 128


@functools.partial(jax.jit, static_argnames=("n", "ell"))
def _sketch_prog(kwords, n: int, ell: int):
    """rfit's Gaussian sketch as ONE program: the key derives in-program
    from raw seed words (one compile instead of the eager
    `key_for_stage` + `jax.random.normal` chain's three; same bits)."""
    key = key_from_words(kwords, "rfit_sketch")
    return jax.random.normal(key, (n, ell), dtype=jnp.float32)


def lane_fill_width(ell: int, n: int, d: int) -> int:
    """Round a sketch width up to a multiple of 128 (capped by the
    matrix dims).

    A wider sketch buys better subspace convergence per pass; at the
    reference's defaults (k=10, oversampling 10 -> ell=20,
    /root/reference/src/main.rs:648-656) it multiplies the power-pass
    work by 128/20.  Whether that trade pays on a given device is a
    measurement (ROADMAP S4).
    """
    cap = min(n, d)
    filled = -(-ell // SKETCH_FILL) * SKETCH_FILL
    return max(ell, min(filled, cap))


@dataclasses.dataclass
class PcaResult:
    scores: np.ndarray  # (n_samples, k) = V * sigma
    eigenvalues: np.ndarray  # (k,) explained variance sigma^2 / (n_samples - 1)
    singular_values: np.ndarray  # (k,)
    loadings: Optional[np.ndarray]  # (n_variants, k) or None if not requested
    k: int
    # Power iterations actually run (< n_power_iter when a tolerance
    # triggered early exit; equal otherwise).
    n_iter_done: Optional[int] = None


def validate_k(k: int, n_samples: int, n_features: int) -> int:
    """k validation with the reference's clamp/warn semantics."""
    if n_samples < 2:
        raise ComputeError(f"PCA requires at least 2 samples, got {n_samples}.")
    if n_features < 1:
        raise ComputeError("PCA requires at least 1 feature.")
    if k < 1:
        raise ComputeError(f"Number of components k must be >= 1, got {k}.")
    upper = min(n_samples, n_features)
    if k > upper:
        log.warning(
            "Requested k=%d exceeds min(n_samples, n_features)=%d; clamping.",
            k,
            upper,
        )
        return upper
    return k


def streamed_pca(
    matrix: StandardizedOperator,
    k: int,
    n_oversamples: int = 10,
    n_power_iter: int = 4,
    seed: Optional[int] = None,
    compute_loadings: bool = False,
    lane_fill: bool = True,
    tolerance: Optional[float] = None,
) -> PcaResult:
    """Randomized PCA of the implicit standardized matrix A (D x N).

    `lane_fill=True` (default) widens the sketch to a multiple of 128
    columns for better convergence per pass (see `lane_fill_width`).

    `tolerance` completes the `rfit` API contract
    (/root/reference/src/main.rs:648-656, tolerance: Option<f64>): the
    power loop early-exits once the relative subspace residual
    ||T - B(B^T T)||_F / ||T||_F of a pass drops below it.  None (the
    reference's only observed value) runs all `n_power_iter` passes.
    """
    n = matrix.n_samples
    d = matrix.n_rows
    k = validate_k(k, n, d)
    ell = min(k + n_oversamples, min(n, d))
    if lane_fill:
        ell = lane_fill_width(ell, n, d)

    b = _sketch_prog(seed_words(seed if seed is not None else 0), n, ell)

    n_iter = max(n_power_iter, 1)
    n_done = n_iter
    if hasattr(matrix, "pca_core"):
        # Entire PCA (power loop + eigensolve + loadings) as ONE compiled
        # program/dispatch (ShardedMatrix).
        out = matrix.pca_core(b, n_iter, k, tolerance=tolerance)
        if tolerance is None:
            v_k, sigma_k, evals_k, loadings_full = out
        else:
            v_k, sigma_k, evals_k, loadings_full, n_done = out
            if n_done < n_iter:
                log.info(
                    "rfit tolerance %.3g reached after %d / %d power "
                    "iterations.", tolerance, n_done, n_iter,
                )
        # Finalization math on HOST (the arrays download anyway): an
        # eager device multiply here would cost one more compile.
        sigma_np = np.asarray(sigma_k)
        return PcaResult(
            scores=np.asarray(v_k) * sigma_np[None, :],
            eigenvalues=np.asarray(evals_k) / max(n - 1, 1),
            singular_values=sigma_np,
            loadings=loadings_full if compute_loadings else None,
            k=k,
            n_iter_done=n_done,
        )
    elif hasattr(matrix, "power_iterate"):
        # Whole loop on device in one dispatch.
        out = matrix.power_iterate(b, n_iter, tolerance=tolerance)
        if tolerance is None:
            b = out
        else:
            b, n_done = out
    else:
        for it in range(n_iter):
            t = matrix.gram_apply(b)  # A^T A B, one streamed pass
            res = None
            if tolerance is not None and it > 0:
                from genomic_pca_tpu.ops.rsvd import subspace_residual

                res = float(subspace_residual(b, t))
            b, _ = jnp.linalg.qr(t)
            if res is not None and res < tolerance:
                n_done = it + 1
                break

    # Streaming containers fuse the condensed Gram with an A B capture
    # when loadings are wanted: loadings = (A B) W / sigma, saving the
    # separate right_apply pass (a full re-read of the matrix).
    fused = compute_loadings and hasattr(matrix, "tsq_and_capture")
    if fused:
        g, ab = matrix.tsq_and_capture(b)  # (l, l), (D, l) host
    else:
        g = matrix.tsq_accumulate(b)  # B^T A^T A B (l x l)
    evals, w = jnp.linalg.eigh(g)  # ascending
    order = jnp.argsort(-evals)
    evals = jnp.maximum(evals[order], 0.0)
    w = w[:, order]
    sigma = jnp.sqrt(evals)
    # (n, l) right singular vectors, HIGHEST: they are the scores.
    v = jnp.dot(b, w, precision=jax.lax.Precision.HIGHEST)

    v_k = v[:, :k]
    sigma_k = sigma[:k]
    scores = np.asarray(v_k * sigma_k[None, :])
    eigenvalues = np.asarray(evals[:k]) / max(n - 1, 1)

    loadings = None
    if compute_loadings:
        inv_sigma = np.asarray(
            jnp.where(sigma_k > 0, 1.0 / jnp.where(sigma_k > 0, sigma_k, 1.0), 0.0)
        )
        if fused:
            loadings = (ab @ np.asarray(w)[:, :k]) * inv_sigma[None, :]
        else:
            loadings = matrix.right_apply(v_k) * inv_sigma[None, :]

    if tolerance is not None and n_done < n_iter:
        log.info(
            "rfit tolerance %.3g reached after %d / %d power iterations.",
            tolerance, n_done, n_iter,
        )
    return PcaResult(
        scores=scores,
        eigenvalues=eigenvalues,
        singular_values=np.asarray(sigma_k),
        loadings=loadings,
        k=k,
        n_iter_done=n_done,
    )


def transform(
    new_geno: np.ndarray,
    loadings: np.ndarray,
    mean: np.ndarray,
    std: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Project NEW samples into the fitted PC space (PCA::transform
    equivalent, /root/reference/src/main.rs:659-660).

    `new_geno` is (n_snps, n_new_samples) int8 dosages over the SAME SNP
    set (PcaSnpId order) the model was fitted on; `mean`/`std` are the
    TRAINING standardization moments (std=None -> center-only, the VCF
    workflow convention).  Missing (-127) imputes to the training mean.
    Returns (n_new_samples, k) scores.

    SNPs with std == 0 (monomorphic in training) contribute ZERO — the
    inert-row convention of the fit path and of `transform_device`
    (inv_std = 0), so the two transform paths agree on any input.
    """
    g = np.asarray(new_geno, dtype=np.float64)
    valid = np.asarray(new_geno) != -127
    mean = np.asarray(mean, dtype=np.float64)
    x = np.where(valid, g, mean[:, None]) - mean[:, None]
    if std is not None:
        s = np.asarray(std, dtype=np.float64)
        x *= np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)[:, None]
    return (x.T @ np.asarray(loadings, dtype=np.float64)).astype(np.float32)


def transform_device(
    new_geno: np.ndarray,
    loadings: np.ndarray,
    mean: np.ndarray,
    std: Optional[np.ndarray] = None,
    mesh=None,
) -> np.ndarray:
    """Device-path `transform`: same contract as `transform`, but the
    standardize + projection contraction runs on the accelerator.

    Builds the sharded standardized operator over the NEW samples with
    the TRAINING moments and projects through the fitted loadings via
    `ShardedMatrix.left_apply` — the variant axis shards over the mesh
    and only the (n_new, k) result crosses back.  Missing genotypes
    standardize to zero = impute-to-training-mean, identical to the
    host path."""
    from genomic_pca_tpu.parallel.sharded import ShardedMatrix

    new_geno = np.asarray(new_geno, dtype=np.int8)
    d = new_geno.shape[0]
    stds = (
        np.ones(d, dtype=np.float32)
        if std is None
        else np.asarray(std, dtype=np.float32)
    )
    sm = ShardedMatrix.from_arrays(
        iter([new_geno]),
        means=[np.asarray(mean, dtype=np.float32)],
        stds=[stds],
        mesh=mesh,
    )
    return sm.left_apply(np.asarray(loadings, dtype=np.float32)).astype(
        np.float32
    )


class StripProjector:
    """One compiled projection program reused across equal-shape strips.

    `transform_device` builds a fresh `ShardedMatrix` (fresh mesh +
    freshly closed-over jitted kernels) per call, so calling it inside a
    per-strip loop re-traces the projection for every strip.  This class
    compiles the standardize + contraction ONCE for a fixed
    (strip_rows, n_new, k) shape; tail strips (and monomorphic /
    std == 0 SNPs) are handled by inert rows (inv_std = 0), the same
    convention as the fit path.  Inputs shard over the variant axis of
    the mesh; only the (n_new, k) partial scores cross back per strip.
    """

    def __init__(
        self,
        strip_rows: int,
        n_new: int,
        k: int,
        mesh=None,
    ) -> None:
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from genomic_pca_tpu.parallel.mesh import VARIANT_AXIS, make_mesh

        self.mesh = mesh or make_mesh()
        n_dev = self.mesh.devices.size
        # Pad rows to a multiple of 8 per device so the variant-axis
        # shard is even and aligned.
        unit = n_dev * 8
        self.rows = -(-strip_rows // unit) * unit
        self.n_new = int(n_new)
        self.k = int(k)
        self._row_sh = NamedSharding(self.mesh, P(VARIANT_AXIS, None))
        self._vec_sh = NamedSharding(self.mesh, P(VARIANT_AXIS))

        def _project(g, mean, inv_std, w):
            x = (
                jnp.where(g != -127, g.astype(jnp.float32), mean[:, None])
                - mean[:, None]
            )
            # inv_std = 0 rows (padding / monomorphic) are inert here.
            x = x * inv_std[:, None]
            # HIGHEST: projected scores are user-visible output, and a
            # GPU would otherwise run this f32 contraction in TF32.
            return jnp.einsum(
                "dn,dk->nk", x, w, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )

        self._fn = jax.jit(
            _project,
            in_shardings=(
                self._row_sh,
                self._vec_sh,
                self._vec_sh,
                self._row_sh,
            ),
            out_shardings=NamedSharding(self.mesh, P(None, None)),
        )

    def __call__(
        self,
        g_strip: np.ndarray,
        loadings: np.ndarray,
        mean: np.ndarray,
        std: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Partial scores (n_new, k) for one strip of model SNP rows."""
        import jax

        g_strip = np.asarray(g_strip, dtype=np.int8)
        r = g_strip.shape[0]
        if r > self.rows or g_strip.shape[1] != self.n_new:
            raise ValueError(
                f"strip shape {g_strip.shape} exceeds projector shape "
                f"({self.rows}, {self.n_new})"
            )
        g = np.zeros((self.rows, self.n_new), dtype=np.int8)
        g[:r] = g_strip
        m = np.zeros(self.rows, dtype=np.float32)
        m[:r] = np.asarray(mean, dtype=np.float32)
        iv = np.zeros(self.rows, dtype=np.float32)
        if std is None:
            iv[:r] = 1.0
        else:
            s = np.asarray(std, dtype=np.float32)
            iv[:r] = np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)
        w = np.zeros((self.rows, self.k), dtype=np.float32)
        w[:r] = np.asarray(loadings, dtype=np.float32)
        out = self._fn(
            jax.device_put(g, self._row_sh),
            jax.device_put(m, self._vec_sh),
            jax.device_put(iv, self._vec_sh),
            jax.device_put(w, self._row_sh),
        )
        return np.asarray(out, dtype=np.float32)
