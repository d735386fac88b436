"""genomic_pca_tpu — genomic PCA framework on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of the
SauersML/genomic_pca reference tool (Rust CLI, reference at
/root/reference/src/main.rs:80-130):

* **VCF workflow** — parse a directory of VCF/VCF.GZ files into a dense
  dosage matrix and run randomized-SVD PCA
  (reference: src/main.rs:133-247, src/vcf.rs).
* **EigenSNP workflow** — stream a PLINK BED fileset through QC +
  standardization and run the two-stage LD-block-local → global PCA
  (reference: src/main.rs:250-447, src/prepare.rs).

Compute is JAX-first: int8 dosage strips live on device, QC reductions /
standardize-matmuls are jitted XLA programs (ops/products.py), and the
variant axis shards across a `jax.sharding.Mesh` with `psum`-merged
Gram/sketch contributions for multi-device scale.
"""

__version__ = "0.1.0"

from genomic_pca_tpu.config import (  # noqa: F401
    DataPrepConfig,
    EigenSnpConfig,
    RsvdConfig,
)

_LAZY = {
        "streamed_pca": ("genomic_pca_tpu.models.pca", "streamed_pca"),
        "transform": ("genomic_pca_tpu.models.pca", "transform"),
        "transform_device": ("genomic_pca_tpu.models.pca", "transform_device"),
        "PcaResult": ("genomic_pca_tpu.models.pca", "PcaResult"),
        "prepare_data": ("genomic_pca_tpu.models.prepare", "prepare_data"),
        "PreparedData": ("genomic_pca_tpu.models.prepare", "PreparedData"),
        "compute_eigensnp_pca": (
            "genomic_pca_tpu.models.eigensnp", "compute_eigensnp_pca",
        ),
        "EigenSnpResult": (
            "genomic_pca_tpu.models.eigensnp", "EigenSnpResult",
        ),
        "ShardedMatrix": ("genomic_pca_tpu.parallel.sharded", "ShardedMatrix"),
        "StreamingMatrix": ("genomic_pca_tpu.ops.streaming", "StreamingMatrix"),
        "run_vcf_workflow": ("genomic_pca_tpu.workflows", "run_vcf_workflow"),
        "run_eigensnp_workflow": (
            "genomic_pca_tpu.workflows", "run_eigensnp_workflow",
        ),
        "run_projection_workflow": (
            "genomic_pca_tpu.workflows", "run_projection_workflow",
        ),
}

__all__ = ["DataPrepConfig", "EigenSnpConfig", "RsvdConfig", *_LAZY]


def __getattr__(name):  # PEP 562: keep `import genomic_pca_tpu` light
    """Top-level convenience re-exports of the primary API, resolved
    lazily so importing the package never pulls jax/device backends in
    before the caller wants them (the CLI relies on that for backend
    warm-up ordering).  Resolved names are cached into module globals
    so repeated access costs one dict lookup."""
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        value = getattr(importlib.import_module(mod), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'genomic_pca_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
