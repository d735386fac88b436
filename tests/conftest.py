"""Test environment: CPU backend with 8 virtual devices.

Multi-device sharding paths are validated on a host-platform device
mesh (SURVEY §4: `xla_force_host_platform_device_count`), so tests never
need an accelerator.  Must run before jax initializes, hence env vars at
import time of conftest.  Tests that need the GPU carry the `chip`
marker and skip from the `gpu` fixture when none is present.
"""

import os
from pathlib import Path

# CPU unless the caller names platforms (the chip tests run with
# JAX_PLATFORMS=cuda,cpu; see README "Tests").
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(Path(__file__).resolve().parent.parent / ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none (these
    tests run on the card, e.g. `JAX_PLATFORMS= pytest -m chip`)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU visible to JAX")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def make_genotypes(
    rng: np.random.Generator,
    n_snps: int,
    n_samples: int,
    missing_rate: float = 0.0,
    n_pops: int = 3,
    fst: float = 0.1,
) -> np.ndarray:
    """Synthetic structured dosages via a Balding-Nichols-like model.

    Population structure ensures PCA has signal to recover, so |r|
    concordance tests are meaningful.  Returns (n_snps, n_samples) int8
    with -127 missing.
    """
    ancestral = rng.uniform(0.1, 0.9, size=n_snps)
    a = ancestral * (1 - fst) / fst
    b = (1 - ancestral) * (1 - fst) / fst
    pop_freqs = rng.beta(a[:, None], b[:, None], size=(n_snps, n_pops))
    pop_of = rng.integers(0, n_pops, size=n_samples)
    freqs = pop_freqs[:, pop_of]  # (snps, samples)
    geno = rng.binomial(2, freqs).astype(np.int8)
    if missing_rate > 0:
        mask = rng.random((n_snps, n_samples)) < missing_rate
        geno = np.where(mask, np.int8(-127), geno)
    return geno


@pytest.fixture
def genotypes(rng):
    return make_genotypes(rng, n_snps=400, n_samples=64, missing_rate=0.01)
