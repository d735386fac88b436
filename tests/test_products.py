"""The plain-XLA operator products (ops/products.py) against numpy
float64 references: every product in every layout and precision, the
quantized steering pass against its exact quantization model, the 2-bit
unpack, and the strip-size rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genomic_pca_tpu.ops import products
from genomic_pca_tpu.parallel.sharded import pack_int8_rows, packed_cols
from tests.conftest import make_genotypes

D, N, L, STEP = 256, 200, 24, 64


def _moments(g):
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    cnt = np.maximum(valid.sum(axis=1), 1)
    mean = g0.sum(axis=1) / cnt
    std = np.sqrt((((g0 - mean[:, None]) ** 2) * valid).sum(axis=1)
                  / np.maximum(cnt - 1, 1))
    iv = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 0.0)
    return mean.astype(np.float32), iv.astype(np.float32)


def _dense_a(g, mean, iv, cols):
    """float64 standardized (D, cols) matrix; padding columns are 0."""
    a = np.zeros((g.shape[0], cols))
    x = (g.astype(np.float64) - mean[:, None]) * iv[:, None]
    a[:, : g.shape[1]] = np.where(g != -127, x, 0.0)
    return a


def _layout(g, packed):
    """Device genotypes in the containers' padded layout + column count."""
    if packed:
        gp = np.full((g.shape[0], packed_cols(g.shape[1])), 0x55, np.uint8)
        p = pack_int8_rows(g)
        gp[:, : p.shape[1]] = p
        return jnp.asarray(gp), 4 * gp.shape[1]
    cols = -(-g.shape[1] // 128) * 128
    gd = np.full((g.shape[0], cols), -127, np.int8)
    gd[:, : g.shape[1]] = g
    return jnp.asarray(gd), cols


@pytest.fixture
def case(rng):
    g = make_genotypes(rng, D, N, missing_rate=0.03)
    mean, iv = _moments(g)
    return g, mean, iv


def _rel(got, ref):
    return np.linalg.norm(np.asarray(got, np.float64) - ref) / np.linalg.norm(ref)


# bf16 rounds the standardized operand to ~2^-8 relative, so the
# products agree with float64 to ~1e-2 (Frobenius); f32 at HIGHEST to
# f32 accumulation noise.
TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("product", ["gram", "tsq", "right"])
def test_product_matches_float64(case, rng, product, packed, precision):
    g, mean, iv = case
    gd, cols = _layout(g, packed)
    a = _dense_a(g, mean, iv, cols)
    b = np.zeros((cols, L), np.float32)
    b[:N] = rng.standard_normal((N, L))
    ref = {
        "gram": lambda: a.T @ (a @ b),
        "tsq": lambda: (a @ b).T @ (a @ b),
        "right": lambda: a @ b,
    }[product]()
    got = getattr(products, product)(
        gd, jnp.asarray(mean[:, None]), jnp.asarray(iv[:, None]),
        jnp.asarray(b), precision=precision, step=STEP,
    )
    assert got.shape == ref.shape
    assert _rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_left_matches_float64(case, rng, packed):
    g, mean, iv = case
    gd, cols = _layout(g, packed)
    a = _dense_a(g, mean, iv, cols)
    w = rng.standard_normal((D, 5)).astype(np.float32)
    got = products.left(
        gd, jnp.asarray(mean[:, None]), jnp.asarray(iv[:, None]),
        jnp.asarray(w), step=STEP,
    )
    assert _rel(got, a.T @ w) < 1e-5


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_gram_q8_matches_quant_model(case, rng, packed):
    from genomic_pca_tpu.ops.rsvd import quantize_basis

    g, mean, iv = case
    gd, cols = _layout(g, packed)
    b = np.zeros((cols, L), np.float32)
    b[:N] = rng.standard_normal((N, L))
    bq, sb, csum = quantize_basis(jnp.asarray(b))
    iv_c, u_c = iv[:, None], (mean * iv)[:, None]
    got = products.gram_q8(
        gd, jnp.asarray(iv_c), jnp.asarray(u_c), bq, sb, csum, step=STEP
    )
    # The model sees the padded layout as raw dosages (missing -> 0).
    g_model = np.asarray(products.dosages(gd)[0]).astype(np.int64)
    ref = products.gram_q8_reference(
        g_model, iv_c, u_c, np.asarray(bq), np.asarray(sb)[0, 0], STEP,
    )
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4, atol=1e-2)


def test_unpack_all_byte_values():
    """Every byte value unpacks to the count_A1 dosages of its four
    2-bit fields, sample 4j + p from field p, missing (01) invalid."""
    b = np.arange(256, dtype=np.uint8)[:, None]  # one byte per row
    d, valid = products.dosages(jnp.asarray(b))
    d, valid = np.asarray(d), np.asarray(valid)
    assert d.shape == (256, 4)
    for p in range(4):
        code = (b[:, 0] >> (2 * p)) & 3
        np.testing.assert_array_equal(valid[:, p], code != 1)
        expect = np.select([code == 0, code == 2], [2, 1], default=0)
        np.testing.assert_array_equal(d[:, p], expect)
        np.testing.assert_array_equal(
            np.asarray(products.unpack_codes(jnp.asarray(b)))[:, p], code
        )


def test_packed_padding_is_inert(rng):
    """Samples past N (0x55 pad bytes, sanitized partial-byte fields)
    standardize to exactly zero in every product."""
    g = rng.integers(0, 3, size=(32, 7)).astype(np.int8)  # partial byte
    gd, cols = _layout(g, packed=True)
    m = jnp.full((32, 1), 0.7, jnp.float32)
    iv = jnp.full((32, 1), 1.3, jnp.float32)
    x = np.asarray(products.standardize(gd, m, iv))
    assert x.shape == (32, cols)
    assert not x[:, 7:].any()
    np.testing.assert_allclose(x[:, :7], (g - 0.7) * 1.3, rtol=1e-6)


def test_strip_rows_bounds_the_f32_strip():
    budget_rows = products.STRIP_BYTES // (4 * 500_000)
    step = products.strip_rows(500_000, 1024)
    assert step <= budget_rows and 1024 % step == 0
    assert products.strip_rows(2048, 1024) == 1024  # narrow: untouched
    assert products.strip_rows(10**9, 96) == 3  # stops at an odd divisor


def test_exact_precision_rule():
    assert products.exact_precision("q8") == "bf16"
    assert products.exact_precision("bf16") == "bf16"
    assert products.exact_precision("f32") == "f32"
    with pytest.raises(ValueError):
        products.exact_precision("fp8")


@pytest.mark.chip
def test_products_on_gpu(gpu, rng):
    """Each product compiled for the GPU agrees with the CPU result."""
    g = make_genotypes(rng, 512, 384, missing_rate=0.02)
    mean, iv = _moments(g)
    gd, cols = _layout(g, packed=True)
    b = rng.standard_normal((cols, 128)).astype(np.float32)
    args = (gd, jnp.asarray(mean[:, None]), jnp.asarray(iv[:, None]),
            jnp.asarray(b))
    for precision in ("f32", "bf16"):
        want = products.gram(*args, precision=precision, step=128)
        got = products.gram(
            *jax.device_put(args, gpu), precision=precision, step=128
        )
        assert _rel(got, np.asarray(want, np.float64)) < TOL[precision]
