"""The flat scan's pass-1 group-min kernel (Pallas through Triton) and the
choice of pass-1 route.

On the CPU the kernel runs in the Pallas interpreter against a float64
numpy reference, and its lowering to Triton is checked at the main path's
real shapes (1M x 768 bf16). Tests marked ``gpu`` run it compiled for the
card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from vettore_tpu.index.flat import FlatIndex
from vettore_tpu.ops import flat_scan

RNG = np.random.default_rng(1234)


def _block(n, d, dtype, dead=()):
    x = RNG.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    bias = np.zeros(n, np.float32)
    for i in dead:
        x[i] = 0.0  # the flat index zeroes dead slots
        bias[i] = np.inf
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    xsq = np.sum(x.astype(np.float32) ** 2, axis=1, dtype=np.float32)
    return x, xsq, bias


def _queries(b, d):
    q = RNG.standard_normal((b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _ref_gmin(x, xsq, bias, q, metric):
    """float64 group minima of the rank matrix the kernel reduces (bf16
    blocks take the query at storage precision, as the kernel does)."""
    xd = x.astype(np.float64)
    qd = q.astype(x.dtype).astype(np.float64)
    dots = qd @ xd.T
    if metric == "l2":
        rank = xsq.astype(np.float64)[None, :] - 2.0 * dots + (
            q.astype(np.float64) ** 2).sum(1)[:, None]
    else:
        rank = -dots
    rank = rank + bias[None, :]
    return rank.reshape(q.shape[0], -1, flat_scan.GROUP).min(axis=2)


@pytest.mark.parametrize("n,b,d", [(128, 1, 64), (1024, 3, 96),
                                   (2048, 64, 64), (1024, 17, 80)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["inner_product", "l2"])
def test_gmin_kernel_interpret_matches_numpy(n, b, d, dtype, metric):
    """Several block sizes, query counts that need padding (1, 3, 17) and
    one that fills a tile (64), both rank families, dead rows."""
    x, xsq, bias = _block(n, d, dtype, dead=(0, 5, n - 1))
    q = _queries(b, d)
    gmin, bounded = flat_scan._gmin_scan(
        jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(bias), jnp.asarray(q),
        metric=metric, interpret=True)
    assert gmin.shape == (b, n // flat_scan.GROUP)
    assert bool(bounded)
    tol = 1e-5 if dtype == "f32" else 2e-3
    np.testing.assert_allclose(np.asarray(gmin),
                               _ref_gmin(x, xsq, bias, q, metric),
                               rtol=tol, atol=tol)


def test_gmin_kernel_dead_group_is_inf():
    n, d = 256, 64
    x, xsq, bias = _block(n, d, "bf16", dead=range(64, 128))
    q = _queries(2, d)
    gmin, _ = flat_scan._gmin_scan(jnp.asarray(x), jnp.asarray(xsq),
                                   jnp.asarray(bias), jnp.asarray(q),
                                   metric="cosine", interpret=True)
    gmin = np.asarray(gmin)
    assert np.isinf(gmin[:, 1]).all() and np.isfinite(gmin[:, [0, 2, 3]]).all()


def test_gmin_kernel_overflow_bound_flags_batch():
    """Rows whose norm product could overflow an f32 accumulator fail the
    wrapper's Cauchy-Schwarz bound (the caller then takes the host oracle)."""
    n, d = 128, 64
    x, xsq, bias = _block(n, d, "f32")
    x[3] *= 1e19  # squared norm 1e38: finite, past the per-term cap
    xsq = np.sum(x.astype(np.float64) ** 2, axis=1).astype(np.float32)
    q = _queries(1, d) * 1e10
    _, bounded = flat_scan._gmin_scan(jnp.asarray(x), jnp.asarray(xsq),
                                      jnp.asarray(bias), jnp.asarray(q),
                                      metric="l2", interpret=True)
    assert not bool(bounded)


def test_gmin_kernel_refuses_untileable_blocks():
    x = jnp.zeros((192, 64), jnp.bfloat16)  # 192 rows: not a 128-row multiple
    with pytest.raises(ValueError, match="pass-1 kernel"):
        flat_scan._gmin_scan(x, jnp.zeros(192), jnp.zeros(192),
                             jnp.zeros((1, 64)), metric="cosine", interpret=True)


def _exact_topk(x, bias, q, metric, k):
    xd = x.astype(np.float64)
    qd = q.astype(np.float64)
    if metric in ("l2", "l2_squared"):
        sq = ((xd[None, :, :] - qd[:, None, :]) ** 2).sum(-1)
        raw = np.sqrt(sq) if metric == "l2" else sq
        rank = raw
    else:
        dots = qd @ xd.T
        raw = -dots if metric == "negative_inner_product" else dots
        rank = -dots
    rank = np.where(np.isfinite(bias)[None, :], rank, np.inf)
    order = np.argsort(rank, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(raw, order, axis=1)


@pytest.mark.parametrize("metric", ["cosine", "inner_product",
                                    "negative_inner_product", "l2", "l2_squared"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_search_triton_route_interpret(metric, dtype):
    """The whole search through the kernel route (interpreter) returns the
    exact top-k of the stored rows, ids and raws, with ``ok`` set."""
    n, d, b, k = 1024, 64, 5, 8
    x, xsq, bias = _block(n, d, dtype, dead=(2, 700))
    q = _queries(b, d)
    lex_rank = np.arange(n, dtype=np.int32)
    slots, raws, _ranks, ok = flat_scan.fused_flat_search(
        jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(bias),
        jnp.asarray(lex_rank), jnp.asarray(q), metric=metric, k=k,
        impl="triton", interpret=True)
    assert bool(ok)
    want_slots, want_raws = _exact_topk(x, bias, q, metric, k)
    np.testing.assert_array_equal(np.asarray(slots), want_slots)
    np.testing.assert_allclose(np.asarray(raws), want_raws, atol=1e-5)


def test_fused_search_routes_agree_on_f32():
    """f32 storage: both pass-1 routes rank at full precision and return
    identical results."""
    n, d, b, k = 2048, 96, 4, 16
    x, xsq, bias = _block(n, d, "f32", dead=(9,))
    q = _queries(b, d)
    args = (jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(bias),
            jnp.arange(n, dtype=jnp.int32), jnp.asarray(q))
    tri = flat_scan.fused_flat_search(*args, metric="l2", k=k, impl="triton",
                                      interpret=True)
    xla = flat_scan.fused_flat_search(*args, metric="l2", k=k, impl="xla")
    np.testing.assert_array_equal(np.asarray(tri[0]), np.asarray(xla[0]))
    np.testing.assert_allclose(np.asarray(tri[1]), np.asarray(xla[1]),
                               rtol=1e-6)
    assert bool(tri[3]) and bool(xla[3])


def test_fused_search_rejects_unknown_route():
    with pytest.raises(ValueError, match="unknown pass-1 impl"):
        flat_scan.fused_flat_search(
            jnp.zeros((128, 16)), jnp.zeros(128), jnp.zeros(128),
            jnp.arange(128, dtype=jnp.int32), jnp.zeros((1, 16)),
            metric="cosine", k=4, impl="mosaic")


@pytest.mark.parametrize("b,tile", [(1, 16), (3, 16), (16, 16), (17, 32),
                                    (64, 64), (100, 128), (512, 128)])
def test_query_tile(b, tile):
    assert flat_scan._query_tile(b) == tile


@pytest.mark.parametrize("n,b,d,want", [
    (1_000_448, 512, 768, flat_scan.Tiles(256, 128, 64, 8, 3)),
    (1_000_448, 64, 768, flat_scan.Tiles(256, 64, 64, 4, 3)),
    (1_000_448, 1, 768, flat_scan.Tiles(256, 16, 64, 4, 3)),
    (1152, 3, 96, flat_scan.Tiles(128, 16, 32, 4, 3)),
    (2048, 200, 80, flat_scan.Tiles(256, 128, 16, 8, 3)),
])
def test_default_tiles(n, b, d, want):
    """Rows per block divide the block (256 where they can, else 128); the
    query tile covers the batch up to 128; the K step divides d."""
    assert flat_scan._tiles(n, b, d) == want


def test_default_tiles_f32_keeps_128_rows():
    assert flat_scan._tiles(1_000_448, 512, 768, 4) == flat_scan.Tiles(128, 128, 64, 8, 3)


@pytest.mark.parametrize("platform,dtype,n,d,want", [
    ("gpu", jnp.bfloat16, 1_048_576, 768, "triton"),
    ("gpu", jnp.bfloat16, 100_352, 384, "triton"),
    ("gpu", jnp.bfloat16, 1024, 16, "triton"),
    ("gpu", jnp.float32, 1_048_576, 768, "xla"),
    ("gpu", jnp.bfloat16, 1_048_576, 100, "xla"),  # no K step divides d
    ("gpu", jnp.bfloat16, 1088, 768, "xla"),  # not a 128-row multiple
    ("cpu", jnp.bfloat16, 1_048_576, 768, "xla"),
    ("cpu", jnp.float32, 1_048_576, 768, "xla"),
])
def test_pass1_impl_choice(platform, dtype, n, d, want):
    assert flat_scan.pass1_impl(platform, dtype, n, d) == want


@pytest.mark.parametrize("storage,n,fused", [
    ("f32", 2000, True), ("bf16", 2000, True), ("int8", 2000, False),
    ("f32", 500, False)])
def test_flat_index_takes_group_scan(storage, n, fused):
    """The group-min scan serves f32 and bf16 blocks of >= 1024 slots; int8
    storage and small blocks take the elementwise XLA scan."""
    idx = FlatIndex("cosine", storage=storage)
    x = _queries(n, 32)
    idx.put_matrix([f"r{i:05d}" for i in range(n)], x)
    idx._sync_device()
    assert idx._fused_eligible(16) is fused
    hits = idx.search_batch(x[:3], 4)
    assert [h[0][0] for h in hits] == [f"r{i:05d}" for i in range(3)]


@pytest.mark.parametrize("b", [1, 64, 512])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_kernel_lowers_to_triton_at_main_path_shapes(b, metric):
    """The main path's shapes (1M x 768 bf16, batch 1 / 64 / 512) lower
    through the Pallas Triton route for CUDA: power-of-two blocks, dot
    operand sizes, the K loop. Lowering needs no card; compiling does."""
    n, d = 1_048_576, 768
    fn = jax.jit(lambda x, xsq, bias, q: flat_scan._gmin_scan(
        x, xsq, bias, q, metric=metric))
    lowered = fn.trace(
        jax.ShapeDtypeStruct((n, d), jnp.bfloat16),
        jax.ShapeDtypeStruct((n,), jnp.float32),
        jax.ShapeDtypeStruct((n,), jnp.float32),
        jax.ShapeDtypeStruct((b, d), jnp.float32),
    ).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text and "flat_gmin_scan" in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_gmin_kernel_compiled_matches_numpy(gpu_device, metric):
    n, d, b = 65_536, 768, 64
    x, xsq, bias = _block(n, d, "bf16", dead=(0, 4096))
    q = _queries(b, d)
    gmin, bounded = flat_scan._gmin_scan(
        jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(bias), jnp.asarray(q),
        metric=metric)
    assert bool(bounded)
    np.testing.assert_allclose(np.asarray(gmin),
                               _ref_gmin(x, xsq, bias, q, metric),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
def test_default_route_on_gpu_is_the_kernel(gpu_device):
    """bf16 storage on the GPU compiles the Triton kernel into the search,
    and returns the exact top-k of the stored rows."""
    n, d, b, k = 65_536, 768, 32, 16
    x, xsq, bias = _block(n, d, "bf16", dead=(7,))
    q = _queries(b, d)
    args = (jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(bias),
            jnp.arange(n, dtype=jnp.int32), jnp.asarray(q))
    hlo = flat_scan.fused_flat_search.lower(
        *args, metric="cosine", k=k).compile().as_text()
    assert "flat_gmin_scan" in hlo
    slots, raws, _r, ok = flat_scan.fused_flat_search(*args, metric="cosine", k=k)
    assert bool(ok)
    want_slots, want_raws = _exact_topk(x, bias, q, "cosine", k)
    np.testing.assert_allclose(np.asarray(raws), want_raws, atol=1e-4)
    overlap = np.mean([len(set(g) & set(w)) / k for g, w in
                       zip(np.asarray(slots).tolist(), want_slots.tolist())])
    assert overlap >= 0.99
