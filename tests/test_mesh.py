"""Mesh-sharded search tests on the virtual 8-device CPU mesh: sharded
results must exactly equal the single-device flat index (same (rank, id)
tie-break), for several mesh layouts."""

import jax
import numpy as np
import pytest

from vettore_tpu.index.flat import FlatIndex
from vettore_tpu.parallel import ShardedFlat, make_mesh

pytestmark = [
    pytest.mark.slow,  # multi-minute: 8-device shard_map compiles
    pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices"),
]


def corpus(n=100, d=16, seed=3):
    rng = np.random.default_rng(seed)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    ids = [f"doc-{i:03d}" for i in range(n)]
    return ids, vectors


@pytest.mark.parametrize("data", [1, 2, 4])
@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_sharded_equals_single_device(data, metric):
    ids, vectors = corpus()
    mesh = make_mesh(data=data)
    sharded = ShardedFlat(metric, mesh, ids, vectors)

    reference = FlatIndex(metric)
    reference.put_many(zip(ids, vectors))

    rng = np.random.default_rng(7)
    queries = rng.normal(size=(5, 16)).astype(np.float32)
    got = sharded.search_batch(queries, 10)
    for q, hits in zip(queries, got):
        expected = reference.search(list(q), 10)
        assert [h[0] for h in hits] == [e[0] for e in expected]
        for (_, hr), (_, er) in zip(hits, expected):
            assert abs(hr - er) <= 1e-5 * max(1.0, abs(er))


def test_sharded_tie_break_matches():
    # many duplicate vectors: ordering must follow ids across shard boundaries
    ids = [f"t-{i:02d}" for i in range(64)]
    vectors = np.ones((64, 4), dtype=np.float32)
    mesh = make_mesh()
    sharded = ShardedFlat("l2", mesh, ids, vectors)
    hits = sharded.search_batch(np.ones((1, 4), dtype=np.float32), 10)[0]
    assert [h[0] for h in hits] == ids[:10]


def test_uneven_rows_pad():
    ids, vectors = corpus(n=13)
    mesh = make_mesh()
    sharded = ShardedFlat("cosine", mesh, ids, vectors)
    hits = sharded.search_batch(vectors[3][None, :], 5)[0]
    assert hits[0][0] == "doc-003"
    assert len(hits) == 5


@pytest.mark.parametrize("data,k", [(1, 5), (2, 10)])
def test_ici_merge_cost_model(data, k):
    """The stated interconnect merge cost model must equal the all_gather bytes in
    the program the compiler actually sees."""
    import functools

    import jax.numpy as jnp

    from vettore_tpu.parallel.cost import (
        expected_merge_bytes, traced_allgather_bytes)
    from vettore_tpu.parallel.mesh import sharded_search

    ids, vectors = corpus(n=64)
    mesh = make_mesh(data=data)
    sharded = ShardedFlat("cosine", mesh, ids, vectors)
    b = 4
    got = traced_allgather_bytes(
        functools.partial(sharded_search, mesh), sharded._x, sharded._valid,
        sharded._lex, jnp.asarray(vectors[:b]), metric="cosine", k=k)
    want = expected_merge_bytes(mesh.shape["shard"], b // data, k)
    assert got == want


class TestShardedHnsw:
    @pytest.mark.parametrize("data", [1, 2])
    def test_sharded_hnsw_matches_exact_on_clusters(self, data):
        from vettore_tpu.parallel import ShardedHnsw

        rng = np.random.default_rng(9)
        centers = rng.normal(size=(16, 12)).astype(np.float32)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        n = 480
        vectors = centers[rng.integers(0, 16, n)] + 0.03 * rng.normal(
            size=(n, 12)
        ).astype(np.float32)
        vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
        ids = [f"doc-{i:03d}" for i in range(n)]

        mesh = make_mesh(data=data)
        sharded = ShardedHnsw("cosine", mesh, ids, vectors,
                              options={"m": 8, "m0": 16, "ef_construction": 60,
                                       "ef_search": 120})
        exact = FlatIndex("cosine")
        exact.put_many(zip(ids, vectors))

        queries = vectors[rng.integers(0, n, 6)]
        got = sharded.search_batch(queries, 10)
        overlaps = []
        for q, hits in zip(queries, got):
            truth = exact.search(list(q), 10)
            assert hits[0][0] == truth[0][0]  # exact self-hit across shards
            overlaps.append(
                len({h[0] for h in hits} & {t[0] for t in truth}) / 10
            )
        assert np.mean(overlaps) >= 0.9

    def test_sharded_hnsw_tie_break(self):
        from vettore_tpu.parallel import ShardedHnsw

        ids = [f"t-{i:02d}" for i in range(64)]
        vectors = np.ones((64, 4), dtype=np.float32)
        mesh = make_mesh()
        sharded = ShardedHnsw("l2", mesh, ids, vectors,
                              options={"m": 4, "m0": 8, "ef_construction": 16,
                                       "ef_search": 64})
        hits = sharded.search_batch(np.ones((1, 4), dtype=np.float32), 10)[0]
        assert [h[0] for h in hits] == ids[:10]
