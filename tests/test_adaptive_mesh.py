"""Mesh-sharded adaptive pipelines (funnel/quantized/MaxSim/hybrid) on the
virtual 8-device CPU mesh: every mode must EQUAL its single-chip counterpart
per query (SURVEY §5.8 — the scan cache's vector /
sign / token blocks are row-sharded, candidates cross the interconnect between stages)."""

import jax
import numpy as np
import pytest

import vettore_tpu as vt
from vettore_tpu.parallel import make_mesh

pytestmark = [
    pytest.mark.slow,  # multi-minute: 8-device shard_map compiles
    pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices"),
]

DIMS = 24
N_DOCS = 110


def corpus(multi=False, seed=5):
    rng = np.random.default_rng(seed)
    records = []
    vectors = rng.normal(size=(N_DOCS, DIMS)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    for i in range(N_DOCS):
        rec = {"id": f"doc-{i:03d}", "vector": [float(v) for v in vectors[i]]}
        if multi:
            t = 1 + (i % 4)
            toks = vectors[i][None, :] + 0.1 * rng.normal(size=(t, DIMS))
            rec["vectors"] = [[float(x) for x in row] for row in toks]
            del rec["vector"]
        records.append(rec)
    return records, vectors


def make_pair(metric="cosine", index="flat", data=2, multi=False, **opts):
    mesh = make_mesh(data=data)
    records, vectors = corpus(multi=multi)
    sharded = vt.Collection(name="am-m", dimensions=DIMS, metric=metric,
                            index=index, mesh=mesh, **opts)
    single = vt.Collection(name="am-s", dimensions=DIMS, metric=metric,
                           index=index, **opts)
    sharded.put_many(records)
    single.put_many(records)
    return sharded, single, records, vectors


def queries(vectors, count, seed=9):
    rng = np.random.default_rng(seed)
    qs = vectors[rng.integers(0, len(vectors), count)] + 0.05 * rng.normal(
        size=(count, DIMS)).astype(np.float32)
    return [list(map(float, q)) for q in qs]


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert [r.id for r in g_row] == [r.id for r in w_row]
        for g, w in zip(g_row, w_row):
            assert g.score == pytest.approx(w.score, rel=1e-4, abs=1e-5)


class TestShardedCacheBlocks:
    def test_blocks_are_row_sharded(self):
        sharded, _, _, vectors = make_pair()
        sharded.funnel_search_batch(queries(vectors, 2), limit=3)
        cache = sharded._scan_cache()
        x, valid = cache.vectors()
        assert cache.cap % sharded.mesh.shape["shard"] == 0
        spec = x.sharding.spec
        assert spec[0] == "shard"
        assert cache.signs().shape[0] == cache.cap

    def test_token_block_sharded(self):
        sharded, _, _, _ = make_pair(multi=True)
        cache = sharded._scan_cache()
        tokens, counts = cache.multi_vectors()
        assert tokens.sharding.spec[0] == "shard"
        assert counts.shape[0] == cache.cap


class TestFunnelMesh:
    @pytest.mark.parametrize("metric", ["cosine", "l2"])
    def test_batch_parity(self, metric):
        sharded, single, _, vectors = make_pair(metric=metric)
        qs = queries(vectors, 6)
        got = sharded.funnel_search_batch(qs, limit=7, candidates=40,
                                          stages=[8, 16, DIMS])
        want = single.funnel_search_batch(qs, limit=7, candidates=40,
                                          stages=[8, 16, DIMS])
        assert_rows_equal(got, want)

    def test_odd_batch_size(self):
        # B=5 not divisible by data=2: pad queries must not leak into results
        sharded, single, _, vectors = make_pair()
        qs = queries(vectors, 5)
        got = sharded.funnel_search_batch(qs, limit=4, candidates=20)
        want = single.funnel_search_batch(qs, limit=4, candidates=20)
        assert_rows_equal(got, want)

    def test_single_query_delegates(self):
        sharded, single, _, vectors = make_pair()
        got = sharded.funnel_search(list(vectors[7]), limit=5, candidates=30)
        want = single.funnel_search(list(vectors[7]), limit=5, candidates=30)
        assert [r.id for r in got] == [r.id for r in want]

    def test_candidates_above_shard_rows(self):
        # candidates > n_loc: per-shard top-C must degrade to "all local rows"
        sharded, single, _, vectors = make_pair()
        qs = queries(vectors, 2)
        got = sharded.funnel_search_batch(qs, limit=10, candidates=N_DOCS)
        want = single.funnel_search_batch(qs, limit=10, candidates=N_DOCS)
        assert_rows_equal(got, want)


class TestQuantizedMesh:
    def test_batch_parity(self):
        sharded, single, _, vectors = make_pair()
        qs = queries(vectors, 6)
        got = sharded.quantized_search_batch(qs, limit=7, candidates=50)
        want = single.quantized_search_batch(qs, limit=7, candidates=50)
        assert_rows_equal(got, want)

    def test_single_query_delegates(self):
        sharded, single, _, vectors = make_pair()
        got = sharded.quantized_search(list(vectors[13]), limit=5)
        want = single.quantized_search(list(vectors[13]), limit=5)
        assert [r.id for r in got] == [r.id for r in want]

    def test_full_candidates_equal_exact(self):
        # adversarial invariant: full-candidate quantized == exact flat
        sharded, single, _, vectors = make_pair()
        qs = queries(vectors, 3)
        got = sharded.quantized_search_batch(qs, limit=5, candidates=N_DOCS)
        want = single.search_batch(qs, limit=5)
        for g_row, w_row in zip(got, want):
            assert [r.id for r in g_row] == [r.id for r in w_row]


class TestMaxSimMesh:
    @pytest.mark.parametrize("metric", ["cosine", "inner_product"])
    def test_batch_parity(self, metric):
        sharded, single, _, vectors = make_pair(multi=True)
        rng = np.random.default_rng(21)
        qsets = []
        for i in range(5):
            q = rng.normal(size=(1 + i % 3, DIMS))
            qsets.append([[float(x) for x in row] for row in q])
        got = sharded.multi_vector_search_batch(qsets, limit=6, metric=metric)
        want = single.multi_vector_search_batch(qsets, limit=6, metric=metric)
        assert_rows_equal(got, want)

    def test_single_query_delegates(self):
        sharded, single, _, vectors = make_pair(multi=True)
        qset = [list(map(float, vectors[3])), list(map(float, vectors[4]))]
        got = sharded.multi_vector_search(qset, limit=5)
        want = single.multi_vector_search(qset, limit=5)
        assert [r.id for r in got] == [r.id for r in want]


class TestHybridMesh:
    def test_exact_rerank_parity(self):
        sharded, single, _, vectors = make_pair()
        qs = queries(vectors, 4)
        gens = [("funnel", {"candidates": 30}), ("quantized", {"candidates": 30})]
        got = sharded.hybrid_search_batch(qs, limit=6, generators=gens)
        want = single.hybrid_search_batch(qs, limit=6, generators=gens)
        assert_rows_equal(got, want)

    def test_mv_rerank_parity(self):
        sharded, single, _, vectors = make_pair(multi=True)
        qs = queries(vectors, 4)
        rng = np.random.default_rng(33)
        qsets = [[[float(x) for x in rng.normal(size=DIMS)] for _ in range(2)]
                 for _ in qs]
        gens = [("funnel", {"candidates": 30}), ("quantized", {"candidates": 30})]
        got = sharded.hybrid_search_batch(qs, limit=6, generators=gens,
                                          rerank=("multi_vector", qsets))
        want = single.hybrid_search_batch(qs, limit=6, generators=gens,
                                          rerank=("multi_vector", qsets))
        assert_rows_equal(got, want)

    def test_hnsw_generator_on_mesh(self):
        # hnsw generator routes through the mesh index's host search path
        sharded, single, _, vectors = make_pair(index="hnsw")
        qs = queries(vectors, 3)
        gens = [("hnsw", {"candidates": 40}), ("quantized", {"candidates": 40})]
        got = sharded.hybrid_search_batch(qs, limit=5, generators=gens)
        want = single.hybrid_search_batch(qs, limit=5, generators=gens)
        assert_rows_equal(got, want)

    def test_single_query_delegates(self):
        sharded, single, _, vectors = make_pair()
        gens = [("funnel", {"candidates": 25}), ("quantized", {"candidates": 25})]
        got = sharded.hybrid_search(list(vectors[11]), limit=5, generators=gens)
        want = single.hybrid_search(list(vectors[11]), limit=5, generators=gens)
        assert [r.id for r in got] == [r.id for r in want]


class TestMeshMutationParity:
    def test_delete_then_adaptive(self):
        sharded, single, records, vectors = make_pair()
        sharded.delete("doc-007")
        single.delete("doc-007")
        qs = queries(vectors, 3)
        got = sharded.quantized_search_batch(qs, limit=5, candidates=40)
        want = single.quantized_search_batch(qs, limit=5, candidates=40)
        assert_rows_equal(got, want)
        for row in got:
            assert "doc-007" not in [r.id for r in row]
