"""Host-oracle fallbacks, vectorized prepare paths, storage views, batch
encoders, and the grouped-Hamming kernel/XLA variants — the branches the
device fast paths shadow in routine runs (each must agree with its fast
counterpart, since ok=False reroutes real queries through them)."""

import numpy as np
import pytest

import jax.numpy as jnp

from vettore_tpu import errors as E
from vettore_tpu.collection import Collection, _VectorCache
from vettore_tpu.embedding import Embedding
from vettore_tpu.index.flat import FlatIndex, InvalidFlatOptions
from vettore_tpu.ops import muvera, pipeline as pipe


def _corpus(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


@pytest.fixture
def col():
    d = 16
    data = _corpus(200, d)
    c = Collection(name="fb", dimensions=d, metric="cosine", index="flat")
    c.put_matrix([f"r-{i:03d}" for i in range(200)], data)
    return c, data


class TestHostOracles:
    """The ok=False reroute targets must equal the device pipelines."""

    @staticmethod
    def _agree(dev, host):
        # the host oracle scores in f64 (the f32-overflow recovery posture,
        # distances.rs:59-98): ids must match exactly, scores to f32 noise
        assert [r.id for r in dev] == [r.id for r in host]
        np.testing.assert_allclose(
            [r.score for r in dev], [r.score for r in host], atol=1e-5)

    def test_funnel_host_matches_device(self, col):
        c, data = col
        cache = c._scan_cache()
        q = c.prepare_query(list(data[7]))
        dev = c.funnel_search(list(data[7]), stages=[8, 16], candidates=30, limit=5)
        self._agree(dev, c._funnel_host(cache, q, [8, 16], 30, 5))

    def test_quantized_host_matches_device(self, col):
        c, data = col
        cache = c._scan_cache()
        q = c.prepare_query(list(data[3]))
        dev = c.quantized_search(list(data[3]), candidates=40, limit=5)
        self._agree(dev, c._quantized_host(cache, q, 40, 5))

    def test_multi_vector_host_matches_device(self, col):
        c, data = col
        cache = c._scan_cache()
        qs = np.stack([data[5], data[6]])
        dev = c.multi_vector_search([list(v) for v in qs], limit=5)
        host = c._multi_vector_host(
            cache, None, c._prepare_query_vectors([list(v) for v in qs]),
            "cosine", 5)
        self._agree(dev, host)


class TestGroupedHammingVariants:
    """Pallas sign-scan vs XLA i16 fallback vs numpy oracle."""

    @pytest.mark.parametrize("d", [128, 64])  # 128 -> Pallas path, 64 -> XLA
    def test_grouped_variants_exact(self, monkeypatch, d):
        monkeypatch.setattr(pipe, "_GROUP_COVER_MIN", 2048)
        rng = np.random.default_rng(5)
        n, b, count = 8192, 3, 64
        base = rng.integers(0, 2, (9, d)) * 2 - 1  # heavy ties
        signs_np = base[rng.integers(0, 9, n)]
        signs = jnp.asarray(signs_np, dtype=jnp.int8)
        valid = jnp.asarray(np.arange(n) < n - 5)
        qs = pipe.query_signs(
            jnp.asarray(rng.standard_normal((b, d)).astype(np.float32)))
        slots, ranks, ok = pipe._hamming_slots(signs, valid, qs, count=count, d=d)
        assert bool(np.asarray(ok).all())
        ham = (d - np.asarray(qs, np.int32) @ signs_np.astype(np.int32).T) // 2
        ham = np.where(np.asarray(valid)[None, :], ham, 10**9)
        for i in range(b):
            order = np.lexsort((np.arange(n), ham[i]))[:count]
            assert np.array_equal(np.asarray(slots)[i], order)
            assert np.array_equal(np.asarray(ranks)[i], ham[i][order])

    def test_fused_sign_scan_oracle(self):
        """The quantized stage-1 scan (int8 product, int32 accumulate,
        narrowed i16 hamming block + group minima) against numpy."""
        rng = np.random.default_rng(6)
        n, d, b = 1024, 128, 2
        signs_np = (rng.integers(0, 2, (n, d)) * 2 - 1).astype(np.int8)
        valid = np.ones(n, bool)
        valid[-3:] = False
        qs_np = (rng.integers(0, 2, (b, d)) * 2 - 1).astype(np.int8)
        gmin, ham16 = pipe._sign_group_scan(
            jnp.asarray(signs_np), jnp.asarray(valid), jnp.asarray(qs_np), d=d)
        ham = (d - qs_np.astype(np.int32) @ signs_np.astype(np.int32).T) // 2
        ham = np.where(valid[None, :], ham, pipe._BIG16)
        assert ham16.dtype == jnp.int16
        assert np.array_equal(np.asarray(ham16), ham.astype(np.int16))
        assert np.array_equal(
            np.asarray(gmin), ham.reshape(b, n // 64, 64).min(axis=2))


class TestFlatVariants:
    def test_storage_view_bf16_and_invalid(self, col):
        c, data = col
        view = c.index.storage_view("bf16")
        hits = view.search_batch(data[:4], 5)
        base = c.index.search_batch(data[:4], 5)
        for h, b in zip(hits, base):
            assert {id for id, _ in h[:3]} & {id for id, _ in b[:3]}
        with pytest.raises(InvalidFlatOptions):
            c.index.storage_view("f16")

    def test_put_many_into_existing_slots(self):
        d = 8
        idx = FlatIndex("l2")
        data = _corpus(20, d, seed=7)
        idx.put_matrix([f"a-{i}" for i in range(20)], data)
        # overlapping ids route through put_many (replace + extend)
        idx.put_many([(f"a-{i}", data[(i + 1) % 20]) for i in range(10)]
                     + [(f"b-{i}", data[i]) for i in range(5)])
        assert len(idx) == 25
        hits = idx.search(list(data[1]), 1)
        assert hits[0][0] in ("a-0", "b-1")


class TestVectorizedPrepare:
    """put_many >= 256 records takes the one-matrix validate path."""

    def test_dict_batch(self):
        d = 8
        data = _corpus(300, d, seed=8)
        c = Collection(name="vb", dimensions=d, metric="l2", index="flat")
        c.put_many([{"id": f"x-{i:03d}", "vector": list(v)}
                    for i, v in enumerate(data)])
        assert c.count() == 300
        assert c.get("x-000").binary_vector is not None

    def test_embedding_batch_and_errors(self):
        d = 8
        data = _corpus(300, d, seed=9)
        c = Collection(name="vb2", dimensions=d, metric="l2", index="flat")
        c.put_many([Embedding(id=f"e-{i:03d}", vector=list(v))
                    for i, v in enumerate(data)])
        assert c.count() == 300
        bad = [{"id": f"y-{i}", "vector": [1.0] * d} for i in range(299)]
        bad.append({"id": "y-last", "vector": [1.0] * (d + 1)})  # ragged
        with pytest.raises((E.DimensionMismatch, E.InvalidVector)):
            c.put_many(bad)
        nn = [{"id": f"z-{i}", "vector": [1.0] * d} for i in range(299)]
        nn.append({"id": "z-last", "vector": ["nope"] * d})
        with pytest.raises(E.InvalidVector):
            c.put_many(nn)

    def test_missing_id_in_batch(self):
        d = 8
        c = Collection(name="vb3", dimensions=d, metric="l2", index="flat")
        items = [{"id": f"k-{i}", "vector": [1.0] * d} for i in range(299)]
        items.append({"vector": [1.0] * d})
        with pytest.raises(E.MissingId):
            c.put_many(items)


class TestVectorCacheDirect:
    def test_invalid_and_duplicate_records(self):
        with pytest.raises(E.InvalidEmbedding):
            _VectorCache([object()], 4)
        recs = [Embedding(id="a", vector=np.ones(4, np.float32)),
                Embedding(id="a", vector=np.ones(4, np.float32))]
        with pytest.raises(E.DuplicateId):
            _VectorCache(recs, 4)

    def test_bits_packed_from_vectors_when_missing(self):
        recs = [Embedding(id=f"n-{i}", vector=np.asarray([1.0, -1.0, 0.5, -0.5],
                                                         np.float32))
                for i in range(4)]
        cache = _VectorCache(recs, 4)
        bits = np.asarray(cache.bits())
        assert bits[0, 0] == 0b0101  # signs >= 0 at dims 0, 2

    def test_invalid_binary_vector_rejected(self):
        recs = [Embedding(id="b", vector=np.ones(4, np.float32),
                          binary_vector=[-1])]
        with pytest.raises(E.InvalidBinaryVector):
            _VectorCache(recs, 4).bits()
        recs = [Embedding(id="b", vector=np.ones(4, np.float32),
                          binary_vector=[1, 2])]  # wrong word count
        with pytest.raises(E.InvalidBinaryVector):
            _VectorCache(recs, 4).bits()

    def test_sync_barrier(self, col):
        c, _ = col
        c.search([1.0] * 16 + [], limit=1) if False else None
        c.sync()  # flushes device state without error on a live collection


class TestMuveraBatchEncoders:
    def test_batch_matches_per_set(self):
        rng = np.random.default_rng(11)
        cfg = {"dimension": 8, "num_repetitions": 2,
               "num_simhash_projections": 3, "seed": 42}
        sets = [[list(r) for r in rng.standard_normal((t, 8))]
                for t in (1, 3, 5)]
        bq = muvera.encode_queries(sets, cfg)
        bd = muvera.encode_documents(sets, cfg)
        for i, s in enumerate(sets):
            assert np.allclose(bq[i], np.asarray(muvera.encode_query(s, cfg)))
            assert np.allclose(bd[i], np.asarray(muvera.encode_document(s, cfg)))

    def test_batch_validation(self):
        with pytest.raises(E.VettoreError):
            muvera.encode_queries("nope", {"dimension": 4})
        assert muvera.encode_queries([], {"dimension": 4}).shape == (0, 0)
        with pytest.raises(E.VettoreError):
            muvera.encode_queries(
                [[[1.0, 2.0]], [[1.0, 2.0, 3.0]]], {})  # ragged dims


class TestExoticMetricMaxSim:
    """The manhattan/chebyshev/hamming/jaccard MaxSim similarity branches
    (multi_vector.rs:40-87 supports all nine metrics)."""

    @pytest.mark.parametrize(
        "metric", ["manhattan", "chebyshev", "hamming", "jaccard"])
    def test_mv_search_exotic_metrics(self, metric):
        d = 8
        data = _corpus(32, d, seed=20)
        c = Collection(name=f"mx-{metric}", dimensions=d, metric=metric,
                       index="flat")
        c.put_many([
            {"id": f"m-{i:02d}", "vectors": [list(v), list(-v)]}
            for i, v in enumerate(data)
        ])
        hits = c.multi_vector_search([list(data[3])], limit=3)
        assert len(hits) == 3 and all(np.isfinite(r.score) for r in hits)
        batch = c.multi_vector_search_batch([[list(data[3])]], limit=3)
        assert [r.id for r in batch[0]] == [r.id for r in hits]


class TestRaggedTokenCounts:
    def test_mixed_token_counts_search(self):
        d = 8
        data = _corpus(24, d, seed=21)
        c = Collection(name="rt", dimensions=d, metric="cosine", index="flat")
        items = []
        for i, v in enumerate(data):
            t = 1 + (i % 3)
            items.append({"id": f"r-{i:02d}",
                          "vectors": [list(v)] * t})
        c.put_many(items)
        hits = c.multi_vector_search([list(data[5])], limit=4)
        assert hits[0].id == "r-05"

    def test_single_vector_fallback_rows(self):
        # records without `vectors` ride the primary-vector token path
        d = 8
        data = _corpus(16, d, seed=22)
        c = Collection(name="sv", dimensions=d, metric="cosine", index="flat")
        c.put_matrix([f"s-{i:02d}" for i in range(16)], data)
        hits = c.multi_vector_search([list(data[2])], limit=2)
        assert hits[0].id == "s-02"


class TestAttachIndexKind:
    def test_attach_updates_index_kind(self):
        from vettore_tpu.index.hnsw import HnswIndex

        d = 8
        data = _corpus(64, d, seed=30)
        ids = [f"k-{i:02d}" for i in range(64)]
        c = Collection(name="ak", dimensions=d, metric="cosine", index="flat")
        c.put_matrix(ids, data)
        assert c.index_kind == "flat"
        idx = HnswIndex("cosine", {"ef_search": 16})
        idx.put_many([(i, c.get(i).vector) for i in ids])
        c.attach_index(idx)
        assert c.index_kind == "hnsw"
        # the hnsw hybrid generator is now legal on this collection
        hits = c.hybrid_search(list(data[4]), limit=3,
                               generators=[("hnsw", {"candidates": 16})])
        assert hits[0].id == "k-04"


class TestInt8Storage:
    """storage_view("int8"): per-row symmetric quantization, int8 fused
    scan, exact dequantized rescore of the winners."""

    @pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
    def test_int8_view_recall(self, metric):
        n, d = 2048, 64
        rng = np.random.default_rng(33)
        data = _corpus(n, d, seed=33)
        idx = FlatIndex(metric)
        idx.put_matrix([f"q-{i:04d}" for i in range(n)], data)
        view = idx.storage_view("int8")
        qs = data[rng.integers(0, n, 6)] + 0.02 * rng.standard_normal(
            (6, d)).astype(np.float32)
        base = idx.search_batch(qs, 10)
        hits = view.search_batch(qs, 10)
        for h, b in zip(hits, base):
            got = {id for id, _ in h}
            want = {id for id, _ in b}
            assert len(got & want) >= 8, (metric, got, want)
        # exact self-hit survives quantization
        self_hits = view.search_batch(data[:4], 1)
        assert [h[0][0] for h in self_hits] == [f"q-{i:04d}" for i in range(4)]

    def test_int8_raws_close_to_exact(self):
        n, d = 1024, 32
        data = _corpus(n, d, seed=34)
        idx = FlatIndex("cosine")
        idx.put_matrix([f"r-{i:04d}" for i in range(n)], data)
        view = idx.storage_view("int8")
        base = idx.search(list(data[5]), 5)
        hits = view.search(list(data[5]), 5)
        for (bi, br), (hi, hr) in zip(base, hits):
            if bi == hi:
                assert abs(br - hr) < 0.05

    def test_int8_serves_non_fused_configs(self):
        """Non-fused configs (exotic metric, tiny cap) dequantize through
        the XLA scan instead of refusing — every metric/limit stays
        servable on int8 storage (flat.rs:96-124)."""
        n, d = 64, 8
        data = _corpus(n, d, seed=35)
        idx = FlatIndex("manhattan", storage="int8")  # exotic metric
        idx.put_matrix([f"m-{i:03d}" for i in range(n)], data)
        base = FlatIndex("manhattan")
        base.put_matrix([f"m-{i:03d}" for i in range(n)], data)
        hits = idx.search(list(data[5]), 5)
        want = base.search(list(data[5]), 5)
        assert hits[0][0] == "m-005"
        got_ids = {id for id, _ in hits}
        want_ids = {id for id, _ in want}
        assert len(got_ids & want_ids) >= 3  # int8 noise can reorder the tail
        for (_, hr), (_, br) in zip(hits, want):
            assert abs(hr - br) < 0.3  # dequantized raws track exact values

    def test_widening_view_of_int8_parent_rebuilds(self):
        n, d = 1024, 16
        data = _corpus(n, d, seed=36)
        idx = FlatIndex("l2", storage="int8")
        idx.put_matrix([f"w-{i:04d}" for i in range(n)], data)
        f32 = idx.storage_view("f32")
        hits = f32.search(list(data[3]), 1)
        assert hits[0][0] == "w-0003"
        assert abs(hits[0][1]) < 1e-5  # exact f32 raw, not dequantized
