"""Columnar store: the Store behaviour surface must match MemoryStore
(same contract as test_store.py's CRUD suite) plus columnar-specific
properties — lock-free read snapshots across compaction, bf16 halves mode,
odd-record overflow, and the host-RAM shape that motivates it
(/root/reference/lib/vettore/store/ets.ex:273-282)."""

import threading

import numpy as np
import pytest

import vettore_tpu as vt
from vettore_tpu import errors
from vettore_tpu.embedding import Embedding
from vettore_tpu.store.columnar import ColumnarStore
from vettore_tpu.store.memory import MemoryStore


def record(id, vec=None, **kw):
    if vec is None:
        vec = [1.0, 0.0]
    return Embedding(id=id, value=kw.get("value", id), vector=vec, **{
        k: v for k, v in kw.items() if k != "value"
    })


def make(dtype="f32", config=None):
    return ColumnarStore(config or {}, dtype=dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
class TestBehaviourParity:
    def test_crud_surface(self, dtype):
        store = make(dtype, {"metric": "l2"})
        store.put(record("a"))
        store.put_many([record("b"), record("c")])
        assert store.get("a").id == "a"
        assert store.count() == 3
        assert sorted(e.id for e in store.all()) == ["a", "b", "c"]
        assert store.fold(lambda e, acc: acc + 1, 0) == 3
        store.delete("b")
        assert store.count() == 2
        with pytest.raises(errors.NotFound):
            store.get("b")
        store.delete("missing")  # idempotent

    def test_batch_insert_is_atomic_on_duplicates(self, dtype):
        store = make(dtype)
        store.put(record("a"))
        with pytest.raises(errors.DuplicateId):
            store.put_many([record("b"), record("a")])
        with pytest.raises(errors.DuplicateId):
            store.put_many([record("x"), record("x")])
        assert store.count() == 1

    def test_closed(self, dtype):
        store = make(dtype)
        store.put(record("a"))
        store.close()
        store.close()
        assert not store.alive()
        for op in [
            lambda: store.get("a"),
            lambda: store.put(record("b")),
            lambda: store.all(),
            lambda: store.delete("a"),
            lambda: store.count(),
            lambda: store.snapshot("/tmp/never.snap"),
        ]:
            with pytest.raises(errors.Closed):
                op()

    def test_record_roundtrip_fields(self, dtype):
        store = make(dtype)
        store.put(record("r", vec=[0.5, -0.25], value="payload",
                         metadata={"k": 1}))
        e = store.get("r")
        assert e.value == "payload" and e.metadata == {"k": 1}
        got = np.asarray(e.vector, dtype=np.float32)
        # 0.5/-0.25 are bf16-exact, so both dtypes round-trip exactly
        assert got.tolist() == [0.5, -0.25]

    def test_replace_points_id_at_new_row(self, dtype):
        store = make(dtype)
        store.put(record("a", vec=[1.0, 0.0]))
        old = store.get("a")
        store.replace(record("a", vec=[0.0, 1.0], metadata={"v": 2}))
        assert np.asarray(store.get("a").vector).tolist() == [0.0, 1.0]
        assert store.get("a").metadata == {"v": 2}
        # the previously hydrated record still sees its original row
        assert np.asarray(old.vector).tolist() == [1.0, 0.0]
        assert store.count() == 1

    def test_snapshot_roundtrip(self, dtype, tmp_path):
        store = make(dtype, {"metric": "cosine", "compressed": dtype == "bf16"})
        store.put_many([
            record("a", vec=[0.5, 0.5], metadata={"i": 0}),
            record("b", vec=[-0.25, 1.0], value="bee"),
        ])
        path = str(tmp_path / "col.snap")
        store.snapshot(path)
        loaded, config = ColumnarStore.load_snapshot(path)
        assert loaded._dtype == dtype  # compressed config selects bf16
        assert config["metric"] == "cosine"
        assert sorted(e.id for e in loaded.all()) == ["a", "b"]
        assert loaded.get("b").value == "bee"
        assert np.asarray(loaded.get("a").vector).tolist() == [0.5, 0.5]


class TestColumnarSpecifics:
    def test_bf16_mode_rounds_to_nearest(self):
        store = make("bf16")
        val = 1.0 + 2**-9  # not bf16-representable; nearest-even -> 1.0
        store.put(record("x", vec=[val, 3.0000001]))
        got = np.asarray(store.get("x").vector, dtype=np.float32)
        import ml_dtypes

        want = np.array([val, 3.0000001], np.float32).astype(
            ml_dtypes.bfloat16).astype(np.float32)
        assert got.tolist() == want.tolist()

    def test_f32_mode_is_lossless_views(self):
        store = make("f32")
        rng = np.random.default_rng(0)
        vecs = rng.normal(size=(32, 8)).astype(np.float32)
        store.put_many([record(f"r{i}", vec=vecs[i]) for i in range(32)])
        for i in range(32):
            assert np.array_equal(
                np.asarray(store.get(f"r{i}").vector), vecs[i])

    def test_binary_vector_column(self):
        store = make("f32")
        words = list(range(2))  # d=128 -> 2 u64 words
        store.put(Embedding(id="p", value="p", vector=[0.25] * 128,
                            binary_vector=words))
        got = store.get("p").binary_vector
        assert np.asarray(got, dtype=np.uint64).tolist() == words
        # a record without a packed vector hydrates None
        store.put(Embedding(id="q", value="q", vector=[0.5] * 128))
        assert store.get("q").binary_vector is None

    def test_odd_records_survive_whole(self):
        store = make("f32")
        store.put(record("base", vec=[1.0, 2.0]))
        odd = Embedding(id="odd", value="odd", vector=[1.0, 2.0, 3.0])  # d=3
        store.put(odd)
        assert np.asarray(store.get("odd").vector).tolist() == [1.0, 2.0, 3.0]
        mv = Embedding(id="mv", value="mv", vector=[1.0, 0.0],
                       vectors=[[1.0, 0.0], [0.0, 1.0]])
        store.put(mv)
        assert store.get("mv").vectors == [[1.0, 0.0], [0.0, 1.0]]

    def test_compaction_preserves_readers_and_records(self):
        store = make("f32")
        n = 10_000
        vecs = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        store.put_many([record(f"{i:05d}", vec=vecs[i]) for i in range(n)])
        held = store.get("00007")
        # delete 60% -> dead outnumbers live, triggering compaction
        for i in range(n):
            if i % 5 != 2 and i % 5 != 4:
                store.delete(f"{i:05d}")
        st = store._state
        # compaction ran: tombstones stay bounded by max(chunk, live)
        assert st.dead <= max(4096, len(st.slot_of))
        assert store.count() == n * 2 // 5
        assert np.asarray(store.get("00002").vector).tolist() == [4.0, 5.0]
        assert np.asarray(held.vector).tolist() == [14.0, 15.0]
        # block shrank back toward the live set
        assert store._state.block.shape[0] <= n

    def test_concurrent_readers_during_writes(self):
        store = make("f32")
        store.put_many([record(f"{i:03d}") for i in range(64)])
        stop = threading.Event()
        failures = []

        def reader():
            while not stop.is_set():
                try:
                    rows = store.all()
                    assert len(rows) >= 64
                    store.get("000")
                except Exception as exc:  # pragma: no cover
                    failures.append(exc)
                    return

        threads = [threading.Thread(target=reader) for _ in range(8)]
        for t in threads:
            t.start()
        for i in range(64, 256):
            store.put(record(f"{i:03d}"))
        stop.set()
        for t in threads:
            t.join()
        assert not failures
        assert store.count() == 256

    def test_columnar_ram_is_block_plus_epsilon(self):
        """The per-record bookkeeping must be O(maps), not O(objects):
        every value==id, metadata=None record costs zero dict entries."""
        store = make("f32")
        n, d = 4096, 32
        rng = np.random.default_rng(1)
        vecs = rng.normal(size=(n, d)).astype(np.float32)
        store.put_many([record(f"{i:05d}", vec=vecs[i]) for i in range(n)])
        st = store._state
        assert not st.values and not st.meta and not st.mv and not st.odd
        assert st.block.nbytes <= (n + 4096) * d * 4


class TestCollectionIntegration:
    def test_store_columnar_option(self):
        col = vt.Collection(name="c", dimensions=4, metric="cosine",
                            store="columnar")
        assert isinstance(col._store, ColumnarStore)
        assert col._store._dtype == "f32"
        col.put({"id": "a", "vector": [1.0, 0.0, 0.0, 0.0]})
        col.put({"id": "b", "vector": [0.0, 1.0, 0.0, 0.0]})
        res = col.search([1.0, 0.0, 0.0, 0.0], limit=1)
        assert res[0].id == "a"
        col.delete("a")
        res = col.search([1.0, 0.0, 0.0, 0.0], limit=1)
        assert res[0].id == "b"

    def test_compressed_collection_defaults_to_columnar_bf16(self):
        col = vt.Collection(name="cz", dimensions=4, metric="cosine",
                            compressed=True)
        assert isinstance(col._store, ColumnarStore)
        assert col._store._dtype == "bf16"
        col.put({"id": "a", "vector": [1.0, 0.0, 0.0, 0.0]})
        assert col.search([1.0, 0.0, 0.0, 0.0], limit=1)[0].id == "a"

    def test_memory_store_remains_default(self):
        col = vt.Collection(name="m", dimensions=4, metric="cosine")
        assert isinstance(col._store, MemoryStore)

    def test_columnar_snapshot_roundtrip_via_collection(self, tmp_path):
        col = vt.Collection(name="snap", dimensions=4, metric="cosine",
                            store="columnar")
        col.put_many([
            {"id": f"doc-{i}", "vector": [float(i == j) for j in range(4)]}
            for i in range(4)
        ])
        path = str(tmp_path / "col.snap")
        col.snapshot(path)
        loaded = vt.load_snapshot(path, store="columnar")
        assert isinstance(loaded._store, ColumnarStore)
        assert loaded.search([0.0, 1.0, 0.0, 0.0], limit=1)[0].id == "doc-1"
        # and the default MemoryStore can read the same snapshot file
        loaded2 = vt.load_snapshot(path)
        assert loaded2.search([0.0, 0.0, 1.0, 0.0], limit=1)[0].id == "doc-2"
