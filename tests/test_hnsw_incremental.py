"""Incremental mutation of bulk-built HNSW graphs (hnsw_build.incremental_*).

The reference mutates its graph per-record in O(ef·m) (hnsw.rs:152-289); the
device build appends new slots through the wave kernel and soft-deletes via a
device validity mask — these tests pin the semantics: replace-on-put,
tombstoned ids never surface, (rank, id) tie order, entry re-election,
capacity growth, compaction, and snapshot round-trips with tombstones.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from vettore_tpu.index import hnsw_build
from vettore_tpu.index.hnsw import HnswIndex, level_for

OPTS = {"m": 4, "m0": 8, "ef_construction": 32, "ef_search": 48}


def _unit(rows):
    rows = np.asarray(rows, np.float32)
    return rows / np.linalg.norm(rows, axis=-1, keepdims=True)


def _bulk_index(n=300, d=16, seed=3, metric="cosine", opts=OPTS):
    rng = np.random.default_rng(seed)
    data = _unit(rng.normal(size=(n, d)))
    idx = HnswIndex(metric, opts)
    idx.BULK_THRESHOLD = 2
    idx.put_many((f"id-{i:05d}", v) for i, v in enumerate(data))
    assert idx._bulk is not None
    return idx, data


def _hit_ids(idx, q, k):
    return [h[0] for h in idx.search(np.asarray(q, np.float64), k)]


class TestIncrementalInsert:
    def test_put_stays_bulk_and_is_searchable(self):
        idx, data = _bulk_index()
        v = _unit(data[0] + 0.7 * np.eye(16, dtype=np.float32)[3])
        idx.put("zz-new", v)
        assert idx._bulk is not None  # no hydration cliff
        assert len(idx) == 301
        assert _hit_ids(idx, v, 1) == ["zz-new"]

    def test_put_many_batch_self_recall(self):
        idx, data = _bulk_index(n=400)
        rng = np.random.default_rng(9)
        extra = _unit(rng.normal(size=(80, 16)))
        idx.put_many((f"new-{i:04d}", v) for i, v in enumerate(extra))
        assert len(idx) == 480
        found = sum(
            _hit_ids(idx, extra[i], 1) == [f"new-{i:04d}"] for i in range(80)
        )
        assert found >= 76  # ≥95% self-recall on fresh inserts

    def test_replace_moves_vector(self):
        idx, data = _bulk_index()
        target = _unit(-data[7])
        idx.put("id-00007", target)
        assert len(idx) == 300  # replace, not insert
        assert _hit_ids(idx, target, 1) == ["id-00007"]
        # the id must rank by its NEW vector at the old location
        old_hits = idx.search(np.asarray(data[7], np.float64), 5)
        for id, raw in old_hits:
            if id == "id-00007":
                raise AssertionError("replaced id still scores at old vector")

    def test_duplicate_ids_in_batch_keep_last(self):
        idx, data = _bulk_index(n=150)
        a = _unit(np.eye(16, dtype=np.float32)[0])
        b = _unit(np.eye(16, dtype=np.float32)[1])
        idx.put_many([("dup", a), ("dup", b)])
        assert len(idx) == 151
        assert _hit_ids(idx, b, 1) == ["dup"]

    def test_tie_break_by_id_across_incremental_inserts(self):
        idx, data = _bulk_index(n=120)
        # two new ids share id-00011's exact vector; equal ranks must order
        # lexicographically (flat.rs:34-40 semantics)
        idx.put_many([("aa-dup", data[11]), ("zz-dup", data[11])])
        hits = _hit_ids(idx, data[11], 3)
        assert hits == ["aa-dup", "id-00011", "zz-dup"]

    def test_high_level_insert_grows_layers(self):
        idx, data = _bulk_index(n=80)
        lmax = idx._bulk.lmax
        new_id = next(
            f"lv-{i}" for i in range(100000)
            if level_for(f"lv-{i}", 12) > lmax
        )
        idx.put(new_id, _unit(np.ones(16, np.float32)))
        assert idx._bulk.lmax > lmax
        assert int(idx._bulk.entry_slot) == idx._bulk.n - 1  # new entry
        assert _hit_ids(idx, np.ones(16) / 4.0, 1) == [new_id]

    def test_capacity_growth(self, monkeypatch):
        monkeypatch.setattr(hnsw_build, "CAP_SLACK_MIN", 8)
        idx, data = _bulk_index(n=64)
        cap0 = idx._bulk.x.shape[0]
        rng = np.random.default_rng(4)
        extra = _unit(rng.normal(size=(3 * cap0, 16)))
        idx.put_many((f"grow-{i:05d}", v) for i, v in enumerate(extra))
        assert idx._bulk.x.shape[0] > cap0
        assert len(idx) == 64 + 3 * cap0
        hit = sum(_hit_ids(idx, extra[i], 1) == [f"grow-{i:05d}"]
                  for i in range(0, 3 * cap0, 16))
        assert hit >= (3 * cap0 // 16) * 9 // 10


class TestIncrementalDelete:
    def test_deleted_ids_never_surface(self):
        idx, data = _bulk_index()
        for i in range(10):
            idx.delete(f"id-{i:05d}")
        assert len(idx) == 290
        for i in range(10):
            assert f"id-{i:05d}" not in _hit_ids(idx, data[i], 10)
        # nearest live neighbor takes over
        assert _hit_ids(idx, data[0], 1)[0].startswith("id-")

    def test_delete_missing_is_noop(self):
        idx, _ = _bulk_index(n=100)
        v = idx._version
        idx.delete("nope")
        assert len(idx) == 100 and idx._version == v

    def test_entry_reelection(self):
        idx, data = _bulk_index()
        g = idx._bulk
        entry_id = g.ids[int(g.entry_slot)]
        idx.delete(entry_id)
        assert g.ids[int(g.entry_slot)] != entry_id
        assert len(_hit_ids(idx, data[50], 5)) == 5

    def test_delete_all_resets_to_empty(self):
        idx, data = _bulk_index(n=40)
        for i in range(40):
            idx.delete(f"id-{i:05d}")
        assert len(idx) == 0
        assert idx._bulk is None and idx.dimension is None
        idx.put("fresh", [1.0, 0.0])  # host path accepts a new dimension
        assert _hit_ids(idx, [1.0, 0.0], 1) == ["fresh"]

    def test_compaction_rebuilds_live_set(self):
        idx, data = _bulk_index(n=280)
        for i in range(80):  # > max(64, 0.25 * 280)
            idx.delete(f"id-{i:05d}")
        g = idx._bulk
        assert g.n < 280  # a compaction dropped tombstoned slots
        dead = g._mut.dead if g._mut is not None else 0
        assert dead <= max(64, 0.25 * g.n)
        assert len(idx) == 200
        ok = sum(_hit_ids(idx, data[i], 1) == [f"id-{i:05d}"]
                 for i in range(80, 280, 10))
        assert ok >= 18

    def test_reinsert_after_delete(self):
        idx, data = _bulk_index(n=100)
        idx.delete("id-00042")
        assert "id-00042" not in _hit_ids(idx, data[42], 5)
        idx.put("id-00042", data[42])
        assert _hit_ids(idx, data[42], 1) == ["id-00042"]
        assert len(idx) == 100


class TestTombstoneSnapshot:
    def test_save_load_preserves_tombstones(self, tmp_path):
        idx, data = _bulk_index(n=90)
        idx.delete("id-00003")
        idx.put("zz-late", _unit(np.ones(16, np.float32)))
        path = str(tmp_path / "g.npz")
        idx.save_graph(path)
        loaded = HnswIndex.load_graph("cosine", OPTS, path)
        assert len(loaded) == 90
        assert "id-00003" not in _hit_ids(loaded, data[3], 10)
        assert _hit_ids(loaded, np.ones(16) / 4.0, 1) == ["zz-late"]
        # loaded graphs stay mutable
        loaded.delete("zz-late")
        assert len(loaded) == 89


class TestLexRespace:
    def test_gap_exhaustion_respaces(self):
        idx, data = _bulk_index(n=30)
        st = hnsw_build._ensure_mutable(idx._bulk)
        rng = np.random.default_rng(11)
        # >1024 ids between "id-00000" and "id-00001" exhaust the lex gap
        extra = _unit(rng.normal(size=(1200, 16)))
        idx.put_many((f"id-00000a{i:05d}", v) for i, v in enumerate(extra))
        assert len(idx) == 1230
        assert np.all(np.diff(st.sorted_ranks) > 0)  # strictly increasing
        # ranks on live slots agree with the sorted structure
        pos = np.searchsorted(st.sorted_ids, "id-00000a00500")
        assert st.sorted_ids[pos] == "id-00000a00500"
