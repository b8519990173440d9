"""Fault injection and hardening tests.

Mirrors /root/reference/test/vector_adversarial_test.exs and
vector_hardening_test.exs: fake store/index components that fail on demand,
store↔index atomicity (rollback on index failure, index restore on store
delete failure), concurrent writers vs readers, and numerical adversaries.
"""

import os
import threading

import numpy as np
import pytest

import vettore_tpu as vt
from vettore_tpu import errors
from vettore_tpu.embedding import Embedding
from vettore_tpu.index.flat import FlatIndex
from vettore_tpu.store.memory import MemoryStore

F32_MAX = 3.4028234663852886e38


class FailingPutIndex(FlatIndex):
    """Index whose put_many fails after the store already accepted the batch
    (RestoreFailingIndex pattern, vector_adversarial_test.exs:1-23)."""

    def __init__(self, metric, options=None):
        super().__init__(metric, None)
        self.fail_puts = False

    def put_many(self, pairs):
        if self.fail_puts:
            raise errors.VettoreError("injected index failure", reason="index_boom")
        super().put_many(pairs)


class DeleteFailingStore(MemoryStore):
    """Store whose delete fails (DeleteFailingStore pattern,
    vector_adversarial_test.exs:25-41)."""

    def __init__(self, config=None):
        super().__init__(config)
        self.fail_deletes = False

    def delete(self, id):
        if self.fail_deletes:
            raise errors.VettoreError("injected store failure", reason="store_boom")
        super().delete(id)


class RestoreFailingIndex(FlatIndex):
    """Index that refuses the restore-put after a failed store delete."""

    def __init__(self, metric, options=None):
        super().__init__(metric, None)
        self.fail_restore = False

    def put(self, id, vector):
        if self.fail_restore:
            raise errors.VettoreError("injected restore failure", reason="restore_boom")
        super().put(id, vector)


class TestAtomicity:
    def test_insert_rolls_back_store_on_index_failure(self):
        index = FailingPutIndex("cosine")
        col = vt.Collection(dimensions=2, metric="cosine", index=index)
        col.put({"id": "ok", "vector": [1.0, 0.0]})
        index.fail_puts = True
        with pytest.raises(errors.VettoreError) as info:
            col.put_many([{"id": "a", "vector": [0.0, 1.0]},
                          {"id": "b", "vector": [1.0, 1.0]}])
        assert info.value.reason == "index_boom"
        # both sides rolled back: store has only "ok", index has only "ok"
        assert sorted(e.id for e in col.all()) == ["ok"]
        assert len(index) == 1
        index.fail_puts = False
        results = col.search([1.0, 0.0], limit=10)
        assert [r.id for r in results] == ["ok"]

    def test_delete_restores_index_on_store_failure(self):
        store = DeleteFailingStore({})
        col = vt.Collection(dimensions=2, metric="cosine", store=store)
        col.put({"id": "a", "vector": [1.0, 0.0]})
        store.fail_deletes = True
        with pytest.raises(errors.VettoreError) as info:
            col.delete("a")
        assert info.value.reason == "store_boom"
        store.fail_deletes = False
        # record still searchable: the index entry was restored
        results = col.search([1.0, 0.0], limit=1)
        assert results[0].id == "a"
        assert col.get("a").id == "a"

    def test_index_restore_failure_surfaces_both_reasons(self):
        store = DeleteFailingStore({})
        index = RestoreFailingIndex("cosine")
        col = vt.Collection(dimensions=2, metric="cosine", store=store, index=index)
        col.put({"id": "a", "vector": [1.0, 0.0]})
        store.fail_deletes = True
        index.fail_restore = True
        with pytest.raises(errors.IndexRestoreFailed) as info:
            col.delete("a")
        assert info.value.store_reason.reason == "store_boom"
        assert info.value.index_reason.reason == "restore_boom"

    def test_duplicate_batch_leaves_nothing_behind(self):
        col = vt.Collection(dimensions=2)
        col.put({"id": "a", "vector": [1.0, 0.0]})
        with pytest.raises(errors.DuplicateId):
            col.put_many([{"id": "new", "vector": [0.0, 1.0]},
                          {"id": "a", "vector": [1.0, 1.0]}])
        assert sorted(e.id for e in col.all()) == ["a"]
        assert len(col.index) == 1


class TestConcurrency:
    def test_writers_and_readers_race(self):
        """8 writers x 16 readers against one collection
        (vector_adversarial_test.exs:344-374)."""
        col = vt.Collection(dimensions=4, metric="cosine")
        col.put_many([{"id": f"seed-{i}", "vector": list(np.eye(4)[i % 4] + 0.01 * i)}
                      for i in range(8)])
        stop = threading.Event()
        failures = []

        def writer(w):
            try:
                for i in range(20):
                    col.put({"id": f"w{w}-{i}", "vector": [1.0, float(w), float(i), 0.0]})
            except Exception as exc:  # pragma: no cover
                failures.append(exc)

        def reader():
            while not stop.is_set():
                try:
                    col.search([1.0, 0.0, 0.0, 0.0], limit=3)
                    col.all()
                except Exception as exc:  # pragma: no cover
                    failures.append(exc)
                    return

        readers = [threading.Thread(target=reader) for _ in range(16)]
        writers = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join()
        stop.set()
        for t in readers:
            t.join()
        assert not failures
        assert col.count() == 8 + 8 * 20
        results = col.search([1.0, 0.0, 0.0, 0.0], limit=5)
        assert len(results) == 5


class TestNumericalAdversaries:
    def test_f32_overflow_recovery_through_collection(self):
        col = vt.Collection(dimensions=2, metric="inner_product", normalize="none")
        col.put_many([{"id": "big", "vector": [F32_MAX, F32_MAX]},
                      {"id": "small", "vector": [1.0, 1.0]}])
        results = col.search([1.0, -1.0], limit=2)
        by_id = {r.id: r for r in results}
        assert by_id["big"].score == 0.0  # f64 recovery: F32_MAX - F32_MAX

    def test_rejects_non_finite_everywhere(self):
        col = vt.Collection(dimensions=2)
        for bad in ([float("nan"), 0.0], [float("inf"), 0.0], [F32_MAX * 2, 0.0]):
            with pytest.raises(errors.InvalidVector):
                col.put({"id": "x", "vector": bad})
            with pytest.raises(errors.InvalidVector):
                col.search(bad, limit=1)

    def test_stale_index_ids_dropped_in_hydration(self):
        """Results whose ids vanished from the store are silently dropped
        (index/flat.ex:88-90)."""
        col = vt.Collection(dimensions=2)
        col.put_many([{"id": "a", "vector": [1.0, 0.0]},
                      {"id": "b", "vector": [0.0, 1.0]}])
        # delete from the store directly, leaving the index stale
        col.store.delete("a")
        results = col.search([1.0, 0.0], limit=2)
        assert [r.id for r in results] == ["b"]


class TestScriptedSnapshotCorruption:
    """Scripted snapshot corruption (vector_adversarial_test.exs:43-108):
    loaders must reject structurally broken snapshots."""

    def test_bad_record_rejected(self, tmp_path):
        path = str(tmp_path / "bad.snap")
        store = MemoryStore({"snapshot_version": 1, "dimensions": 2, "metric": "cosine",
                             "normalize": "l2", "score": "raw", "index": "flat",
                             "index_options": {}, "compressed": False, "name": None})
        store._records = {"bad": Embedding(id="bad", value="bad", vector=[1.0])}  # wrong dims
        store.snapshot(path)
        with pytest.raises(errors.InvalidSnapshotRecord):
            vt.load_snapshot(path)

    def test_bad_config_rejected(self, tmp_path):
        path = str(tmp_path / "badcfg.snap")
        store = MemoryStore({"snapshot_version": 1, "dimensions": -3, "metric": "cosine"})
        store.snapshot(path)
        with pytest.raises(errors.InvalidDimensions):
            vt.load_snapshot(path)

    def test_bad_version_rejected(self, tmp_path):
        path = str(tmp_path / "badver.snap")
        store = MemoryStore({"snapshot_version": 99, "dimensions": 2, "metric": "cosine"})
        store.snapshot(path)
        with pytest.raises(errors.UnsupportedSnapshotVersion):
            vt.load_snapshot(path)

    def test_bad_binary_vector_rejected(self, tmp_path):
        path = str(tmp_path / "badbin.snap")
        store = MemoryStore({"snapshot_version": 1, "dimensions": 2, "metric": "cosine",
                             "normalize": "l2", "score": "raw", "index": "flat",
                             "index_options": {}, "compressed": False, "name": None})
        store._records = {
            "a": Embedding(id="a", value="a", vector=[1.0, 0.0], binary_vector=[1, 2, 3])
        }
        store.snapshot(path)
        with pytest.raises(errors.InvalidSnapshotRecord):
            vt.load_snapshot(path)


class TestProcessDeath:
    """The reference's supervision story means a collection must survive its
    creator dying (vector_hardening_test.exs:130-145). This library has no
    process model — the analog is the snapshot/restore invariant: a snapshot
    taken before a hard process death restores completely, and a death
    MID-snapshot never corrupts an existing snapshot (tmp+rename atomicity,
    store/ets.ex:29-45 semantics)."""

    SCRIPT = r"""
import os, sys
import numpy as np
import vettore_tpu as vt

path = sys.argv[1]
mode = sys.argv[2]
col = vt.Collection(name="crash", dimensions=8, metric="cosine", index="flat")
rng = np.random.default_rng(5)
data = rng.normal(size=(64, 8)).astype(np.float32)
col.put_many([{"id": f"r-{i:03d}", "vector": list(v)} for i, v in enumerate(data)])
col.snapshot(path)
if mode == "die_after_more_writes":
    col.put_many([{"id": f"lost-{i}", "vector": list(data[i])} for i in range(4)])
os._exit(9)  # hard death: no atexit, no flush
"""

    def _run_child(self, path, mode):
        import subprocess
        import sys

        proc = subprocess.run(
            [sys.executable, "-c", self.SCRIPT, str(path), mode],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert proc.returncode == 9, proc.stderr

    def test_snapshot_survives_creator_death(self, tmp_path):
        path = str(tmp_path / "crash.snap")
        self._run_child(path, "die_after_more_writes")
        col = vt.load_snapshot(path)
        assert col.count() == 64  # saved state complete; unsaved writes lost
        assert col.get("r-042") is not None
        with pytest.raises(errors.NotFound):
            col.get("lost-0")
        hits = col.search(list(np.asarray(col.get("r-007").vector)), limit=1)
        assert hits[0].id == "r-007"  # index rebuilt from canonical rows

    def test_death_mid_snapshot_preserves_previous(self, tmp_path):
        path = tmp_path / "stable.snap"
        self._run_child(str(path), "plain")
        good = path.read_bytes()
        # a later writer dying mid-write leaves only tmp litter, never a
        # truncated target: simulate the in-flight tmp file a death leaves
        (tmp_path / "stable.snap.tmpdead").write_bytes(good[: len(good) // 2])
        col = vt.load_snapshot(str(path))
        assert col.count() == 64
