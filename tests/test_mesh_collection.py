"""Mesh-backed Collection lifecycle on the virtual 8-device CPU mesh:
sharded ingest, search parity with a single-chip collection, mutation,
snapshot/restore (SURVEY §5.8)."""

import jax
import numpy as np
import pytest

import vettore_tpu as vt
from vettore_tpu.parallel import make_mesh

pytestmark = [
    pytest.mark.slow,  # multi-minute: 8-device shard_map compiles
    pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices"),
]


def corpus(n=80, d=16, seed=11):
    rng = np.random.default_rng(seed)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    return [
        {"id": f"doc-{i:03d}", "vector": [float(v) for v in vectors[i]]}
        for i in range(n)
    ], vectors


def make_pair(metric="cosine", index="flat", data=2, **opts):
    mesh = make_mesh(data=data)
    records, vectors = corpus()
    sharded = vt.Collection(name="m", dimensions=16, metric=metric, index=index,
                            mesh=mesh, **opts)
    single = vt.Collection(name="s", dimensions=16, metric=metric, index=index,
                           **opts)
    sharded.put_many(records)
    single.put_many(records)
    return sharded, single, records, vectors


class TestMeshFlatCollection:
    def test_search_matches_single_chip(self):
        sharded, single, records, vectors = make_pair()
        for qi in (3, 17, 42):
            got = sharded.search(list(vectors[qi]), limit=7)
            want = single.search(list(vectors[qi]), limit=7)
            assert [r.id for r in got] == [r.id for r in want]
            # cross-shard reductions may split differently: scores agree to
            # f32 precision, not bit-for-bit
            for g, w in zip(got, want):
                assert g.score == pytest.approx(w.score, abs=1e-5)

    def test_search_batch_matches(self):
        sharded, single, records, vectors = make_pair()
        got = sharded.search_batch(vectors[:5].tolist(), limit=5)
        want = single.search_batch(vectors[:5].tolist(), limit=5)
        for g, w in zip(got, want):
            assert [r.id for r in g] == [r.id for r in w]

    def test_delete_then_insert(self):
        sharded, single, records, vectors = make_pair()
        sharded.delete("doc-003")
        single.delete("doc-003")
        got = sharded.search(list(vectors[3]), limit=5)
        want = single.search(list(vectors[3]), limit=5)
        assert "doc-003" not in [r.id for r in got]
        assert [r.id for r in got] == [r.id for r in want]
        # re-insert triggers a reshard; parity must hold
        sharded.put(records[3])
        single.put(records[3])
        got = sharded.search(list(vectors[3]), limit=5)
        assert got[0].id == "doc-003"

    def test_adaptive_modes_work_on_mesh_collection(self):
        sharded, single, records, vectors = make_pair()
        got = sharded.funnel_search(list(vectors[9]), stages=[8, 16], candidates=30,
                                    limit=5)
        want = single.funnel_search(list(vectors[9]), stages=[8, 16], candidates=30,
                                    limit=5)
        assert [r.id for r in got] == [r.id for r in want]

    def test_snapshot_restore_on_mesh(self, tmp_path):
        sharded, single, records, vectors = make_pair()
        path = str(tmp_path / "mesh.snap")
        sharded.snapshot(path)
        mesh = make_mesh(data=2)
        loaded = vt.load_snapshot(path, mesh=mesh)
        got = loaded.search(list(vectors[7]), limit=5)
        want = single.search(list(vectors[7]), limit=5)
        assert [r.id for r in got] == [r.id for r in want]
        for g, w in zip(got, want):
            assert g.score == pytest.approx(w.score, abs=1e-5)
        # and a mesh snapshot loads fine on a single chip
        plain = vt.load_snapshot(path)
        got = plain.search(list(vectors[7]), limit=5)
        assert [r.id for r in got] == [r.id for r in want]


class TestMeshHnswCollection:
    OPTS = {"index_options": {"m": 4, "m0": 8, "ef_construction": 24,
                              "ef_search": 40}}

    def test_self_recall_and_overlap(self):
        sharded, single, records, vectors = make_pair(index="hnsw", **self.OPTS)
        overlaps = []
        for qi in range(0, 80, 7):
            got = sharded.search(list(vectors[qi]), limit=5)
            want = single.search(list(vectors[qi]), limit=5)
            assert got[0].id == f"doc-{qi:03d}"
            overlaps.append(
                len({r.id for r in got} & {r.id for r in want}) / 5
            )
        assert np.mean(overlaps) >= 0.9

    def test_pending_tail_insert(self):
        sharded, single, records, vectors = make_pair(index="hnsw", **self.OPTS)
        rng = np.random.default_rng(5)
        extra = rng.normal(size=(3, 16)).astype(np.float32)
        extra /= np.linalg.norm(extra, axis=1, keepdims=True)
        for i, v in enumerate(extra):
            sharded.put({"id": f"new-{i}", "vector": [float(x) for x in v]})
        # pending rows are scanned exactly: a fresh insert is findable at once
        got = sharded.search(list(extra[1]), limit=3)
        assert got[0].id == "new-1"

    def test_tiny_corpus_few_rows_per_shard(self):
        """Fewer rows per shard than the hub seed count must not crash, and
        zero-vector pad rows must not displace real candidates."""
        mesh = make_mesh(data=2)
        rng = np.random.default_rng(2)
        vecs = rng.normal(size=(10, 16)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        col = vt.Collection(name="tiny", dimensions=16, metric="cosine",
                            index="hnsw", mesh=mesh, **self.OPTS)
        col.put_many([
            {"id": f"t-{i:02d}", "vector": [float(v) for v in vecs[i]]}
            for i in range(10)
        ])
        got = col.search(list(vecs[4]), limit=5)
        assert got[0].id == "t-04"
        assert len(got) == 5
        assert all(r.id.startswith("t-") for r in got)

    def test_delete_masks_graph_hits(self):
        sharded, single, records, vectors = make_pair(index="hnsw", **self.OPTS)
        sharded.delete("doc-010")
        got = sharded.search(list(vectors[10]), limit=5)
        assert "doc-010" not in [r.id for r in got]
        assert len(got) == 5

    def test_incremental_ingest_while_serving(self):
        """Mutations AFTER the first search go through the in-place shard
        graph mutation path (no full-mesh rebuild) and are immediately
        visible to subsequent searches."""
        sharded, single, records, vectors = make_pair(index="hnsw", **self.OPTS)
        # first search bulk-builds the per-shard graphs
        assert sharded.search(list(vectors[0]), limit=3)[0].id == "doc-000"
        rng = np.random.default_rng(7)
        extra = rng.normal(size=(6, 16)).astype(np.float32)
        extra /= np.linalg.norm(extra, axis=1, keepdims=True)
        new = [{"id": f"new-{i}", "vector": [float(x) for x in v]}
               for i, v in enumerate(extra)]
        sharded.put_many(new)
        single.put_many(new)
        # fresh inserts are immediately searchable through the mutated graphs
        for i in (0, 3, 5):
            got = sharded.search(list(extra[i]), limit=3)
            assert got[0].id == f"new-{i}"
        # deletes tombstone in place, no rebuild
        sharded.delete("new-2")
        single.delete("new-2")
        got = sharded.search(list(extra[2]), limit=5)
        assert "new-2" not in [r.id for r in got]
        # replace (delete + reinsert): the id takes a new vector in place
        sharded.delete("doc-001")
        single.delete("doc-001")
        repl = {"id": "doc-001", "vector": [float(x) for x in extra[2]]}
        sharded.put(repl)
        single.put(repl)
        got = sharded.search(list(extra[2]), limit=3)
        assert got[0].id == "doc-001"
        overlaps = []
        for qi in range(0, 80, 9):
            got = {r.id for r in sharded.search(list(vectors[qi]), limit=5)}
            want = {r.id for r in single.search(list(vectors[qi]), limit=5)}
            overlaps.append(len(got & want) / 5)
        assert np.mean(overlaps) >= 0.85

    def test_shard_compaction_after_heavy_delete(self, monkeypatch):
        """A shard whose tombstones pass the compaction threshold rebuilds
        ALONE; searches stay correct through and after the compaction."""
        from vettore_tpu.index import hnsw_build

        sharded, single, records, vectors = make_pair(index="hnsw", **self.OPTS)
        sharded.search(list(vectors[0]), limit=1)  # build
        monkeypatch.setattr(hnsw_build, "should_compact", lambda g: True)
        for i in range(40, 56):
            sharded.delete(f"doc-{i:03d}")
        got = sharded.search(list(vectors[10]), limit=10)
        ids = [r.id for r in got]
        assert ids[0] == "doc-010"
        assert not any(f"doc-{i:03d}" in ids for i in range(40, 56))
        # reinsert after compaction lands in a compacted shard and serves
        sharded.put(records[45])
        got = sharded.search(list(vectors[45]), limit=3)
        assert got[0].id == "doc-045"


class TestMeshIvfCollection:
    """IVF sharded over the mesh: with n_probe covering every per-shard
    block, results must match the single-chip collection exactly (the
    full-candidate-equals-exact discipline,
    /root/reference/test/vector_adversarial_test.exs:376-421)."""

    OPTS = {"index_options": {"n_probe": 65_536, "kmeans_iters": 2}}

    def test_search_matches_single_chip(self):
        sharded, single, records, vectors = make_pair(index="ivf", **self.OPTS)
        for qi in (3, 17, 42):
            got = sharded.search(list(vectors[qi]), limit=7)
            want = single.search(list(vectors[qi]), limit=7)
            assert [r.id for r in got] == [r.id for r in want]
            for g, w in zip(got, want):
                assert g.score == pytest.approx(w.score, abs=1e-2)

    def test_delete_then_insert(self):
        sharded, single, records, vectors = make_pair(index="ivf", **self.OPTS)
        sharded.delete("doc-003")
        got = sharded.search(list(vectors[3]), limit=5)
        assert "doc-003" not in [r.id for r in got]
        sharded.put(records[3])
        got = sharded.search(list(vectors[3]), limit=5)
        assert got[0].id == "doc-003"

    def test_l2_metric_parity(self):
        sharded, single, records, vectors = make_pair(index="ivf", metric="l2",
                                                      **self.OPTS)
        got = sharded.search(list(vectors[9]), limit=5)
        want = single.search(list(vectors[9]), limit=5)
        assert [r.id for r in got] == [r.id for r in want]

    def test_auto_n_probe_on_mesh(self):
        """n_probe="auto" tunes per-shard at build time (index/ivf.py's
        _tune_n_probe, sharded variant) and the tuned probe count serves."""
        sharded, single, records, vectors = make_pair(
            index="ivf",
            index_options={"n_probe": "auto", "kmeans_iters": 2,
                           "target_recall": 0.9})
        got = sharded.search(list(vectors[4]), limit=5)
        assert len(got) == 5
        idx = sharded.index
        idx._sync()
        tuned = idx._sharded.tuned
        assert tuned is not None and tuned["target"] == 0.9
        p = idx._sharded.effective_n_probe()
        assert isinstance(p, int) and p >= 1
        assert tuned["recall_at_10"] >= 0.9 or p >= idx._sharded.capb // 64

    def test_snapshot_restore_on_mesh(self, tmp_path):
        sharded, single, records, vectors = make_pair(index="ivf", **self.OPTS)
        snap = tmp_path / "mesh-ivf.snap"
        sharded.snapshot(str(snap))
        loaded = vt.load_snapshot(str(snap), mesh=sharded.mesh)
        assert loaded.index_kind == "ivf"
        got = loaded.search(list(vectors[5]), limit=3)
        assert got[0].id == "doc-005"
        loaded.close()
