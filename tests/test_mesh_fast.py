"""Fast-tier sharded parity: the highest-value mesh
asserts — every sharded search mode equals its single-chip counterpart —
at 2-device scale so regressions surface in the default pytest loop, not
only in the driver's 8-device dryrun or the slow `make test-mesh` tier.
The full 8-device matrix stays in the slow suites."""

import jax
import numpy as np
import pytest

import vettore_tpu as vt
from vettore_tpu.parallel import make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs 2 devices")

DIMS = 16
N_DOCS = 70


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    vectors = rng.normal(size=(N_DOCS, DIMS)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    records = []
    for i in range(N_DOCS):
        toks = vectors[i][None, :] + 0.1 * rng.normal(size=(1 + i % 3, DIMS))
        records.append({
            "id": f"doc-{i:03d}",
            "vector": [float(v) for v in vectors[i]],
            "vectors": [[float(x) for x in row] for row in toks],
        })
    mesh = make_mesh(jax.devices()[:2])
    sharded = vt.Collection(name="mf-m", dimensions=DIMS, metric="cosine",
                            index="flat", mesh=mesh)
    single = vt.Collection(name="mf-s", dimensions=DIMS, metric="cosine",
                           index="flat")
    sharded.put_many(records)
    single.put_many(records)
    qs = vectors[rng.integers(0, N_DOCS, 3)] + 0.05 * rng.normal(
        size=(3, DIMS)).astype(np.float32)
    return sharded, single, [list(map(float, q)) for q in qs]


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert [r.id for r in g_row] == [r.id for r in w_row]
        for g, w in zip(g_row, w_row):
            assert g.score == pytest.approx(w.score, rel=1e-4, abs=1e-5)


def test_search_batch_parity(pair):
    sharded, single, qs = pair
    _rows_equal(sharded.search_batch(qs, limit=5),
                single.search_batch(qs, limit=5))


def test_funnel_parity(pair):
    sharded, single, qs = pair
    kw = dict(limit=4, candidates=16, stages=[8, DIMS])
    _rows_equal(sharded.funnel_search_batch(qs, **kw),
                single.funnel_search_batch(qs, **kw))


def test_quantized_parity(pair):
    sharded, single, qs = pair
    kw = dict(limit=4, candidates=16)
    _rows_equal(sharded.quantized_search_batch(qs, **kw),
                single.quantized_search_batch(qs, **kw))


def test_multi_vector_parity(pair):
    sharded, single, qs = pair
    qsets = [[q, [v * 0.5 for v in q]] for q in qs]
    _rows_equal(sharded.multi_vector_search_batch(qsets, limit=4),
                single.multi_vector_search_batch(qsets, limit=4))


def test_hybrid_parity(pair):
    sharded, single, qs = pair
    kw = dict(limit=4, generators=[("funnel", {"candidates": 16}),
                                   ("quantized", {"candidates": 16})])
    _rows_equal(sharded.hybrid_search_batch(qs, **kw),
                single.hybrid_search_batch(qs, **kw))
