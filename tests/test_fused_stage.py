"""Funnel stage-1 candidates (prefix-metric rank + exact group-cover
selection) vs a numpy oracle, and the device funnel vs the host funnel."""

import numpy as np
import pytest

import jax.numpy as jnp

from vettore_tpu.collection import Collection
from vettore_tpu.ops import pipeline as pipe


def _corpus(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_fused_stage_candidates_oracle(metric):
    n, d, dims, b, count = 2048, 256, 128, 3, 24
    x = _corpus(n, d)
    q = _corpus(b, d, seed=1)
    valid = np.ones(n, bool)
    valid[-7:] = False  # invalid tail

    slots, ok = pipe._stage1_candidates(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(q),
        metric=metric, count=count, dims=dims)
    assert bool(np.asarray(ok).all())

    xp = x[:, :dims].astype(np.float64)
    qp = q[:, :dims].astype(np.float64)
    if metric == "cosine":
        sims = (qp @ xp.T) / np.maximum(
            np.linalg.norm(qp, axis=1)[:, None] * np.linalg.norm(xp, axis=1)[None, :],
            1e-300)
        rank = 1.0 - np.clip(sims, -1, 1)
    elif metric == "inner_product":
        rank = -(qp @ xp.T)
    else:
        rank = np.sqrt(np.maximum(
            (xp ** 2).sum(1)[None, :] - 2 * (qp @ xp.T) + (qp ** 2).sum(1)[:, None],
            0.0))
    rank = np.where(valid[None, :], rank, np.inf)
    for i in range(b):
        order = np.lexsort((np.arange(n), rank[i]))[:count]
        got = np.asarray(slots)[i]
        assert set(got.tolist()) == set(order.tolist()), metric
        # best-first by (rank, slot)
        got_ranks = rank[i][got]
        assert (np.diff(got_ranks) >= -1e-6).all()


def test_funnel_fused_equals_xla():
    """The device funnel returns the host funnel's ids and scores."""
    n, d = 2048, 256
    x = _corpus(n, d, seed=2)
    ids = [f"r-{i:04d}" for i in range(n)]
    col = Collection(name="fs", dimensions=d, metric="cosine", index="flat")
    col.put_matrix(ids, x)
    cache = col._scan_cache()

    rng = np.random.default_rng(3)
    qs = _corpus(4, d, seed=4) + 0.01 * rng.standard_normal((4, d)).astype(np.float32)

    got = col.funnel_search_batch(qs, limit=6, candidates=24, stages=[128, 256])
    prepared = col._prepare_query_batch(qs)
    for row, q in zip(got, prepared):
        want = col._funnel_host(cache, q, [128, 256], 24, 6)
        assert [r.id for r in row] == [r.id for r in want]
        np.testing.assert_allclose([r.score for r in row],
                                   [r.score for r in want], atol=1e-5)
