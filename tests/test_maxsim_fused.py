"""Full-corpus MaxSim scan (``maxsim_full_topk_batch``) vs a float64 numpy
oracle.

The chunked XLA scan serves every single-device MaxSim query. These tests
pin its streaming mechanics (several chunks, a final chunk that overlaps the
previous one) and the edge semantics the reference pins down: zero-token
docs score 0.0, empty query sets score everything 0.0, pads never
contribute, dead slots never return
(/root/reference/native/vettore/src/multi_vector.rs:44-60,101-111).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from vettore_tpu.collection import _mv_chunk
from vettore_tpu.ops import maxsim

RNG = np.random.default_rng(77)
CAP, T, D = 128, 4, 128


def block(n_real=100, zero_token_docs=(5, 17), dead=(9,)):
    tokens = RNG.standard_normal((CAP, T, D)).astype(np.float32)
    counts = RNG.integers(1, T + 1, CAP).astype(np.int32)
    counts[n_real:] = 0
    for i in zero_token_docs:
        counts[i] = 0
    # pad token rows zero (the cache contract)
    for i in range(CAP):
        tokens[i, counts[i]:] = 0.0
    valid = np.ones(CAP, bool)
    valid[n_real:] = False
    for i in dead:
        valid[i] = False
    return jnp.asarray(tokens), jnp.asarray(counts), jnp.asarray(valid)


def queries(b=3, qmax=2):
    qtok = RNG.standard_normal((b, qmax, D)).astype(np.float32)
    qmask = np.ones((b, qmax), bool)
    if b > 1:
        qmask[1, 1:] = False  # ragged query set
    qtok[~qmask] = 0.0
    return jnp.asarray(qtok), jnp.asarray(qmask)


def oracle(tokens, counts, valid, qtok, qmask, metric, limit):
    """float64 MaxSim top-``limit`` per query: (slots, scores), ties by
    slot (slot order is the cache's lex id order)."""
    tok = np.asarray(tokens, np.float64)
    cnt = np.asarray(counts)
    ok = np.asarray(valid)
    slots, scores = [], []
    for q, m in zip(np.asarray(qtok, np.float64), np.asarray(qmask)):
        q = q[m]
        totals = np.full(tok.shape[0], -np.inf)
        for i in np.flatnonzero(ok):
            t = tok[i, : cnt[i]]
            if len(q) == 0 or len(t) == 0:
                totals[i] = 0.0
                continue
            sim = q @ t.T
            if metric == "cosine":
                den = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(t, axis=1)[None, :]
                sim = np.clip(np.where(den > 0, sim / np.where(den > 0, den, 1), 0.0), -1, 1)
            totals[i] = sim.max(axis=1).sum()
        order = np.lexsort((np.arange(len(totals)), -totals))[:limit]
        slots.append(order)
        scores.append(totals[order])
    return np.asarray(slots), np.asarray(scores)


def check(got_slots, got_scores, want_slots, want_scores):
    np.testing.assert_array_equal(np.asarray(got_slots), want_slots)
    np.testing.assert_allclose(np.asarray(got_scores), want_scores,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "inner_product",
                                    "negative_inner_product"])
def test_fused_matches_xla_oracle(metric):
    """Several chunks merged through the running (score, slot) top-k."""
    tokens, counts, valid = block()
    qtok, qmask = queries()
    got_slots, got_scores, got_ok = maxsim.maxsim_full_topk_batch(
        tokens, counts, valid, qtok, qmask, metric=metric, limit=10, chunk=32)
    assert np.asarray(got_ok).all()
    check(got_slots, got_scores,
          *oracle(tokens, counts, valid, qtok, qmask, metric, 10))


@pytest.mark.parametrize("metric", ["cosine", "inner_product"])
def test_uniform_variant_matches_xla_oracle(metric):
    """A full-token corpus scanned with a chunk that does not divide the
    block: the last chunk clamps back over rows the previous one covered,
    which must not return twice."""
    tokens = jnp.asarray(RNG.standard_normal((CAP, T, D)).astype(np.float32))
    counts = jnp.asarray(np.where(np.arange(CAP) < 100, T, 0).astype(np.int32))
    valid = jnp.asarray(np.arange(CAP) < 100)
    qtok, qmask = queries()
    got_slots, got_scores, got_ok = maxsim.maxsim_full_topk_batch(
        tokens, counts, valid, qtok, qmask, metric=metric, limit=10, chunk=48)
    assert np.asarray(got_ok).all()
    for row in np.asarray(got_slots):
        assert len(set(row.tolist())) == len(row)
    check(got_slots, got_scores,
          *oracle(tokens, counts, valid, qtok, qmask, metric, 10))


def test_large_masked_configs_require_uniform():
    """The collection's chunk size bounds the [B, chunk, Qt, T] similarity
    block (the scan's only large intermediate) at 1M docs x 32 tokens, and
    stays a power of two no smaller than 1024 rows."""
    for b, qt, t in ((64, 32, 32), (512, 32, 32), (1, 1, 1)):
        chunk = _mv_chunk(1_048_576, b, qt, t)
        assert chunk & (chunk - 1) == 0 and chunk >= 1024
        if b * qt * t * 1024 * 4 <= 512 * 2**20:
            assert b * qt * t * chunk * 4 <= 512 * 2**20
    assert _mv_chunk(500, 1, 1, 1) == 500


def test_zero_token_docs_score_zero_and_rank_by_slot():
    tokens, counts, valid = block(zero_token_docs=(0, 1, 2))
    qtok, qmask = queries(b=1, qmax=2)
    # nonnegative tokens and a negative query: every real doc scores below
    # zero, so the zero-token docs (score 0.0) win, in slot order
    tokens = jnp.abs(tokens)
    qtok = -jnp.abs(qtok)
    slots, scores, ok = maxsim.maxsim_full_topk_batch(
        tokens, counts, valid, qtok, qmask, metric="inner_product", limit=5,
        chunk=64)
    assert np.asarray(slots)[0, :3].tolist() == [0, 1, 2]
    assert np.allclose(np.asarray(scores)[0, :3], 0.0)
    check(slots, scores,
          *oracle(tokens, counts, valid, qtok, qmask, "inner_product", 5))


def test_empty_query_set_scores_all_zero():
    tokens, counts, valid = block()
    qtok = jnp.zeros((2, 2, D), jnp.float32)
    qmask = jnp.zeros((2, 2), bool)
    got_slots, got_scores, got_ok = maxsim.maxsim_full_topk_batch(
        tokens, counts, valid, qtok, qmask, metric="cosine", limit=4, chunk=64)
    want_slots, want_scores = oracle(tokens, counts, valid, qtok, qmask,
                                     "cosine", 4)
    check(got_slots, got_scores, want_slots, want_scores)
    assert np.allclose(np.asarray(got_scores), 0.0)


def test_dead_slots_never_returned():
    tokens, counts, valid = block(dead=(3, 4, 5))
    qtok, qmask = queries(b=2, qmax=2)
    slots, scores, ok = maxsim.maxsim_full_topk_batch(
        tokens, counts, valid, qtok, qmask, metric="cosine", limit=20, chunk=32)
    got = set(np.asarray(slots).ravel().tolist())
    assert not ({3, 4, 5} & got)


def test_bf16_storage_selection_recalls_f32_oracle():
    tokens, counts, valid = block()
    qtok, qmask = queries(b=2, qmax=2)
    want_slots, _ws = oracle(tokens, counts, valid, qtok, qmask, "cosine", 10)
    tb = tokens.astype(jnp.bfloat16)
    got_slots, got_scores, ok = maxsim.maxsim_full_topk_batch(
        tb, counts, valid, qtok, qmask, metric="cosine", limit=10, chunk=64)
    # bf16 storage: top-10 sets overlap heavily (the flat bf16 posture)
    for g_row, w_row in zip(np.asarray(got_slots), want_slots):
        overlap = len(set(g_row.tolist()) & set(w_row.tolist())) / 10
        assert overlap >= 0.8
