"""ColBERT MaxSim (Chamfer) late-interaction scoring.

Host pairwise path mirrors /root/reference/native/vettore/src/multi_vector.rs:
each query vector takes its best document-vector similarity; the score is the
sum. Empty query or document side scores 0.0 but the non-empty side is still
validated (multi_vector.rs:44-60,101-111).

The device path (`batched_maxsim_scores`) scores a padded ``[D, T, d]`` token
block against ``[Q, d]`` queries in one einsum — the accelerator replacement
for the nested Rust loops — and is used by the collection's multi-vector
search and hybrid rerank.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import DimensionMismatch, InvalidVector, ScoreOverflow
from ..metrics import similarity_value, validate_metric
from .distance import _check_f32, _raw_f64, validate_vector


def _validate_matrix(vectors, dimension=None):
    """Validates a list of equal-length finite vectors; returns the dimension
    (or None for an empty list)."""
    if not isinstance(vectors, (list, tuple)):
        raise InvalidVector("vectors must be a list")
    if not vectors:
        return dimension
    first_len = len(vectors[0])
    if first_len == 0:
        raise InvalidVector("vectors must not be empty")
    expected = dimension if dimension is not None else first_len
    for v in vectors:
        if len(v) != expected:
            raise DimensionMismatch("dimension mismatch")
        validate_vector(list(v))
    return expected


def _pair_similarity(metric: str, q: np.ndarray, t: np.ndarray) -> float:
    if metric == "cosine":
        nq = math.sqrt(float(np.dot(q, q)))
        nt = math.sqrt(float(np.dot(t, t)))
        raw = 0.0 if nq == 0.0 or nt == 0.0 else float(
            np.float32(min(1.0, max(-1.0, float(np.dot(q, t)) / (nq * nt))))
        )
    else:
        raw = _raw_f64(metric, q, t)
        if metric not in ("hamming", "jaccard"):
            raw = _check_f32(raw)
        else:
            raw = float(np.float32(raw))
    return similarity_value(metric, raw)


def score(query_vectors, document_vectors, metric="cosine") -> float:
    """One MaxSim score (``MultiVector.chamfer/colbert_score``,
    multi_vector.rs:40-87)."""
    metric = validate_metric(metric)
    if not query_vectors:
        _validate_matrix(document_vectors)
        return 0.0
    dimension = _validate_matrix(query_vectors)
    if not document_vectors:
        return 0.0
    _validate_matrix(document_vectors, dimension)

    total = 0.0
    for q in query_vectors:
        qa = np.asarray(q, dtype=np.float64)
        best = -math.inf
        for t in document_vectors:
            best = max(best, _pair_similarity(metric, qa, np.asarray(t, dtype=np.float64)))
        # the reference accumulates the running total in f32
        # (multi_vector.rs:70-86); overflow past f32 range is an error
        with np.errstate(over="ignore"):
            total = float(np.float32(total + best))
        if not math.isfinite(total):
            raise ScoreOverflow("score overflow")
    return total


def top_k(documents, query_vectors, metric="cosine", limit: int = 10) -> list:
    """Batched MaxSim over ``[(id, [vectors])]``; highest score first, ties by
    lexicographically smaller id (multi_vector.rs:90-132)."""
    metric = validate_metric(metric)
    _validate_matrix(query_vectors)
    query_dim = len(query_vectors[0]) if query_vectors else None

    hits = []
    for id, vectors in documents:
        if query_dim is None:
            _validate_matrix(vectors)
            doc_score = 0.0
        elif not vectors:
            doc_score = 0.0
        else:
            _validate_matrix(vectors, query_dim)
            doc_score = score(query_vectors, vectors, metric)
        hits.append((doc_score, str(id)))
    hits.sort(key=lambda h: (-h[0], h[1]))
    return [(id, s) for s, id in hits[:limit]]


# ---------------------------------------------------------------------------
# Device batched kernels
# ---------------------------------------------------------------------------

_BIG32 = 2**31 - 1


@functools.partial(jax.jit, static_argnames=("metric",))
def batched_maxsim_scores(tokens, token_counts, queries, *, metric: str):
    """MaxSim totals for a padded doc-token block.

    ``tokens``: [D, T, d] float32 (zero-padded), ``token_counts``: [D] int32,
    ``queries``: [Q, d] float32 → ``(totals [D] f32, pair_finite [D] bool)``.
    Docs with zero tokens score 0.0. Padded token positions are masked out of
    the max. ``pair_finite`` flags docs whose pair scores stayed finite (f32
    overflow triggers the host float64 recovery path).
    """
    D, T, d = tokens.shape
    Q = queries.shape[0]
    hp = jax.lax.Precision.HIGHEST
    if metric in ("cosine", "inner_product", "negative_inner_product"):
        sim = jnp.einsum("qd,ntd->nqt", queries, tokens, precision=hp,
                         preferred_element_type=jnp.float32)
        if metric == "cosine":
            qn = jnp.sqrt(jnp.sum(queries**2, axis=1))  # [Q]
            # explicit f32 cast: bf16-resident blocks must not accumulate
            # norms in bf16 (the cast fuses into the reduction)
            tn = jnp.sqrt(jnp.sum(tokens.astype(jnp.float32) ** 2, axis=2))  # [D, T]
            denom = qn[None, :, None] * tn[:, None, :]
            sim = jnp.where(denom > 0.0, sim / denom, 0.0)
            sim = jnp.clip(sim, -1.0, 1.0)
        # negative_inner_product: raw = -dot, similarity = -raw = dot — the
        # einsum value is already the similarity.
    elif metric in ("l2", "l2_squared"):
        dots = jnp.einsum("qd,ntd->nqt", queries, tokens, precision=hp,
                          preferred_element_type=jnp.float32)
        qsq = jnp.sum(queries**2, axis=1)[None, :, None]
        tsq = jnp.sum(tokens.astype(jnp.float32) ** 2, axis=2)[:, None, :]
        dist_sq = jnp.maximum(qsq + tsq - 2.0 * dots, 0.0)
        dist = jnp.sqrt(dist_sq) if metric == "l2" else dist_sq
        sim = 1.0 / (1.0 + dist)
    else:
        # elementwise metrics: [D, Q, T, d] broadcast (used on candidate sets)
        diff_src = tokens[:, None, :, :].astype(jnp.float32)
        q_src = queries[None, :, None, :]
        if metric == "manhattan":
            dist = jnp.sum(jnp.abs(diff_src - q_src), axis=3)
        elif metric == "chebyshev":
            dist = jnp.max(jnp.abs(diff_src - q_src), axis=3)
        elif metric == "hamming":
            dist = jnp.sum((diff_src != 0.0) != (q_src != 0.0), axis=3).astype(jnp.float32)
        elif metric == "jaccard":
            lt = diff_src != 0.0
            rt = q_src != 0.0
            union = jnp.sum(lt | rt, axis=3).astype(jnp.float32)
            inter = jnp.sum(lt & rt, axis=3).astype(jnp.float32)
            dist = jnp.where(union > 0.0, 1.0 - inter / union, 0.0)
        else:
            raise ValueError(f"unknown metric {metric}")
        sim = 1.0 / (1.0 + dist)

    token_mask = jnp.arange(T)[None, :] < token_counts[:, None]  # [D, T]
    pair_finite = jnp.all(jnp.isfinite(sim) | ~token_mask[:, None, :], axis=(1, 2))
    masked = jnp.where(token_mask[:, None, :], sim, -jnp.inf)
    best = jnp.max(masked, axis=2)  # [D, Q]
    totals = jnp.sum(best, axis=1)  # [D]
    totals = jnp.where(token_counts > 0, totals, 0.0)
    if Q == 0:
        totals = jnp.zeros(D, jnp.float32)
    return totals, pair_finite


# ---------------------------------------------------------------------------
# Batched per-query token sets: full-corpus chunked scan + candidate-subset
# rerank. These are the serving-path kernels: one dispatch scores a whole
# [B, Qt, d] batch of query token sets, token blocks stream in doc chunks so
# corpora larger than any single intermediate fit in device memory (the
# [D, Q, T] sim tensor of the single-shot kernel is the limit there).
# ---------------------------------------------------------------------------


def _sim_bcqt(doc_tokens, qtok, *, metric: str, shared_docs: bool):
    """Pair similarities [B, C, Q, T] (f32).

    ``doc_tokens``: [C, T, d] when ``shared_docs`` (full-corpus chunk) else
    [B, C, T, d] (per-query candidate gather); ``qtok``: [B, Q, d] f32.
    Semantics per metric match ``_pair_similarity`` (multi_vector.rs:44-87).
    """
    hp = jax.lax.Precision.HIGHEST
    vec_axis = 2 if shared_docs else 3

    def mm(a, b):
        spec = "bqd,ctd->bcqt" if shared_docs else "bqd,bctd->bcqt"
        return jnp.einsum(spec, a, b, precision=hp,
                          preferred_element_type=jnp.float32)

    if metric in ("cosine", "inner_product", "negative_inner_product"):
        sim = mm(qtok, doc_tokens)
        if metric == "cosine":
            qn = jnp.sqrt(jnp.sum(qtok.astype(jnp.float32) ** 2, axis=2))  # [B, Q]
            tn = jnp.sqrt(jnp.sum(doc_tokens.astype(jnp.float32) ** 2, axis=vec_axis))
            tn_b = tn[None, :, None, :] if shared_docs else tn[:, :, None, :]
            denom = qn[:, None, :, None] * tn_b
            sim = jnp.where(denom > 0.0, sim / denom, 0.0)
            sim = jnp.clip(sim, -1.0, 1.0)
        # negative_inner_product: raw = -dot, similarity = -raw = dot
        return sim
    if metric in ("l2", "l2_squared"):
        dots = mm(qtok, doc_tokens)
        qsq = jnp.sum(qtok.astype(jnp.float32) ** 2, axis=2)  # [B, Q]
        tsq = jnp.sum(doc_tokens.astype(jnp.float32) ** 2, axis=vec_axis)
        tsq_b = tsq[None, :, None, :] if shared_docs else tsq[:, :, None, :]
        dist_sq = jnp.maximum(qsq[:, None, :, None] + tsq_b - 2.0 * dots, 0.0)
        dist = jnp.sqrt(dist_sq) if metric == "l2" else dist_sq
        return 1.0 / (1.0 + dist)
    # elementwise metrics: [B, C, Q, T, d] broadcast (candidate sets only)
    t_src = (doc_tokens[None, :, None, :, :] if shared_docs
             else doc_tokens[:, :, None, :, :]).astype(jnp.float32)
    q_src = qtok[:, None, :, None, :].astype(jnp.float32)
    if metric == "manhattan":
        dist = jnp.sum(jnp.abs(t_src - q_src), axis=4)
    elif metric == "chebyshev":
        dist = jnp.max(jnp.abs(t_src - q_src), axis=4)
    elif metric == "hamming":
        dist = jnp.sum((t_src != 0.0) != (q_src != 0.0), axis=4).astype(jnp.float32)
    elif metric == "jaccard":
        lt = t_src != 0.0
        rt = q_src != 0.0
        union = jnp.sum(lt | rt, axis=4).astype(jnp.float32)
        inter = jnp.sum(lt & rt, axis=4).astype(jnp.float32)
        dist = jnp.where(union > 0.0, 1.0 - inter / union, 0.0)
    else:
        raise ValueError(f"unknown metric {metric}")
    return 1.0 / (1.0 + dist)


def _totals_bc(sim, token_counts, qmask, *, shared_docs: bool):
    """MaxSim totals [B, C] + per-query finiteness [B] from sim [B, C, Q, T].

    ``token_counts``: [C] (shared) or [B, C]; ``qmask``: [B, Q] marks real
    query token rows (pads contribute nothing). Zero-token docs and empty
    query sets score 0.0 (multi_vector.rs:44-60,101-111).
    """
    T = sim.shape[3]
    counts_bc = token_counts[None, :] if shared_docs else token_counts  # [B?, C]
    token_mask = jnp.arange(T)[None, None, :] < counts_bc[..., None]  # [B?, C, T]
    tm = jnp.broadcast_to(token_mask[..., None, :] if not shared_docs
                          else token_mask[0][None, :, None, :], sim.shape)
    live = tm & qmask[:, None, :, None]
    finite = jnp.all(jnp.isfinite(sim) | ~live, axis=(1, 2, 3))  # [B]
    masked = jnp.where(tm, sim, -jnp.inf)
    best = jnp.max(masked, axis=3)  # [B, C, Q]
    best = jnp.where(qmask[:, None, :], best, 0.0)
    totals = jnp.sum(best, axis=2)  # [B, C]
    totals = jnp.where(counts_bc > 0, totals, 0.0)
    # a finite-pair sum can still overflow f32 — the host oracle raises there
    finite = finite & jnp.all(jnp.isfinite(totals), axis=1)
    return totals, finite


def _merge_desc(scores_a, slots_a, scores_b, slots_b, limit):
    """Merges two (score desc, slot asc)-ordered candidate sets."""
    s = jnp.concatenate([scores_a, scores_b], axis=1)
    sl = jnp.concatenate([slots_a, slots_b], axis=1)
    key_slot = jnp.where(s > -jnp.inf, sl, _BIG32)
    neg_s, _, sl_s, s_s = jax.lax.sort((-s, key_slot, sl, s), num_keys=2, dimension=1)
    del neg_s
    return s_s[:, :limit], sl_s[:, :limit]


@functools.partial(jax.jit, static_argnames=("metric", "limit", "chunk"))
def maxsim_full_topk_batch(tokens, token_counts, valid, qtok, qmask, *,
                           metric: str, limit: int, chunk: int):
    """Full-corpus MaxSim top-k for a batch of query token sets.

    ``tokens`` [N, T, d] (f32 or bf16 storage), ``token_counts`` [N] int32,
    ``valid`` [N] bool, ``qtok`` [B, Qt, d] f32, ``qmask`` [B, Qt] bool.
    Streams doc chunks of ``chunk`` rows (the [chunk, Qt, T] sim block is the
    only large intermediate) and keeps a running (score desc, slot asc) top-k
    merge. Returns ``(slots [B, L] i32 (-1 pads), scores [B, L], ok [B])``;
    ``ok`` False = non-finite pair/total for that query → host fallback.

    Slot order is the caller's lex id order, so the slot tie-break equals the
    reference's id tie-break (multi_vector.rs:118-124).
    """
    N = tokens.shape[0]
    B = qtok.shape[0]
    L = min(limit, N)
    nch = -(-N // chunk)

    def score_chunk(start):
        tk = jax.lax.dynamic_slice_in_dim(tokens, start, chunk, axis=0)
        ct = jax.lax.dynamic_slice_in_dim(token_counts, start, chunk, axis=0)
        vd = jax.lax.dynamic_slice_in_dim(valid, start, chunk, axis=0)
        sim = _sim_bcqt(tk, qtok, metric=metric, shared_docs=True)
        totals, fin = _totals_bc(sim, ct, qmask, shared_docs=True)
        slots = start + jnp.arange(chunk, dtype=jnp.int32)[None, :]
        scores = jnp.where(vd[None, :], totals, -jnp.inf)
        return scores, jnp.broadcast_to(slots, (B, chunk)), fin

    if nch == 1:
        scores, slots, ok = score_chunk(jnp.int32(0))
        k_scores, k_idx = jax.lax.top_k(scores, L)
        k_slots = jnp.take_along_axis(slots, k_idx, axis=1)
    else:
        init = (jnp.full((B, L), -jnp.inf, jnp.float32),
                jnp.full((B, L), _BIG32, jnp.int32),
                jnp.ones(B, bool))

        def body(carry, i):
            cs, csl, cok = carry
            # the final chunk clamps to [N - chunk, N); rows already covered
            # by the previous chunk are masked out (no duplicate slots)
            start = jnp.minimum(i * chunk, N - chunk)
            scores, slots, fin = score_chunk(start)
            fresh = slots >= i * chunk
            scores = jnp.where(fresh, scores, -jnp.inf)
            t_scores, t_idx = jax.lax.top_k(scores, min(L, chunk))
            t_slots = jnp.take_along_axis(slots, t_idx, axis=1)
            ms, msl = _merge_desc(cs, csl, t_scores, t_slots, L)
            return (ms, msl, cok & fin), None

        (k_scores, k_slots, ok), _ = jax.lax.scan(
            body, init, jnp.arange(nch, dtype=jnp.int32))
    k_slots = jnp.where(k_scores > -jnp.inf, k_slots, -1)
    return k_slots, k_scores, ok


@functools.partial(jax.jit, static_argnames=("metric", "limit"))
def maxsim_subset_topk_batch(tokens, token_counts, slots, slot_ok, qtok, qmask, *,
                             metric: str, limit: int):
    """Per-query candidate-subset MaxSim rerank (the hybrid rerank stage).

    ``slots`` [B, C] int32 cache slots (pads where ``slot_ok`` False),
    ``qtok`` [B, Qt, d] f32 per-query token sets with ``qmask`` [B, Qt].
    Returns ``(top_slots [B, k] (-1 pads), scores [B, k], ok [B])`` ordered by
    (score desc, slot asc). Callers bound the [B, C, T, d] gather by chunking
    the query batch.
    """
    sub = tokens[jnp.maximum(slots, 0)]  # [B, C, T, d] in storage dtype
    subc = jnp.where(slot_ok, token_counts[jnp.maximum(slots, 0)], 0)
    sim = _sim_bcqt(sub, qtok, metric=metric, shared_docs=False)
    totals, ok = _totals_bc(sim, subc, qmask, shared_docs=False)
    scores = jnp.where(slot_ok, totals, -jnp.inf)
    k = min(limit, slots.shape[1])
    key_slot = jnp.where(scores > -jnp.inf, slots, _BIG32)
    _, _, slot_s, score_s = jax.lax.sort(
        (-scores, key_slot, slots, scores), num_keys=2, dimension=1)
    top_slots = jnp.where(score_s[:, :k] > -jnp.inf, slot_s[:, :k], -1)
    return top_slots, score_s[:, :k], ok
