"""Maximal Marginal Relevance reranking.

Mirrors ``Vettore.Distance.mmr_rerank/5``
(/root/reference/lib/vettore_distance.ex:325-519): greedy selection of
``final_k`` items maximizing ``alpha * query_score - (1 - alpha) *
max_similarity_to_selected``; ties pick the earliest remaining candidate.
Pair similarity per metric: cosine = true cosine; inner_product = dot;
negative_inner_product = -raw; distance metrics = 1 / (1 + distance).
"""

from __future__ import annotations

import functools
import math
from numbers import Real

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import InvalidMmrArgs, UnknownMetric
from ..metrics import DISTANCE_METRICS, SIMILARITY_METRICS
from .distance import _check_f32, _raw_f64, _finite_f32


def _pair_similarity(metric: str, a: np.ndarray, b: np.ndarray) -> float:
    if metric == "cosine":
        na = math.sqrt(float(np.dot(a, a)))
        nb = math.sqrt(float(np.dot(b, b)))
        if na == 0.0 or nb == 0.0:
            return 0.0
        sim = float(np.dot(a, b)) / (na * nb)
        return float(np.float32(min(1.0, max(-1.0, sim))))
    raw = _raw_f64(metric, a, b)
    if metric not in ("hamming", "jaccard"):
        raw = _check_f32(raw)
    else:
        raw = float(np.float32(raw))
    if metric == "inner_product":
        return raw
    if metric == "negative_inner_product":
        return -raw
    return 1.0 / (1.0 + raw)


def mmr_rerank(initial, embeddings, metric, alpha, final_k) -> list:
    """Returns the reranked ``[(id, query_score)]`` prefix of length ≤ final_k.

    ``alpha=1.0`` is pure relevance (input order preserved); lower alpha
    trades relevance for diversity against already-selected items.

    >>> pool = [("a", [1.0, 0.0]), ("b", [0.99, 0.01]), ("c", [0.0, 1.0])]
    >>> mmr_rerank([("a", 0.9), ("b", 0.89), ("c", 0.3)], pool,
    ...            "cosine", 1.0, 2)
    [('a', 0.9), ('b', 0.89)]
    >>> mmr_rerank([("a", 0.9), ("b", 0.89), ("c", 0.3)], pool,
    ...            "cosine", 0.3, 2)  # diversity pulls in the orthogonal c
    [('a', 0.9), ('c', 0.3)]
    """
    if (
        not isinstance(initial, list)
        or not isinstance(embeddings, list)
        or isinstance(alpha, bool)
        or not isinstance(alpha, Real)
        or not 0 <= float(alpha) <= 1
        or isinstance(final_k, bool)
        or not isinstance(final_k, int)
        or final_k <= 0
    ):
        raise InvalidMmrArgs("invalid mmr args")
    if metric not in SIMILARITY_METRICS and metric not in DISTANCE_METRICS:
        raise UnknownMetric(metric)
    alpha = float(alpha)

    vectors: dict[str, np.ndarray] = {}
    expected = None
    for item in embeddings:
        if not (isinstance(item, tuple) and len(item) == 2):
            raise InvalidMmrArgs("invalid mmr embedding")
        id, vector = item
        if not isinstance(id, str) or id == "" or not isinstance(vector, (list, tuple)) or not vector:
            raise InvalidMmrArgs("invalid mmr embedding")
        if id in vectors:
            raise InvalidMmrArgs("duplicate mmr embedding id")
        if expected is not None and len(vector) != expected:
            raise InvalidMmrArgs("mmr dimension mismatch")
        if not all(_finite_f32(v) for v in vector):
            raise InvalidMmrArgs("non-finite mmr vector")
        vectors[id] = np.asarray(vector, dtype=np.float64)
        expected = expected or len(vector)

    seen = set()
    for item in initial:
        if not (isinstance(item, tuple) and len(item) == 2):
            raise InvalidMmrArgs("invalid mmr initial entry")
        id, query_score = item
        if (
            not isinstance(id, str)
            or id == ""
            or not _finite_f32(query_score)
            or id not in vectors
            or id in seen
        ):
            raise InvalidMmrArgs("invalid mmr initial entry")
        seen.add(id)

    remaining = list(initial)
    selected: list = []
    while remaining and len(selected) < final_k:
        best_idx, best_score = None, None
        for idx, (id, query_score) in enumerate(remaining):
            if selected:
                redundancy = max(
                    _pair_similarity(metric, vectors[id], vectors[sel_id])
                    for sel_id, _ in selected
                )
            else:
                redundancy = 0.0
            mmr_score = alpha * float(query_score) - (1.0 - alpha) * redundancy
            if best_score is None or mmr_score > best_score:
                best_idx, best_score = idx, mmr_score
        selected.append(remaining.pop(best_idx))
    return selected


# ---------------------------------------------------------------------------
# Device batched MMR (the serving path): the O(k²·d) pairwise-similarity
# matrix is one matmul per query batch; the greedy selection runs as a
# [B]-vectorized fori_loop over final_k steps. Same ordering rules as the
# host reference loop above (earliest remaining candidate wins ties, f32
# arithmetic instead of f64 pair scoring).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("metric",))
def pairwise_similarity_batch(vecs, *, metric: str):
    """Pair similarities [B, k, k] for candidate vector blocks [B, k, d]."""
    v = vecs.astype(jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    if metric in ("cosine", "inner_product", "negative_inner_product"):
        dots = jnp.einsum("bkd,bjd->bkj", v, v, precision=hp,
                          preferred_element_type=jnp.float32)
        if metric == "cosine":
            norms = jnp.sqrt(jnp.sum(v * v, axis=2))
            denom = norms[:, :, None] * norms[:, None, :]
            sim = jnp.where(denom > 0.0, dots / denom, 0.0)
            return jnp.clip(sim, -1.0, 1.0)
        return dots if metric == "inner_product" else -dots
    if metric in ("l2", "l2_squared"):
        sq = jnp.sum(v * v, axis=2)
        d2 = jnp.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * jnp.einsum(
            "bkd,bjd->bkj", v, v, precision=hp,
            preferred_element_type=jnp.float32), 0.0)
        dist = jnp.sqrt(d2) if metric == "l2" else d2
        return 1.0 / (1.0 + dist)
    a = v[:, :, None, :]
    b = v[:, None, :, :]
    if metric == "manhattan":
        dist = jnp.sum(jnp.abs(a - b), axis=3)
    elif metric == "chebyshev":
        dist = jnp.max(jnp.abs(a - b), axis=3)
    elif metric == "hamming":
        dist = jnp.sum((a != 0.0) != (b != 0.0), axis=3).astype(jnp.float32)
    elif metric == "jaccard":
        lt = a != 0.0
        rt = b != 0.0
        union = jnp.sum(lt | rt, axis=3).astype(jnp.float32)
        inter = jnp.sum(lt & rt, axis=3).astype(jnp.float32)
        dist = jnp.where(union > 0.0, 1.0 - inter / union, 0.0)
    else:
        raise ValueError(f"unknown metric {metric}")
    return 1.0 / (1.0 + dist)


@functools.partial(jax.jit, static_argnames=("final_k",))
def mmr_select_batch(scores, sims, valid, alpha, *, final_k: int):
    """Greedy MMR order over precomputed pair similarities.

    ``scores`` [B, k] query scores, ``sims`` [B, k, k], ``valid`` [B, k].
    Returns ``order`` [B, final_k] int32 candidate indices (-1 pads once a
    query runs out of candidates). Selection rule per step: maximize
    ``alpha * score - (1 - alpha) * max_sim_to_selected`` with first-remaining
    tie-break (vettore_distance.ex:416-436)."""
    B, k = scores.shape
    steps = min(final_k, k)

    def body(t, state):
        order, chosen, max_sim = state
        # -inf until the first pick: redundancy may legitimately be NEGATIVE
        # (max cosine to selected < 0); a zero floor would mask it. The
        # isfinite guard doubles as the t==0 no-redundancy case.
        redundancy = jnp.where(jnp.isfinite(max_sim), max_sim, 0.0)
        mmr = alpha * scores - (1.0 - alpha) * redundancy
        mmr = jnp.where(valid & ~chosen, mmr, -jnp.inf)
        pick = jnp.argmax(mmr, axis=1).astype(jnp.int32)  # first max = earliest
        alive = jnp.take_along_axis(mmr, pick[:, None], axis=1)[:, 0] > -jnp.inf
        order = order.at[:, t].set(jnp.where(alive, pick, -1))
        chosen = chosen | (jax.nn.one_hot(pick, k, dtype=bool) & alive[:, None])
        picked_sim = jnp.take_along_axis(
            sims, pick[:, None, None], axis=1)[:, 0, :]  # [B, k]
        max_sim = jnp.where(alive[:, None], jnp.maximum(max_sim, picked_sim), max_sim)
        return order, chosen, max_sim

    order0 = jnp.full((B, steps), -1, jnp.int32)
    chosen0 = jnp.zeros((B, k), bool)
    max0 = jnp.full((B, k), -jnp.inf, jnp.float32)
    order, _, _ = jax.lax.fori_loop(0, steps, body, (order0, chosen0, max0))
    return order


def mmr_rerank_batch(initial_lists, vecs, *, metric, alpha, final_k):
    """Batched device MMR: ``initial_lists`` is a list of per-query
    ``[(id, query_score)]`` candidate lists (ragged ok), ``vecs`` a [B, k, d]
    array (host or device) of the candidate vectors in list order (pad rows
    arbitrary). Returns one reranked ``[(id, query_score)]`` list per query.
    """
    if metric not in SIMILARITY_METRICS and metric not in DISTANCE_METRICS:
        raise UnknownMetric(metric)
    if isinstance(alpha, bool) or not isinstance(alpha, Real) or not 0 <= float(alpha) <= 1:
        raise InvalidMmrArgs("invalid mmr args")
    if isinstance(final_k, bool) or not isinstance(final_k, int) or final_k <= 0:
        raise InvalidMmrArgs("invalid mmr args")
    B = len(initial_lists)
    if B == 0:
        return []
    k = vecs.shape[1]
    scores = np.full((B, k), -np.inf, np.float32)
    valid = np.zeros((B, k), bool)
    for b, initial in enumerate(initial_lists):
        for i, (_id, s) in enumerate(initial[:k]):
            scores[b, i] = s
            valid[b, i] = True
    sims = pairwise_similarity_batch(jnp.asarray(vecs), metric=metric)
    order = np.asarray(mmr_select_batch(
        jnp.asarray(scores), sims, jnp.asarray(valid), float(alpha),
        final_k=final_k))
    out = []
    for b, initial in enumerate(initial_lists):
        picks = [int(i) for i in order[b] if i >= 0]
        out.append([initial[i] for i in picks])
    return out
