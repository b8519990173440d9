"""IVF (inverted-file) device ops: k-means routing + block-gather rescore.

An accelerator ANN design with no counterpart in the reference (the
reference's only sub-linear index is the pointer-chasing HNSW graph,
hnsw.rs:292-333; this index serves the same role — approximate search far
below the exact-scan cost — with a layout of dense matmuls and contiguous
reads instead of pointer chasing):

* **build**: k-means over the corpus (assignment = one chunked matmul +
  argmax per iteration, update = segment-sum), then rows are REORDERED
  cluster-major and chopped into contiguous ``GROUP``-row blocks. Every
  build step is a dense batched matmul, no graph construction.
* **search**: queries rank *block centroids* with one small matmul
  ([B, d] x [d, N/64] — ~0.1% of the full-scan FLOPs), probe the best
  ``n_probe`` blocks, and rescore only those rows through the flat scan's
  group rescore (ops/flat_scan._rescore): device-memory traffic is
  ``n_probe * GROUP`` rows per query instead of N. The winners re-score at
  HIGHEST precision exactly like the flat scans.

Contiguous 64-row blocks are the whole trick: the cluster-major permutation
makes each probed candidate set a few contiguous row blocks by
construction, not scattered single rows.

Approximation contract matches HNSW (recall measured against the exact scan,
no exactness flag); with ``n_probe >= n_blocks`` every row is rescored and
results equal the exact fused scan including (rank, id) tie order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import select
from .flat_scan import GROUP, TIE_PAD, _finalize, _rescore

#: metrics the IVF routing + rescore path serves (the fused-scan set)
IVF_METRICS = ("cosine", "inner_product", "negative_inner_product", "l2",
               "l2_squared")

_BIG32 = 2**31 - 1


# ---------------------------------------------------------------------------
# build: k-means assignment + cluster-major permutation
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("spherical",))
def _assign_chunk(xc, cent_t, csq, *, spherical):
    """Nearest-centroid assignment for one row chunk. ``cent_t`` [d, C]
    storage-cast centroids, ``csq`` [C] squared norms. Spherical (cosine/IP)
    routes by max dot; otherwise by min L2 via the norm expansion."""
    # selection-only (routing): bf16 operands, f32 accumulation
    dots = jnp.dot(xc.astype(cent_t.dtype), cent_t,
                   preferred_element_type=jnp.float32)  # [T, C]
    if spherical:
        return jnp.argmax(dots, axis=1).astype(jnp.int32)
    return jnp.argmin(csq[None, :] - 2.0 * dots, axis=1).astype(jnp.int32)


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("n_cent",))
def _update_centroids(cent, x, w, assign, *, n_cent):
    """One k-means update: weighted segment-mean of rows per centroid.
    ``w`` [N] 0/1 weights mask dead/pad rows out of the statistics."""
    xw = x * w[:, None]
    sums = jnp.zeros((n_cent, x.shape[1]), jnp.float32).at[assign].add(xw)
    cnts = jnp.zeros((n_cent,), jnp.float32).at[assign].add(w)
    fresh = sums / jnp.maximum(cnts, 1.0)[:, None]
    return jnp.where((cnts > 0)[:, None], fresh, cent)


def kmeans_assign(x, valid, *, n_cent: int, iters: int, metric: str,
                  chunk: int = 65_536):
    """K-means over a device ``[N, d]`` f32 block; returns the final
    ``assign`` [N] int32 device array. Dead rows (``valid`` False) are pinned
    to sentinel cluster ``n_cent`` so the cluster-major sort packs them into
    trailing blocks (which carry +inf block bias and never win a probe).

    Assignment is chunked matmul+argmax, update is one segment-sum.
    Centroids route in bfloat16 (routing is approximate by design; the
    rescore is full width).
    """
    n, _d = x.shape
    spherical = metric in ("cosine", "inner_product", "negative_inner_product")
    w = valid.astype(jnp.float32)
    # strided init over the block: dead rows yield zero centroids that only
    # ever attract other dead/zero rows
    stride = max(1, n // n_cent)
    cent = (x[::stride][:n_cent] * w[::stride][:n_cent, None]).astype(jnp.float32)
    if cent.shape[0] < n_cent:
        cent = jnp.pad(cent, ((0, n_cent - cent.shape[0]), (0, 0)))
    assign = None
    for _ in range(max(1, iters)):
        cent_t = cent.astype(jnp.bfloat16).T
        csq = jnp.sum(cent * cent, axis=1)
        parts = []
        s = 0
        while s < n:
            c = min(chunk, n - s)
            parts.append(_assign_chunk(
                jax.lax.dynamic_slice_in_dim(x, s, c), cent_t, csq,
                spherical=spherical))
            s += c
        assign = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        cent = _update_centroids(cent, x, w, assign, n_cent=n_cent)
    return jnp.where(valid, assign, jnp.int32(n_cent))


@functools.partial(jax.jit, static_argnames=("metric",))
def build_blocks(xs, valid_sorted, *, metric):
    """Per-block routing state from a cluster-major block. ``xs`` [N, d] f32
    (dead rows zero), ``valid_sorted`` [N] bool. Returns ``(bcb [NG, d]
    bf16 routing centroids, csq [NG] f32, block_bias [NG] f32, xsq [N] f32,
    bias [N] f32)``. Cosine routing centroids are L2-normalized (block rank
    is then a pure dot like the flat cosine posture, flat.rs:105)."""
    n, d = xs.shape
    ng = n // GROUP
    w = valid_sorted.astype(jnp.float32)
    cnt = jnp.sum(w.reshape(ng, GROUP), axis=1)
    cent = jnp.sum(xs.reshape(ng, GROUP, d), axis=1) / jnp.maximum(cnt, 1.0)[:, None]
    if metric == "cosine":
        norm = jnp.linalg.norm(cent, axis=1, keepdims=True)
        cent = jnp.where(norm > 0.0, cent / jnp.maximum(norm, 1e-30), cent)
    csq = jnp.sum(cent * cent, axis=1)
    block_bias = jnp.where(cnt > 0.0, 0.0, jnp.inf).astype(jnp.float32)
    xsq = jnp.sum(xs * xs, axis=1)
    bias = jnp.where(valid_sorted, 0.0, jnp.inf).astype(jnp.float32)
    return cent.astype(jnp.bfloat16), csq, block_bias, xsq, bias


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("metric", "nprobe", "k"))
def ivf_search(xb, xsq, bias, lex_rank, bcb, csq, block_bias, q, *,
               metric, nprobe, k):
    """Batched IVF top-k over a cluster-major block.

    ``xb`` [N, d] storage block (f32/bf16), ``xsq``/``bias`` [N] f32,
    ``lex_rank`` [N] int32 id ranks (block-slot order is NOT id order),
    ``bcb`` [NG, d] bf16 routing centroids, ``csq``/``block_bias`` [NG] f32,
    ``q`` [B, d] f32. Returns ``(slots [B, k] i32 block slots, raws [B, k]
    f32 HIGHEST-rescored, ranks [B, k] f32)`` best-first with the flat
    (rank, lex id) tie-break over the probed candidate set.
    """
    n = xb.shape[0]
    b = q.shape[0]
    ng = n // GROUP
    p = min(nprobe, ng)
    qf = q.astype(jnp.float32)
    # selection-only (block routing): bf16 operands, f32 accumulation
    dots = jnp.dot(qf.astype(jnp.bfloat16), bcb.T,
                   preferred_element_type=jnp.float32)  # [B, NG]
    if metric in ("cosine", "inner_product"):
        crank = -dots
    elif metric == "negative_inner_product":
        crank = dots
    else:  # l2 / l2_squared: qsq is constant per row, drop it
        crank = csq[None, :] - 2.0 * dots
    crank = crank + block_bias[None, :]
    _cv, gidx, _ok = select.group_topk(crank, p)
    gidx = jnp.minimum(gidx, ng - 1)

    cand = _rescore(xb, xsq, bias, qf, gidx, metric=metric).reshape(b, p * GROUP)
    cand_slots = (
        gidx[:, :, None] * GROUP + jnp.arange(GROUP, dtype=jnp.int32)[None, None, :]
    ).reshape(b, p * GROUP)

    sel = min(k + TIE_PAD, p * GROUP)
    neg_sel, pos = jax.lax.top_k(-cand, sel)
    sel_rank = -neg_sel
    sel_slots = jnp.take_along_axis(cand_slots, pos, axis=1)
    sel_lex = jnp.where(jnp.isfinite(sel_rank), lex_rank[sel_slots], _BIG32)
    rank_s, _, slot_s = jax.lax.sort(
        (sel_rank, sel_lex, sel_slots), num_keys=2, dimension=1)
    top_rank = rank_s[:, :k]
    top_slot = slot_s[:, :k]
    top_slot, raw, top_rank = _finalize(xb, qf, top_slot, top_rank, metric=metric)
    raw = jnp.where(jnp.isfinite(top_rank), raw, jnp.float32(0.0))
    return top_slot, raw, top_rank


@jax.jit
def gather_lex_rows(x, idx):
    """``xs[i] = x[idx[i]]`` with ``idx`` -1 meaning a zero pad row — the
    live-rows-in-id-order gather that feeds the k-means build."""
    rows = x[jnp.maximum(idx, 0)]
    return jnp.where((idx >= 0)[:, None], rows, 0.0).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("metric", "k", "capb"))
def merge_with_tail(slots, raws, ranks, lex_of_slots, t_slots, t_raws, *,
                    metric, k, capb):
    """One-dispatch (rank, lex) merge of the built block's IVF hits with the
    pending tail's exact hits. Tail slots are encoded past ``capb``; tail
    rows carry lex keys past every built row's (fresh ids sort after
    equal-rank built rows — the build-time lex snapshot can't rank them).
    Raws ride the sort as values, so no post-hoc slot matching."""
    if metric == "cosine":
        t_ranks = 1.0 - t_raws
    elif metric == "inner_product":
        t_ranks = -t_raws
    else:
        t_ranks = t_raws
    big = jnp.int32(2**30)
    a_rank = jnp.where(jnp.isfinite(ranks), ranks, jnp.inf)
    t_rank = jnp.where(t_slots >= 0, t_ranks, jnp.inf)
    t_lex = jnp.where(t_slots >= 0, big + t_slots, _BIG32)
    m_rank = jnp.concatenate([a_rank, t_rank], axis=1)
    m_lex = jnp.concatenate([lex_of_slots, t_lex], axis=1)
    m_slot = jnp.concatenate([slots, t_slots + capb], axis=1)
    m_raw = jnp.concatenate([raws, t_raws], axis=1)
    _r, _l, slot_s, raw_s = jax.lax.sort(
        (m_rank, m_lex, m_slot, m_raw), num_keys=2, dimension=1)
    return slot_s[:, :k], raw_s[:, :k]
