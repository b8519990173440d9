"""Bulk HNSW construction as cluster-blocked kNN-graph assembly.

The wave build (hnsw_build.py) runs the reference's insert search batched —
correct, but each construct beam is a sequential chain of ``W*m0``
neighbor-row gathers, and scattered single-row gathers are the access
pattern accelerators serve worst: a sequential chain of them leaves the
matmul units idle.

This module builds the SAME BulkGraph (levels, slot order, lex tie-breaks,
entry, layer layout all identical) from dense matmul work instead, the way the
IVF index (ops/ivf.py) replaced graph traversal for search:

1. every layer's node set is a slot PREFIX (slots are (level desc, id)
   ordered), so layer l is just ``slots[:nl]``;
2. k-means clusters the prefix (chunked bf16 matmul + argmax; centroid
   update is a chunked segment-sum), rows sort cluster-major, and 64-row
   windows become routing blocks — identical trick to the IVF build;
3. each block scores its rows against the rows of its ``PROBES`` nearest
   blocks in one batched matmul — candidates are CONTIGUOUS by
   construction, so the only gathers move 64-row blocks, not single rows;
4. per row, the best ``2*deg`` candidates pass through the same diversity
   heuristic the wave build uses (`hnsw_build._heuristic_select`), giving
   the forward adjacency;
5. one reciprocal pass per layer (sort edges by (dst, dist, src-lex), cap
   incoming, union with forward rows, rescore, heuristic-prune) — the
   batched equivalent of the reference's add-then-prune
   (/root/reference/native/vettore/src/hnsw.rs:220-236), reusing the wave
   build's segment-program design.

The produced graph is a layered navigable-small-world graph rather than an
insertion-order HNSW — the parity gate is recall@k vs the exact scan
(SURVEY §7), which construction-by-kNN meets at a fraction of the build
cost. The graph remains deterministic: k-means init is strided, sorts are
stable, and levels/tie-breaks are the reference's.

Incremental mutation after a kNN build goes through the unchanged wave
kernel (`hnsw_build.incremental_put`): both algorithms emit the same array
layout.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .hnsw_build import (
    _BIG32,
    HEURISTIC_SELECTION,
    BulkGraph,
    _heuristic_select,
    _prep_order,
    _rank_block,
)

GROUP = 64
#: neighbor blocks scored per block (x64 rows = the candidate pool per row).
#: More probes cost build time and buy recall at a low query-time ef
PROBES = int(os.environ.get("VETTORE_KNN_PROBES", "24"))
#: k-means refinement sweeps over the layer prefix
KMEANS_ITERS = int(os.environ.get("VETTORE_KNN_ITERS", "4"))
#: blocks processed per device dispatch in the scoring loop
CHUNK_BLOCKS = 64
#: capacity-bucket floor (blocks): every layer pads up to a pow2 block count
#: at least this large, so small layers reuse one compiled shape set
MIN_NGB = int(os.environ.get("VETTORE_KNN_MIN_NGB", "256"))
_KM_CHUNK = 65_536


def _next_pow2(v: int) -> int:
    return 1 << max(0, (int(v) - 1)).bit_length()


def _rank_from_dots(dots, rsq, csq, metric):
    """Ascending rank distances from bf16 dot products (f32 accumulated).
    ``rsq``/``csq`` are squared norms (only consulted for l2)."""
    if metric == "cosine":
        return 1.0 - dots
    if metric == "l2":
        return jnp.sqrt(jnp.maximum(rsq[..., :, None] + csq[..., None, :] - 2.0 * dots,
                                    0.0))
    return -dots  # inner_product


# ---------------------------------------------------------------------------
# layer setup: k-means over the (bf16) layer prefix, cluster-major sort, and
# block probe lists — ONE jitted program per layer shape (an eager-op version
# spends minutes in per-op compiles on a small CPU host)
# ---------------------------------------------------------------------------


def _kmeans_assign(xt_pad, w, ngb: int, metric: str):
    """Cluster assignment for the padded prefix (traced helper). Chunked
    matmul+argmax assignment, segment-sum update, ``KMEANS_ITERS`` sweeps via
    ``lax.scan``; no f32 copy of the corpus ever materializes."""
    capk, d = xt_pad.shape
    spherical = metric in ("cosine", "inner_product")
    ck = min(_KM_CHUNK, capk)
    nchunk = capk // ck
    x_chunks = xt_pad.reshape(nchunk, ck, d)
    w_chunks = w.reshape(nchunk, ck)
    stride = max(1, capk // ngb)
    cent = (xt_pad[::stride][:ngb].astype(jnp.float32) * w[::stride][:ngb, None])
    if cent.shape[0] < ngb:
        cent = jnp.pad(cent, ((0, ngb - cent.shape[0]), (0, 0)))

    def assign_chunk(cent_t, csq, xc):
        # selection-only (routing): default matmul precision suffices
        dots = jnp.dot(xc, cent_t.astype(xc.dtype),
                       preferred_element_type=jnp.float32)
        if spherical:
            return jnp.argmax(dots, axis=1).astype(jnp.int32)
        return jnp.argmin(csq[None, :] - 2.0 * dots, axis=1).astype(jnp.int32)

    def one_iter(cent, _):
        cent_t = cent.T
        csq = jnp.sum(cent * cent, axis=1)

        def chunk_step(carry, xw):
            sums, cnts = carry
            xc, wc = xw
            a = assign_chunk(cent_t, csq, xc)
            sums = sums.at[a].add(xc.astype(jnp.float32) * wc[:, None])
            cnts = cnts.at[a].add(wc)
            return (sums, cnts), None

        (sums, cnts), _ = jax.lax.scan(
            chunk_step, (jnp.zeros((ngb, d), jnp.float32),
                         jnp.zeros((ngb,), jnp.float32)),
            (x_chunks, w_chunks))
        fresh = sums / jnp.maximum(cnts, 1.0)[:, None]
        return jnp.where((cnts > 0)[:, None], fresh, cent), None

    cent, _ = jax.lax.scan(one_iter, cent, None, length=max(1, KMEANS_ITERS))
    cent_t = cent.T
    csq = jnp.sum(cent * cent, axis=1)
    _, assigns = jax.lax.scan(
        lambda c, xc: (c, assign_chunk(cent_t, csq, xc)), 0, x_chunks)
    return assigns.reshape(capk)


@functools.partial(jax.jit, static_argnames=("ngb", "probes", "metric"))
def _layer_setup(xt, lex_d, nl, *, ngb, probes, metric):
    """Cluster-major layout + probe lists for the layer whose node set is
    slots [0, nl) (``nl`` traced — layers sharing a capacity bucket share
    one compiled program). Returns ``(xs [capb, d] bf16, valid_s, lex_s,
    slot_s, nb [ngb, probes])``."""
    n, d = xt.shape
    capb = ngb * GROUP
    if ngb <= probes:
        perm = jnp.arange(capb, dtype=jnp.int32)
    else:
        head = min(capb, n)
        xt_pad = jnp.concatenate(
            [xt[:head], jnp.zeros((capb - head, d), xt.dtype)]
        ) if capb > head else xt[:head]
        w = (jnp.arange(capb, dtype=jnp.int32) < nl).astype(jnp.float32)
        assign = _kmeans_assign(xt_pad, w, ngb, metric)
        assign = jnp.where(jnp.arange(capb, dtype=jnp.int32) < nl,
                           assign, jnp.int32(ngb))
        perm = jnp.argsort(assign, stable=True).astype(jnp.int32)
    valid_s = perm < nl

    safe = jnp.minimum(perm, n - 1)
    xs = jnp.where(valid_s[:, None], xt[safe], jnp.zeros((), xt.dtype))
    slot_s = jnp.where(valid_s, perm, -1)
    lex_s = jnp.where(valid_s, lex_d[safe], _BIG32)

    # block (64-row window) centroids -> probed neighbor blocks
    w = valid_s.astype(jnp.float32).reshape(ngb, GROUP)
    cent = (jnp.sum(xs.astype(jnp.float32).reshape(ngb, GROUP, d) * w[..., None],
                    axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1.0)[:, None])
    # selection-only (neighbor-block routing): bf16 operands suffice
    cdots = jnp.dot(cent.astype(jnp.bfloat16), cent.astype(jnp.bfloat16).T,
                    preferred_element_type=jnp.float32)
    if metric == "l2":
        c2 = jnp.sum(cent * cent, axis=1)
        crank = c2[:, None] + c2[None, :] - 2.0 * cdots
    else:
        crank = -cdots
    dead = jnp.sum(w, axis=1) <= 0.0
    crank = jnp.where(dead[None, :], jnp.inf, crank)
    gi = jnp.arange(ngb, dtype=jnp.int32)
    crank = jnp.where(gi[:, None] == gi[None, :], -jnp.inf, crank)  # self first
    _, nb = jax.lax.top_k(-crank, min(probes, ngb))
    return xs, valid_s, lex_s, slot_s, nb.astype(jnp.int32)


# ---------------------------------------------------------------------------
# block scoring: forward adjacency for one chunk of blocks
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("metric", "deg", "csel"),
    donate_argnums=(0, 1),
)
def _knn_chunk(adj, dist, xs, valid_s, lex_s, slot_s, nb_chunk, g0, *,
               metric, deg, csel):
    """Scores one chunk of ``G`` blocks against their probed neighbor blocks
    and scatters the heuristic-selected forward adjacency by slot.

    ``xs`` [capb, d] bf16 cluster-major rows, ``valid_s``/``lex_s``/``slot_s``
    [capb] row metadata in the same order, ``nb_chunk`` [G, P] probed block
    ids per chunk block, ``g0`` first block index. ``adj``/``dist``
    [capb + 1, deg] accumulate in SLOT space (trash row last).
    """
    capb, d = xs.shape
    G, P = nb_chunk.shape
    PC = P * GROUP

    rows = jax.lax.dynamic_slice_in_dim(xs, g0 * GROUP, G * GROUP)
    rows = rows.reshape(G, GROUP, d)
    xsb = xs.reshape(capb // GROUP, GROUP, d)
    pool = xsb[nb_chunk].reshape(G, PC, d)

    # selection-only (candidate edges; the query path re-scores results in
    # f32): default matmul precision suffices
    dots = jnp.einsum("gkd,gcd->gkc", rows, pool,
                      preferred_element_type=jnp.float32)
    if metric == "l2":
        rsq = jnp.sum(rows.astype(jnp.float32) ** 2, axis=-1)
        csq = jnp.sum(pool.astype(jnp.float32) ** 2, axis=-1)
        rank = _rank_from_dots(dots, rsq, csq, metric)
    else:
        rank = _rank_from_dots(dots, None, None, metric)

    # candidate metadata in sorted-row space
    pos_c = (nb_chunk[:, :, None] * GROUP
             + jnp.arange(GROUP, dtype=jnp.int32)[None, None, :]).reshape(G, PC)
    row_pos = (g0 * GROUP + jnp.arange(G * GROUP, dtype=jnp.int32)).reshape(G, GROUP)
    cvalid = jnp.take(valid_s, pos_c)  # [G, PC]
    self_mask = pos_c[:, None, :] == row_pos[:, :, None]
    rank = jnp.where(cvalid[:, None, :] & ~self_mask, rank, jnp.inf)

    lex_pool = jnp.take(lex_s, pos_c)  # [G, PC]
    clex = jnp.broadcast_to(lex_pool[:, None, :], rank.shape)
    cidx = jnp.broadcast_to(
        jnp.arange(PC, dtype=jnp.int32)[None, None, :], rank.shape)
    rank_s, _lex_sd, cidx_s = jax.lax.sort((rank, clex, cidx), num_keys=2,
                                           dimension=2)
    ncand = min(csel, PC)
    top_rank = rank_s[..., :ncand]
    top_cidx = cidx_s[..., :ncand]

    # ---- spread candidates: each probed block's best row. A dense natural
    # cluster fills the whole nearest-``csel`` shortlist with intra-cluster
    # rows, so the diversity heuristic never SEES a cross-cluster candidate
    # and layer 0 degenerates into disconnected islands (measured: edge
    # recall 0.98 but beam recall stuck at 0.68 on the 1000-cluster bench
    # corpus). One guaranteed candidate per probed block restores an
    # outbound direction toward every nearby cluster; the heuristic then
    # keeps the diverse ones.
    rb = rank.reshape(G, GROUP, P, GROUP)
    sp_rank = jnp.min(rb, axis=3)  # [G, K, P]
    sp_cidx = (jnp.argmin(rb, axis=3).astype(jnp.int32)
               + jnp.arange(P, dtype=jnp.int32)[None, None, :] * GROUP)
    cat_rank = jnp.concatenate([top_rank, sp_rank], axis=2)  # [G, K, C']
    cat_cidx = jnp.concatenate([top_cidx, sp_cidx], axis=2)
    cat_lex = jnp.take_along_axis(
        jnp.broadcast_to(lex_pool[:, None, :], rank.shape), cat_cidx, axis=2)
    cat_rank, _cl, cat_cidx = jax.lax.sort(
        (cat_rank, cat_lex, cat_cidx), num_keys=2, dimension=2)
    C4 = cat_cidx.shape[-1]
    io = jnp.arange(C4, dtype=jnp.int32)
    dup = jnp.any(
        (cat_cidx[..., None, :] == cat_cidx[..., :, None])
        & (io[None, :] < io[:, None]), axis=-1)
    top_rank = jnp.where(dup, jnp.inf, cat_rank)
    top_cidx = jnp.where(dup, 0, cat_cidx)

    top_pos = jnp.take_along_axis(
        jnp.broadcast_to(pos_c[:, None, :], (G, GROUP, PC)), top_cidx, axis=2)
    top_slot = jnp.where(dup | ~jnp.isfinite(top_rank), -1,
                         jnp.take(slot_s, top_pos))

    if HEURISTIC_SELECTION:
        cvecs = jnp.take_along_axis(
            pool[:, None, :, :], top_cidx[..., None], axis=2)  # [G, K, C, d]
        pdots = jnp.einsum("gkcd,gked->gkce", cvecs, cvecs,  # selection-only
                           preferred_element_type=jnp.float32)
        if metric == "l2":
            cs2 = jnp.sum(cvecs.astype(jnp.float32) ** 2, axis=-1)
            pr = _rank_from_dots(pdots, cs2, cs2, metric)
        else:
            pr = _rank_from_dots(pdots, None, None, metric)
        sel_slot, sel_d = _heuristic_select(top_slot, top_rank, pr, deg)
    else:
        sel_slot = jnp.where(jnp.isfinite(top_rank[..., :deg]),
                             top_slot[..., :deg], -1)
        sel_d = top_rank[..., :deg]

    # scatter by slot (invalid rows land in the trash row)
    row_slot = jax.lax.dynamic_slice_in_dim(slot_s, g0 * GROUP, G * GROUP)
    tgt = jnp.where(row_slot >= 0, row_slot, capb).astype(jnp.int32)
    adj = adj.at[tgt].set(sel_slot.reshape(G * GROUP, deg))
    dist = dist.at[tgt].set(sel_d.reshape(G * GROUP, deg))
    return adj, dist


# ---------------------------------------------------------------------------
# reciprocal edges + prune (one segment program per layer)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("metric", "deg"),
    donate_argnums=(0, 1),
)
def _reciprocal_pass(adj, dist, xt, lex_rank, nl, *, metric, deg):
    """Union each node's forward row with its capped incoming edges, rescore,
    and diversity-prune back to ``deg`` — the add-then-prune semantics of
    hnsw.rs:220-236 as one batched pass. ``adj``/``dist`` [cap + 1, deg] in
    slot space (rows >= nl are -1/inf); returns the pruned ``adj``."""
    cap = adj.shape[0] - 1
    n = xt.shape[0]
    src = jnp.broadcast_to(
        jnp.arange(cap, dtype=jnp.int32)[:, None], (cap, deg)).reshape(-1)
    dst = adj[:cap].reshape(-1)
    dvals = dist[:cap].reshape(-1)
    valid = (dst >= 0) & (src < nl)
    E = dst.shape[0]

    dkey = jnp.where(valid, dst, cap)
    slex = jnp.where(valid, lex_rank[jnp.minimum(src, n - 1)], _BIG32)
    dkey, dist_s, _, src_s = jax.lax.sort(
        (dkey, jnp.where(valid, dvals, jnp.inf), slex, src), num_keys=3)
    iota = jnp.arange(E, dtype=jnp.int32)
    first = jnp.concatenate([jnp.array([True]), dkey[1:] != dkey[:-1]])
    seg_start = jax.lax.cummax(jnp.where(first, iota, 0))
    seg_rank = iota - seg_start
    keep = (dkey < cap) & (seg_rank < deg)

    inc = jnp.full((cap + 1, deg), -1, jnp.int32)
    inc = inc.at[jnp.where(keep, dkey, cap),
                 jnp.minimum(seg_rank, deg - 1)].set(jnp.where(keep, src_s, -1))

    rows_all = jnp.arange(cap, dtype=jnp.int32)
    cand_all = jnp.concatenate([adj[:cap], inc[:cap]], axis=1)  # [cap, 2*deg]
    live = rows_all < nl

    chunk = 4096
    pad = (-cap) % chunk
    rows_p = jnp.pad(rows_all, (0, pad), constant_values=0)
    live_p = jnp.pad(live, (0, pad))
    cand_p = jnp.pad(cand_all, ((0, pad), (0, 0)), constant_values=-1)

    def prune_chunk(args):
        rows_c, live_c, cand_c = args
        base = xt[jnp.minimum(rows_c, n - 1)]
        cvalid = (cand_c >= 0) & (cand_c != rows_c[:, None]) & live_c[:, None]
        csafe = jnp.minimum(jnp.maximum(cand_c, 0), n - 1)
        cd = jnp.where(cvalid, _rank_block(xt[csafe], base, metric), jnp.inf)
        clex = jnp.where(cvalid, lex_rank[csafe], _BIG32)
        cd, clex_s, cand_s = jax.lax.sort(
            (cd, clex, jnp.where(cvalid, cand_c, -1)), num_keys=2, dimension=1)
        dup = jnp.concatenate(
            [jnp.zeros((cand_s.shape[0], 1), bool),
             (cand_s[:, 1:] == cand_s[:, :-1]) & (cand_s[:, 1:] >= 0)], axis=1)
        cd = jnp.where(dup, jnp.inf, cd)
        cand_s = jnp.where(dup, -1, cand_s)
        if HEURISTIC_SELECTION:
            cvecs = xt[jnp.minimum(jnp.maximum(cand_s, 0), n - 1)]
            pdots = jnp.einsum("rcd,red->rce", cvecs, cvecs,  # selection-only
                               preferred_element_type=jnp.float32)
            if metric == "l2":
                cs2 = jnp.sum(cvecs.astype(jnp.float32) ** 2, axis=-1)
                pr = _rank_from_dots(pdots, cs2, cs2, metric)
            else:
                pr = _rank_from_dots(pdots, None, None, metric)
            chosen, _ = _heuristic_select(cand_s, cd, pr, deg)
            return chosen
        return cand_s[:, :deg]

    shaped = (rows_p.reshape(-1, chunk), live_p.reshape(-1, chunk),
              cand_p.reshape(-1, chunk, cand_all.shape[1]))
    pruned = jax.lax.map(prune_chunk, shaped).reshape(-1, deg)[:cap]
    return jnp.where(live[:, None], pruned, -1)


# ---------------------------------------------------------------------------
# per-layer driver + full build
# ---------------------------------------------------------------------------


def _layer_adjacency(xt, lex_d, nl: int, deg: int, metric: str):
    """Forward+reciprocal adjacency for the layer whose node set is slots
    [0, nl). Returns a [nl, deg] int32 device array (-1 padded)."""
    if nl <= 1:
        return jnp.full((max(nl, 1), deg), -1, jnp.int32)[:nl]
    # bucket the capacity: a pow2 block count with a floor, so the many tiny
    # upper layers share ONE compiled shape set instead of one per layer
    ngb = max(_next_pow2(-(-nl // GROUP)), MIN_NGB)
    capb = ngb * GROUP
    probes = min(PROBES, ngb)

    xs, valid_s, lex_s, slot_s, nb = _layer_setup(
        xt, lex_d, jnp.int32(nl), ngb=ngb, probes=probes, metric=metric)
    nb = np.asarray(nb)  # host-sliced per chunk below

    adj = jnp.full((capb + 1, deg), -1, jnp.int32)
    dist = jnp.full((capb + 1, deg), jnp.inf, jnp.float32)
    csel = 2 * deg
    G = min(CHUNK_BLOCKS, ngb)
    for g0 in range(0, ngb, G):
        adj, dist = _knn_chunk(
            adj, dist, xs, valid_s, lex_s, slot_s, nb[g0 : g0 + G],
            jnp.int32(g0), metric=metric, deg=deg, csel=csel)
    del xs

    adj = _reciprocal_pass(adj, dist, xt, lex_d, jnp.int32(nl),
                           metric=metric, deg=deg)
    return adj[:nl]


def bulk_build_knn(metric: str, params: dict, ids, vectors=None, *,
                   x_device=None) -> BulkGraph:
    """Builds a full BulkGraph via cluster-blocked kNN assembly (module
    docstring). Drop-in for ``hnsw_build.bulk_build``."""
    if x_device is not None:
        n, d = int(x_device.shape[0]), int(x_device.shape[1])
    else:
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
    max_level = params["max_level"]
    m, m0 = params["m"], params["m0"]

    ids_sorted, order, levels, lex_rank, lmax, up_index, cap_up = _prep_order(
        ids, max_level, n)

    if x_device is not None:
        xd = x_device[jnp.asarray(order.astype(np.int32))]
    else:
        from ..ops.transport import put_f32_matrix

        xd = put_f32_matrix(vectors[order])
    xt = xd.astype(jnp.bfloat16)
    lex_d = jnp.asarray(lex_rank)

    debug = bool(os.environ.get("VETTORE_BUILD_DEBUG"))
    import time as _time

    a0 = jnp.full((n + 1, m0), -1, jnp.int32)
    up_adj = jnp.full((cap_up + 1, max(lmax, 1), m), -1, jnp.int32)
    for l in range(0, lmax + 1):
        nl = int(np.sum(levels >= l))
        if nl <= 1:
            break
        deg = m0 if l == 0 else m
        t0 = _time.perf_counter() if debug else 0.0
        adj_l = _layer_adjacency(xt, lex_d, nl, deg, metric)
        if debug:
            jax.block_until_ready(adj_l)
            print(f"[knn-build] layer {l}: nl={nl} "
                  f"{_time.perf_counter() - t0:.2f}s", flush=True)
        if l == 0:
            a0 = a0.at[:nl].set(adj_l)
        else:
            up_adj = up_adj.at[:nl, l - 1].set(adj_l)

    jax.block_until_ready((a0, up_adj))
    return BulkGraph(
        ids=ids_sorted, n=n, m=m, m0=m0, lmax=lmax, metric=metric,
        x=xd, a0=a0[:n], up_index=jnp.asarray(up_index),
        up_adj=up_adj[:cap_up] if cap_up else up_adj[:1],
        lex_rank=lex_d, entry_slot=jnp.int32(0),
        entry_level=jnp.int32(int(levels[0]) if n else 0),
        levels=levels,
    )
