"""Mesh-sharded adaptive pipelines: funnel, quantized, MaxSim, hybrid rerank.

SURVEY §5.8: collections larger than one chip shard across a mesh. Round 2
sharded only the index ``search`` path; these pipelines shard the adaptive
modes — the ones that most need the mesh's memory (the scan cache's vector /
sign / token blocks are row-sharded).

Design: every per-shard stage reuses the single-chip kernels
(ops/pipeline, ops/select, ops/maxsim) on the shard's local rows; only
fixed-size ``(rank, slot, raw)`` candidate triples cross the interconnect between stages
(``all_gather`` + multi-key sort), never vectors. Because the scan cache is
lex-sorted, the global slot IS the lex rank, so the merge's (rank, slot)
sort preserves the reference's deterministic (rank, id) tie-break
(search.rs:23-29) across chips.

Stage exactness: a member of the global top-C at any stage is necessarily in
the top-C of its own shard, so per-shard ``exact_top_c`` + global merge
selects exactly the single-chip candidate set — sharded results EQUAL the
single-chip pipelines bit-for-bit (modulo each query's ``ok`` flag, which is
the AND over shards).

Mesh axes follow parallel/mesh.py: blocks shard over ``shard``; query
batches are data-parallel over ``data``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops import maxsim as maxsim_ops
from ..ops import pipeline as pipe
from ..ops.select import exact_top_c
from .mesh import program_cache

_BIG32 = 2**31 - 1


# ---------------------------------------------------------------------------
# in-shard_map helpers
# ---------------------------------------------------------------------------


def _merge_topc(rank_loc, gslots_loc, c):
    """Merges per-shard candidate sets over the interconnect: [B, C] (rank asc, global
    slot) per shard -> global best-C, replicated. Invalid = rank +inf."""
    r = jax.lax.all_gather(rank_loc, "shard", axis=1, tiled=True)  # [B, S*C]
    s = jax.lax.all_gather(gslots_loc, "shard", axis=1, tiled=True)
    key_s = jnp.where(jnp.isfinite(r), s, _BIG32)
    r2, _, s2 = jax.lax.sort((r, key_s, s), num_keys=2, dimension=1)
    return r2[:, :c], jnp.where(jnp.isfinite(r2[:, :c]), s2[:, :c], -1)


def _merge_topk_raw(rank_loc, raw_loc, gslots_loc, k):
    """Final merge carrying raw metric values alongside the rank keys."""
    r = jax.lax.all_gather(rank_loc, "shard", axis=1, tiled=True)
    w = jax.lax.all_gather(raw_loc, "shard", axis=1, tiled=True)
    s = jax.lax.all_gather(gslots_loc, "shard", axis=1, tiled=True)
    key_s = jnp.where(jnp.isfinite(r), s, _BIG32)
    r2, _, s2, w2 = jax.lax.sort((r, key_s, s, w), num_keys=2, dimension=1)
    return (s2[:, :k], w2[:, :k], r2[:, :k])


def _localize(gslots, gvalid, off, n_loc):
    """Splits a replicated global candidate set into this shard's members:
    local slots (0 where foreign) + membership mask."""
    mine = gvalid & (gslots >= off) & (gslots < off + n_loc)
    return jnp.where(mine, gslots - off, 0), mine


def _all_ok(ok):
    """ANDs a per-shard [B] bool over the shard axis (replicated result)."""
    return jax.lax.psum(ok.astype(jnp.int32), "shard") == jax.lax.psum(
        jnp.ones((), jnp.int32), "shard"
    )


def _shard_count(mesh):
    return mesh.shape["shard"]


# ---------------------------------------------------------------------------
# sharded pipelines
# ---------------------------------------------------------------------------


@program_cache
def _funnel_topk_program(mesh, metric, stages, count, limit, n_loc, full_d):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("shard", None), P("shard"), P("data", None)),
        out_specs=(P("data", None), P("data", None), P("data", None), P("data")),
        check_vma=False,
    )
    def step(x_loc, valid_loc, q):
        off = jax.lax.axis_index("shard") * n_loc
        rank, finite = pipe._rank_full(x_loc, valid_loc, q, metric=metric,
                                       dims=stages[0])
        lslots, lkeys, sel_ok = exact_top_c(rank, None, c=count)
        ok = finite & sel_ok
        gslots = jnp.where(lslots >= 0, lslots + off, -1)
        g_rank, g_slots = _merge_topc(lkeys, gslots, count)
        for dims in list(stages[1:]) + [full_d]:
            lsl, mine = _localize(g_slots, jnp.isfinite(g_rank), off, n_loc)
            raw, rank_c, f = pipe._subset_raw_rank(x_loc, lsl, mine, q,
                                                   metric=metric, dims=dims)
            ok = ok & f
            if dims == full_d:
                top, raws, ranks = _merge_topk_raw(
                    jnp.where(mine, rank_c, jnp.inf),
                    raw,
                    jnp.where(mine, g_slots, -1),
                    limit,
                )
                return top, raws, ranks, _all_ok(ok)
            g_rank, g_slots = _merge_topc(
                jnp.where(mine, rank_c, jnp.inf),
                jnp.where(mine, g_slots, -1),
                count,
            )
        raise AssertionError("unreachable")

    return step


def sharded_funnel_topk(mesh, x, valid, queries, *, metric, stages, count, limit):
    """Sharded Matryoshka funnel + exact rerank. Inputs sharded like
    parallel/mesh.sharded_search; returns (slots [B, limit], raws, ranks,
    ok [B]) with slot -1 pads. Equals pipe.funnel_pipeline_batch."""
    n_loc = x.shape[0] // _shard_count(mesh)
    return _funnel_topk_program(mesh, metric, tuple(stages), count, limit,
                                n_loc, int(x.shape[1]))(x, valid, queries)


@program_cache
def _quantized_topk_program(mesh, metric, count, limit, d, n_loc, full_d):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("shard", None), P("shard", None), P("shard"), P("data", None)),
        out_specs=(P("data", None), P("data", None), P("data", None), P("data")),
        check_vma=False,
    )
    def step(x_loc, signs_loc, valid_loc, q):
        off = jax.lax.axis_index("shard") * n_loc
        qs = pipe.query_signs(q[:, :d])
        # composite-int selection per shard (local ties impossible); the
        # global (ham, slot) merge stays exact because local slot order is
        # global slot order within each shard
        lslots, lkeys, sel_ok = pipe._hamming_slots(
            signs_loc, valid_loc, qs, count=count, d=d)
        gslots = jnp.where(lslots >= 0, lslots + off, -1)
        g_rank, g_slots = _merge_topc(lkeys, gslots, count)
        lsl, mine = _localize(g_slots, jnp.isfinite(g_rank), off, n_loc)
        raw, rank_f, finite = pipe._subset_raw_rank(x_loc, lsl, mine, q,
                                                    metric=metric, dims=full_d)
        top, raws, ranks = _merge_topk_raw(
            jnp.where(mine, rank_f, jnp.inf), raw,
            jnp.where(mine, g_slots, -1), limit,
        )
        return top, raws, ranks, _all_ok(sel_ok & finite)

    return step


def sharded_quantized_topk(mesh, x, signs, valid, queries, *, metric, count,
                           limit, d):
    """Sharded sign-bit Hamming candidates + exact rerank. Equals
    pipe.quantized_pipeline_batch."""
    n_loc = x.shape[0] // _shard_count(mesh)
    return _quantized_topk_program(mesh, metric, count, limit, d, n_loc,
                                   int(x.shape[1]))(x, signs, valid, queries)


@program_cache
def _funnel_candidates_program(mesh, metric, stages, count, n_loc):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("shard", None), P("shard"), P("data", None)),
        out_specs=(P("data", None), P("data", None), P("data")),
        check_vma=False,
    )
    def step(x_loc, valid_loc, q):
        off = jax.lax.axis_index("shard") * n_loc
        rank, finite = pipe._rank_full(x_loc, valid_loc, q, metric=metric,
                                       dims=stages[0])
        lslots, lkeys, sel_ok = exact_top_c(rank, None, c=count)
        ok = finite & sel_ok
        gslots = jnp.where(lslots >= 0, lslots + off, -1)
        g_rank, g_slots = _merge_topc(lkeys, gslots, count)
        for dims in stages[1:]:
            lsl, mine = _localize(g_slots, jnp.isfinite(g_rank), off, n_loc)
            raw, rank_c, f = pipe._subset_raw_rank(x_loc, lsl, mine, q,
                                                   metric=metric, dims=dims)
            ok = ok & f
            g_rank, g_slots = _merge_topc(
                jnp.where(mine, rank_c, jnp.inf),
                jnp.where(mine, g_slots, -1),
                count,
            )
        return g_slots, jnp.isfinite(g_rank), _all_ok(ok)

    return step


def sharded_funnel_candidates(mesh, x, valid, queries, *, metric, stages, count):
    """Funnel candidate stage only (hybrid generator): returns global
    (slots [B, C], slot_ok [B, C], ok [B]) replicated over shards, lex-sorted
    by construction. Equals pipe.funnel_candidates_batch + _sort_candidates
    (candidates come back (rank, slot)-sorted; the union re-sorts anyway)."""
    n_loc = x.shape[0] // _shard_count(mesh)
    return _funnel_candidates_program(mesh, metric, tuple(stages), count,
                                      n_loc)(x, valid, queries)


@program_cache
def _quantized_candidates_program(mesh, count, d, n_loc):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("shard", None), P("shard"), P("data", None)),
        out_specs=(P("data", None), P("data", None), P("data")),
        check_vma=False,
    )
    def step(signs_loc, valid_loc, q):
        off = jax.lax.axis_index("shard") * n_loc
        qs = pipe.query_signs(q[:, :d])
        lslots, lkeys, sel_ok = pipe._hamming_slots(
            signs_loc, valid_loc, qs, count=count, d=d)
        gslots = jnp.where(lslots >= 0, lslots + off, -1)
        g_rank, g_slots = _merge_topc(lkeys, gslots, count)
        return g_slots, jnp.isfinite(g_rank), _all_ok(sel_ok)

    return step


def sharded_quantized_candidates(mesh, signs, valid, queries, *, count, d):
    """Hamming candidate stage only (hybrid generator)."""
    n_loc = signs.shape[0] // _shard_count(mesh)
    return _quantized_candidates_program(mesh, count, d, n_loc)(
        signs, valid, queries)


@program_cache
def _maxsim_topk_program(mesh, metric, limit, chunk_loc, n_loc):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("shard", None, None), P("shard"), P("shard"),
                  P("data", None, None), P("data", None)),
        out_specs=(P("data", None), P("data", None), P("data")),
        check_vma=False,
    )
    def step(tok_loc, cnt_loc, val_loc, qt, qm):
        off = jax.lax.axis_index("shard") * n_loc
        slots, scores, ok = maxsim_ops.maxsim_full_topk_batch(
            tok_loc, cnt_loc, val_loc, qt, qm,
            metric=metric, limit=min(limit, n_loc), chunk=chunk_loc,
        )
        gsl = jnp.where(slots >= 0, slots + off, _BIG32)
        s = jax.lax.all_gather(scores, "shard", axis=1, tiled=True)
        g = jax.lax.all_gather(gsl, "shard", axis=1, tiled=True)
        key_slot = jnp.where(s > -jnp.inf, g, _BIG32)
        _, _, g2, s2 = jax.lax.sort((-s, key_slot, g, s), num_keys=2, dimension=1)
        k = min(limit, s2.shape[1])
        top = jnp.where(s2[:, :k] > -jnp.inf, g2[:, :k], -1)
        return top, s2[:, :k], _all_ok(ok)

    return step


def sharded_maxsim_topk(mesh, tokens, counts, valid, qtok, qmask, *, metric,
                        limit, chunk):
    """Sharded full-corpus MaxSim: per-shard chunked streaming scan
    (ops/maxsim.maxsim_full_topk_batch) + (score desc, slot asc) interconnect merge.
    Returns (slots [B, limit] (-1 pads), scores, ok [B])."""
    n_loc = tokens.shape[0] // _shard_count(mesh)
    return _maxsim_topk_program(mesh, metric, limit, min(chunk, n_loc),
                                n_loc)(tokens, counts, valid, qtok, qmask)


@program_cache
def _subset_maxsim_program(mesh, metric, limit, n_loc):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("shard", None, None), P("shard"), P("data", None),
                  P("data", None), P("data", None, None), P("data", None)),
        out_specs=(P("data", None), P("data", None), P("data")),
        check_vma=False,
    )
    def step(tok_loc, cnt_loc, cs, cok_, qt, qm):
        off = jax.lax.axis_index("shard") * n_loc
        lsl, mine = _localize(cs, cok_, off, n_loc)
        top, sc, ok = maxsim_ops.maxsim_subset_topk_batch(
            tok_loc, cnt_loc, lsl, mine, qt, qm, metric=metric, limit=limit,
        )
        gsl = jnp.where(top >= 0, top + off, _BIG32)
        s = jax.lax.all_gather(sc, "shard", axis=1, tiled=True)
        g = jax.lax.all_gather(gsl, "shard", axis=1, tiled=True)
        key_slot = jnp.where(s > -jnp.inf, g, _BIG32)
        _, _, g2, s2 = jax.lax.sort((-s, key_slot, g, s), num_keys=2, dimension=1)
        k = min(limit, s2.shape[1])
        tops = jnp.where(s2[:, :k] > -jnp.inf, g2[:, :k], -1)
        return tops, s2[:, :k], _all_ok(ok)

    return step


def sharded_subset_maxsim(mesh, tokens, counts, cslots, cok, qtok, qmask, *,
                          metric, limit):
    """Sharded MaxSim rerank of a replicated global candidate set (the hybrid
    rerank stage): each shard scores its members, merge by (score desc,
    slot asc). Equals ops/maxsim.maxsim_subset_topk_batch."""
    n_loc = tokens.shape[0] // _shard_count(mesh)
    return _subset_maxsim_program(mesh, metric, limit, n_loc)(
        tokens, counts, cslots, cok, qtok, qmask)


@program_cache
def _subset_rerank_program(mesh, metric, limit, n_loc, full_d):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("shard", None), P("data", None), P("data", None),
                  P("data", None)),
        out_specs=(P("data", None), P("data", None), P("data", None), P("data")),
        check_vma=False,
    )
    def step(x_loc, cs, cok_, q):
        off = jax.lax.axis_index("shard") * n_loc
        lsl, mine = _localize(cs, cok_, off, n_loc)
        raw, rank_f, finite = pipe._subset_raw_rank(x_loc, lsl, mine, q,
                                                    metric=metric, dims=full_d)
        top, raws, ranks = _merge_topk_raw(
            jnp.where(mine, rank_f, jnp.inf), raw,
            jnp.where(mine, lsl + off, -1), limit,
        )
        return top, raws, ranks, _all_ok(finite)

    return step


def sharded_subset_rerank(mesh, x, cslots, cok, queries, *, metric, limit):
    """Sharded exact full-dims rerank of a replicated candidate set (hybrid
    exact rerank). Equals pipe.rerank_batch."""
    n_loc = x.shape[0] // _shard_count(mesh)
    return _subset_rerank_program(mesh, metric, limit, n_loc,
                                  int(x.shape[1]))(x, cslots, cok, queries)
