"""Fused on-device adaptive search pipelines (batch-first).

The reference's funnel / quantized / hybrid modes chain batched NIF scans with
candidate lists flowing through Elixir
(/root/reference/lib/vettore/collection.ex:558-713). Here each whole pipeline
— stage scans, candidate selection, and the exact rerank — compiles to ONE
XLA program per query batch, so candidates never leave the device.

Design (per-query vmaps with a ``lax.top_k(candidates)`` over 1M rows
would be slower than the brute-force scan they are meant to beat):

* **batch-first**: every stage works on the full ``[B, N]`` score matrix;
* **candidate selection via ops/select.exact_top_c** — recursive group-min
  descent (its first level is a 64-row group cover), exact with (rank, id)
  ties and far cheaper than a full ``lax.top_k`` at candidates=500;
* **Hamming as a matmul**: sign bits expand once to a device-resident ±1
  int8 block; ``hamming = (d - s·q)/2`` is then one int8 matmul (int32
  accumulate) — bit-identical to XOR+popcount over the packed words
  (distances.rs:426-437).

Invariant: the caller's block is LEX-SORTED — slot order equals id order
(``_VectorCache`` stores records sorted by id, invalid/pad slots last), so
slot order is the (rank, id) tie-break key (search.rs:23-29).

All shapes are static: candidate counts and limits are bucketed by the
caller, padded positions carry +inf rank / False validity. Every pipeline
returns a per-query ``ok`` flag; False (overflow or tie spill past the
selection slack) sends that query to the host oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .select import exact_top_c, exact_top_c_unique_int

_BIG32 = 2**31 - 1


def _composite_bits(n: int, d: int):
    """Slot-bit width for distinct (hamming << slot_bits) | slot composite
    int32 keys, or None when the address space doesn't fit 31 bits (then the
    float path with tie-spill detection applies)."""
    slot_bits = max(1, (n - 1).bit_length())
    if d.bit_length() + slot_bits <= 31:
        return slot_bits
    return None


# ---------------------------------------------------------------------------
# scoring stages
# ---------------------------------------------------------------------------


def _rank_full(x, valid, queries, *, metric, dims):
    """Rank distances of every row vs every query over the first ``dims``
    columns: [B, N] ascending-is-better, +inf on invalid rows. Returns
    (rank, finite [B]). Cosine renormalizes over the prefix (search.rs:56-58
    scores prefixes with the true cosine)."""
    sub = x[:, :dims].astype(jnp.float32)
    q = queries[:, :dims].astype(jnp.float32)
    mm = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
    if metric in ("cosine", "inner_product", "negative_inner_product"):
        dots = mm(q, sub.T)  # [B, N]
        if metric == "cosine":
            xn = jnp.sqrt(jnp.sum(sub * sub, axis=1))
            qn = jnp.sqrt(jnp.sum(q * q, axis=1))
            denom = qn[:, None] * xn[None, :]
            sim = jnp.where(denom > 0.0, dots / denom, 0.0)
            rank = 1.0 - jnp.clip(sim, -1.0, 1.0)
        elif metric == "inner_product":
            rank = -dots
        else:
            rank = dots  # negative_inner_product: raw = -dot, rank = raw
    elif metric in ("l2", "l2_squared"):
        xsq = jnp.sum(sub * sub, axis=1)
        qsq = jnp.sum(q * q, axis=1)
        sq = jnp.maximum(xsq[None, :] - 2.0 * mm(q, sub.T) + qsq[:, None], 0.0)
        rank = jnp.sqrt(sq) if metric == "l2" else sq
    else:
        raise ValueError(f"unsupported pipeline metric {metric}")
    finite = jnp.all(jnp.isfinite(rank) | ~valid[None, :], axis=1)
    return jnp.where(valid[None, :], rank, jnp.inf), finite


def _subset_raw_rank(x, slots, slot_ok, queries, *, metric, dims):
    """Raw + rank for per-query candidate subsets. ``slots`` [B, C] (−1/pad
    allowed where ``slot_ok`` False). Returns (raw [B, C], rank [B, C],
    finite [B])."""
    rows = x[jnp.maximum(slots, 0)][:, :, :dims].astype(jnp.float32)  # [B, C, d]
    q = queries[:, :dims].astype(jnp.float32)
    if metric in ("cosine", "inner_product", "negative_inner_product"):
        dots = jnp.einsum("bcd,bd->bc", rows, q,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
        if metric == "cosine":
            # true cosine at every width — the adaptive pipelines mirror
            # vector_top_k, which scores with distances::cosine even at full
            # dims (search.rs:56-58), unlike the flat index's plain dot
            xn = jnp.sqrt(jnp.sum(rows * rows, axis=2))
            qn = jnp.sqrt(jnp.sum(q * q, axis=1))
            denom = qn[:, None] * xn
            raw = jnp.clip(jnp.where(denom > 0.0, dots / denom, 0.0), -1.0, 1.0)
            rank = 1.0 - raw
        elif metric == "inner_product":
            raw = dots
            rank = -dots
        else:
            raw = -dots
            rank = raw
    elif metric in ("l2", "l2_squared"):
        diff = rows - q[:, None, :]
        sq = jnp.sum(diff * diff, axis=2)
        raw = jnp.sqrt(sq) if metric == "l2" else sq
        rank = raw
    else:
        raise ValueError(f"unsupported pipeline metric {metric}")
    finite = jnp.all(jnp.isfinite(raw) | ~slot_ok, axis=1)
    rank = jnp.where(slot_ok, rank, jnp.inf)
    return raw, rank, finite


def _subset_full_cosine_raw(raw, metric):
    """Full-width cosine subset raw uses the plain dot (see above)."""
    return raw


def _top_limit(slots, raw, rank, *, limit):
    """Final (rank, slot==lex) selection over a small candidate axis.
    Returns (top_slots [B, limit], raws, ranks) best-first."""
    key_slot = jnp.where(jnp.isfinite(rank), slots, _BIG32)
    rank_s, _, slot_s, raw_s = jax.lax.sort(
        (rank, key_slot, slots, raw), num_keys=2, dimension=1)
    return slot_s[:, :limit], raw_s[:, :limit], rank_s[:, :limit]


def _sort_candidates(slots, c):
    """Candidate sets stay lex-sorted (ascending slot) between stages; pads
    (-1) move to the end as invalid."""
    key = jnp.where(slots >= 0, slots, _BIG32)
    key = jax.lax.sort(key, dimension=1)
    ok = key < _BIG32
    return jnp.where(ok, key, 0), ok


# ---------------------------------------------------------------------------
# sign-bit expansion + matmul Hamming
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("d",))
def signs_from_bits(bits, *, d):
    """Expands packed sign words [N, W] u32 into a ±1 int8 block [N, d] —
    the matmul-ready quantized representation (bit i%32 of word i//32, the
    pack_signs_u32 layout)."""
    n, w = bits.shape
    expanded = (bits[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)[None, None, :]) & 1
    flat = expanded.reshape(n, w * 32)[:, :d]
    return (flat.astype(jnp.int8) * 2 - 1).astype(jnp.int8)


@jax.jit
def query_signs(queries):
    """±1 int8 signs of prepared queries (>= 0 rule, distances.rs:413-423)."""
    return jnp.where(queries >= 0.0, jnp.int8(1), jnp.int8(-1))


def _hamming_rank(signs, valid, qsigns, *, d):
    """[B, N] Hamming distances via one int8 matmul:
    ham = (d - s·q) / 2, exactly the packed XOR+popcount value."""
    dots = jax.lax.dot_general(
        qsigns, signs, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    ham = (d - dots) // 2
    return jnp.where(valid[None, :], ham.astype(jnp.float32), jnp.inf)


#: slots per group in the group-cover Hamming selection (one lane tile)
_GROUP = 64
#: i16 pad for invalid rows' Hamming (any real value is <= d < 16384)
_BIG16 = 32767
#: below this many rows the direct full-width composite pass is cheaper
_GROUP_COVER_MIN = 65536


def _sign_group_scan(signs, valid, qsigns, *, d):
    """One pass over the ±1 int8 block: ``(gmin [B, N/64] i32, ham16 [B, N]
    i16)`` — hamming = (d - s·q)/2 exactly (the packed XOR+popcount value,
    distances.rs:426-437), invalid rows pinned to ``_BIG16``. The product
    accumulates in int32 (the int8 tensor-core form) and narrows to the i16
    block the element pass gathers from (|dot| <= d < 16384)."""
    b, n = qsigns.shape[0], signs.shape[0]
    dots = jax.lax.dot_general(
        qsigns, signs, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    ham16 = ((d - dots) >> 1).astype(jnp.int16)
    ham16 = jnp.where(valid[None, :], ham16, jnp.int16(_BIG16))
    gmin = jnp.min(ham16.reshape(b, n // _GROUP, _GROUP), axis=2).astype(jnp.int32)
    return gmin, ham16


def _hamming_slots(signs, valid, qsigns, *, count, d):
    """Exact top-``count`` (hamming, slot) candidates per query.

    Hamming values are integers — at 1M rows hundreds of rows tie at the
    count-th value, so a float rank + slack-bounded selection degenerates to
    host fallbacks for ~97% of queries. Composite ``(ham << slot_bits) | slot``
    int32 keys are DISTINCT per valid row: selection is unconditionally
    exact and the slot low-bits implement the (rank, id) tie-break
    (search.rs:23-29; blocks are lex-sorted so slot order is id order).

    Large blocks take a two-level GROUP-COVER path: element keys are
    distinct, so at most ``count`` groups can hold any top-``count``
    element, and each such group's min element key is <= the count-th
    element key — selecting the ``count`` smallest ``(group_min_ham,
    group_index)`` composites (groups are slot-contiguous, so group index
    order IS min-slot order within equal hamming) provably covers all
    top-``count`` elements. The full [B, N] i32 composite never
    materializes: one i16 hamming block, a [B, N/64] group-min pass, and
    an element pass over the <= count covered groups.

    Returns ``(slots [B, count] i32 ascending-by-(ham, slot),
    ranks [B, count] f32 hamming (+inf pads), ok [B])``."""
    n = signs.shape[0]
    slot_bits = _composite_bits(n, d)
    if slot_bits is None:
        rank_h = _hamming_rank(signs, valid, qsigns, d=d)
        return exact_top_c(rank_h, None, c=count)
    b = qsigns.shape[0]
    ng = n // _GROUP
    gbits = max(1, (ng - 1).bit_length()) if ng else 0
    if (
        n >= _GROUP_COVER_MIN
        and n % _GROUP == 0
        and d < _BIG16 // 2
        and (d + 1).bit_length() + gbits <= 31
        and ng > count
    ):
        gmin, ham16 = _sign_group_scan(signs, valid, qsigns, d=d)
        # all-pad groups clamp to d + 1: still past every real hamming
        # (<= d) but shift-safe under the (d + 1)-bit guard above
        gmin = jnp.minimum(gmin, d + 1)  # [B, NG]
        gcomp = (gmin << gbits) | jnp.arange(ng, dtype=jnp.int32)[None, :]
        gslots, _gkeys = exact_top_c_unique_int(gcomp, c=count)
        gc = jnp.maximum(gslots, 0)
        sub = jnp.take_along_axis(
            ham16.reshape(b, ng, _GROUP), gc[:, :, None], axis=1)  # [B, count, 64]
        sub_slots = (
            gc[:, :, None] * _GROUP
            + jnp.arange(_GROUP, dtype=jnp.int32)[None, None, :]
        )
        comp = jnp.where(
            (sub < _BIG16) & (gslots >= 0)[:, :, None],
            (sub.astype(jnp.int32) << slot_bits) | sub_slots,
            _BIG32,
        ).reshape(b, count * _GROUP)
        _pos, keys = exact_top_c_unique_int(comp, c=count)
        # selection returns positions in ``comp`` (a gathered sub-block, not
        # slot-indexed) — the global slot is the key's low bits
        slots = jnp.where(keys < _BIG32, keys & ((1 << slot_bits) - 1), -1)
    else:
        dots = jax.lax.dot_general(
            qsigns, signs, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)
        ham = (d - dots) >> 1
        comp = (ham << slot_bits) | jnp.arange(n, dtype=jnp.int32)[None, :]
        comp = jnp.where(valid[None, :], comp, _BIG32)
        slots, keys = exact_top_c_unique_int(comp, c=count)
    ranks = jnp.where(keys < _BIG32, (keys >> slot_bits).astype(jnp.float32),
                      jnp.inf)
    return slots, ranks, jnp.ones(b, bool)


# ---------------------------------------------------------------------------
# pipelines (batched; single-query wrappers at the bottom)
# ---------------------------------------------------------------------------


def _stage1_candidates(x, valid, queries, *, metric, dims, count):
    """Stage-1 candidate selection: the true prefix-metric rank matrix, then
    the exact group-cover descent of ``exact_top_c`` (64-row group minima
    pick the covering groups, whose elements alone are ranked). Returns
    (slots [B, count] best-first, ok [B])."""
    rank, finite = _rank_full(x, valid, queries, metric=metric, dims=dims)
    slots, _, sel_ok = exact_top_c(rank, None, c=count)
    return slots, finite & sel_ok


@functools.partial(jax.jit, static_argnames=("metric", "stages", "count", "limit"))
def funnel_pipeline_batch(x, valid, queries, *, metric, stages, count, limit):
    """Matryoshka funnel: prefix stage + exact rerank, one dispatch.
    Returns (slots [B, limit], raws, ranks, ok [B])."""
    slots, ok = _stage1_candidates(x, valid, queries, metric=metric,
                                   dims=stages[0], count=count)
    slots, slot_ok = _sort_candidates(slots, count)
    for dims in stages[1:]:
        raw, rank_c, f = _subset_raw_rank(x, slots, slot_ok, queries,
                                          metric=metric, dims=dims)
        ok = ok & f
        # reference semantics: keep the best `count` per stage (with C ==
        # count this re-orders only; sets shrink when count > survivors)
        sel, _, _ = _top_limit(slots, raw, rank_c, limit=min(count, slots.shape[1]))
        slots, slot_ok = _sort_candidates(sel, count)
    raw, rank_f, f = _subset_raw_rank(x, slots, slot_ok, queries,
                                      metric=metric, dims=x.shape[1])
    ok = ok & f
    top, raws, ranks = _top_limit(slots, raw, rank_f, limit=limit)
    return top, raws, ranks, ok


@functools.partial(jax.jit, static_argnames=("metric", "count", "limit", "d"))
def quantized_pipeline_batch(x, signs, valid, queries, *, metric, count, limit, d):
    """Binary-quantized candidates (matmul Hamming) + exact rerank."""
    qs = query_signs(queries[:, :d])
    slots, _hams, sel_ok = _hamming_slots(signs, valid, qs, count=count, d=d)
    slots, slot_ok = _sort_candidates(slots, count)
    raw, rank_f, finite = _subset_raw_rank(x, slots, slot_ok, queries,
                                           metric=metric, dims=x.shape[1])
    top, raws, ranks = _top_limit(slots, raw, rank_f, limit=limit)
    return top, raws, ranks, sel_ok & finite


@functools.partial(jax.jit, static_argnames=("metric", "stages", "count"))
def funnel_candidates_batch(x, valid, queries, *, metric, stages, count):
    """Funnel stages only (hybrid generator): lex-sorted candidates.
    Returns (slots [B, C], slot_ok [B, C], ok [B])."""
    slots, ok = _stage1_candidates(x, valid, queries, metric=metric,
                                   dims=stages[0], count=count)
    slots, slot_ok = _sort_candidates(slots, count)
    for dims in stages[1:]:
        raw, rank_c, f = _subset_raw_rank(x, slots, slot_ok, queries,
                                          metric=metric, dims=dims)
        ok = ok & f
        sel, _, _ = _top_limit(slots, raw, rank_c, limit=min(count, slots.shape[1]))
        slots, slot_ok = _sort_candidates(sel, count)
    return slots, slot_ok, ok


@functools.partial(jax.jit, static_argnames=("count", "d"))
def quantized_candidates_batch(signs, valid, queries, *, count, d):
    """Hamming candidates only (hybrid generator)."""
    qs = query_signs(queries[:, :d])
    slots, _hams, sel_ok = _hamming_slots(signs, valid, qs, count=count, d=d)
    slots, slot_ok = _sort_candidates(slots, count)
    return slots, slot_ok, sel_ok


@jax.jit
def union_candidates(blocks):
    """Unions per-query candidate slot sets from several generators.

    ``blocks`` is a [B, C_total] int32 concatenation of generator outputs
    with ``_BIG32`` at invalid/pad positions. Returns lex-sorted
    ``(slots [B, C_total], ok [B, C_total])`` with duplicates and pads masked
    off — the device equivalent of the reference's union-by-id
    (collection.ex:617-629; first-seen order is irrelevant because every
    rerank re-sorts by (rank, id))."""
    key = jax.lax.sort(blocks, dimension=1)
    dup = jnp.concatenate(
        [jnp.zeros((key.shape[0], 1), bool), key[:, 1:] == key[:, :-1]], axis=1)
    ok = (key < _BIG32) & ~dup
    return jnp.where(ok, key, 0), ok


@functools.partial(jax.jit, static_argnames=("metric", "limit"))
def rerank_batch(x, slots, slot_ok, queries, *, metric, limit):
    """Exact full-dims rerank of per-query lex-sorted candidate sets.
    Returns (top_slots [B, limit], raws, ranks, ok [B])."""
    raw, rank_f, finite = _subset_raw_rank(x, slots, slot_ok, queries,
                                           metric=metric, dims=x.shape[1])
    top, raws, ranks = _top_limit(slots, raw, rank_f, limit=limit)
    return top, raws, ranks, finite


# ---------------------------------------------------------------------------
# single-query wrappers (collection single-shot paths)
# ---------------------------------------------------------------------------


def funnel_pipeline(x, valid, q, *, metric, stages, count, limit):
    top, raws, ranks, ok = funnel_pipeline_batch(
        x, valid, q[None, :], metric=metric, stages=stages, count=count,
        limit=limit)
    return top[0], raws[0], ranks[0], ok[0]


def quantized_pipeline(x, signs, valid, q, *, metric, count, limit, d):
    top, raws, ranks, ok = quantized_pipeline_batch(
        x, signs, valid, q[None, :], metric=metric, count=count, limit=limit, d=d)
    return top[0], raws[0], ranks[0], ok[0]


def funnel_candidates_pipeline(x, valid, q, *, metric, stages, count):
    slots, slot_ok, ok = funnel_candidates_batch(
        x, valid, q[None, :], metric=metric, stages=stages, count=count)
    return slots[0], slot_ok[0], ok[0]


def quantized_candidates_pipeline(signs, valid, q, *, count, d):
    slots, slot_ok, ok = quantized_candidates_batch(
        signs, valid, q[None, :], count=count, d=d)
    return slots[0], slot_ok[0], ok[0]


def rerank_pipeline(x, slots, slot_ok, q, *, metric, limit):
    top, raws, ranks, ok = rerank_batch(
        x, slots[None, :], slot_ok[None, :], q[None, :], metric=metric, limit=limit)
    return top[0], raws[0], ranks[0], ok[0]
