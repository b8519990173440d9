"""Exact batched top-C selection for large C — recursive group-min descent.

The adaptive pipelines (quantized candidates=500, funnel candidates=200,
hybrid generators) need the exact C best slots per query out of a [B, N]
score matrix. A full ``lax.top_k`` with large k costs far more than one
pass over the matrix. This module selects the same exact set in
~O(N + C·N/G + C²·g) by descending through group minima:

* level 1 reduces rows to 64-row group minima and keeps the best
  ``C + slack`` groups. Order-statistic bound (same argument as
  ops/flat_scan.py): the C smallest group-mins are C distinct elements, so
  the true C-th best score is <= the C-th smallest group-min ``m_C``; a
  group whose min exceeds ``m_C`` cannot hold a top-C element. All groups
  with min <= ``m_C`` fit in the selection unless more than ``slack`` tie at
  exactly ``m_C`` — detected and reported via ``ok`` (callers fall back to a
  host oracle, as for f32 overflow);
* level 2 repeats with 8-row groups over the gathered ~C·64 candidates;
* the final <= ~8·C survivors sort exactly by (score, lex id) —
  the reference's (rank, id) heap order (search.rs:23-29).

Unlike ``approx_max_k`` the result is exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

#: extra groups kept per level beyond C (boundary-tie absorption)
SLACK = 8

#: below this many groups a direct lax.top_k beats another descent level
_DIRECT_TOPK = 2048

_BIG32 = 2**31 - 1


def group_topk(gmin, gsel, check_c=None):
    """Per-row ``gsel`` smallest entries of ``gmin`` [B, ng]
    (ascending-is-better, +inf pad): returns ``(values, idx, ok)`` sorted
    ascending. A ``lax.top_k`` with large k can lower to a full sort —
    O(ng·log²ng) per row — so for
    large ``ng`` this descends recursively through 8-wide super-group
    minima first (the gsel smallest group-mins occupy at most gsel
    super-groups; any super-group whose min exceeds the gsel-th smallest
    group-min holds none of them).

    ``check_c`` is the CALLER's exactness boundary: ``ok[b]`` asserts that
    every position whose value is <= the ``check_c``-th selected value was
    selected. One global count against the full input suffices — internal
    recursion levels need no checks of their own, because any excluded
    position at or below that boundary would force >= gsel+1 positions at
    or below it (each level keeps ``level_sel + SLACK >= gsel`` covers), and
    the count would fail. Checking at the caller's boundary instead of the
    gsel-th matters in practice: bf16 ranks tie so densely that a gsel-th
    boundary check fails on most real batches (whole batches then stampede
    into the per-query host oracle), while the k-th boundary plus
    GROUP_SLACK absorbs them. ``check_c=None`` skips the check (ok True) —
    for callers that verify exactness themselves."""
    b, ng = gmin.shape
    if ng % 8 and ng > _DIRECT_TOPK:
        # +inf-pad to the next multiple of 8 so the descent path applies.
        # A pad can only be selected when a row has fewer than gsel finite
        # groups; clamping would duplicate a real group in the selection, so
        # such rows flag ok=False (host-oracle fallback) instead.
        pad = (-ng) % 8
        gmin = jnp.pad(gmin, ((0, 0), (0, pad)), constant_values=jnp.inf)
        vals, idx, ok = group_topk(gmin, gsel, check_c=check_c)
        ok = ok & jnp.all(idx < ng, axis=1)
        return vals, jnp.minimum(idx, ng - 1), ok
    if ng % 8 == 0 and ng // 8 > gsel + SLACK and ng > _DIRECT_TOPK:
        sup = gmin.reshape(b, ng // 8, 8)
        smin = jnp.min(sup, axis=2)
        _sv, sidx, _sok = group_topk(smin, min(gsel + SLACK, ng // 8))
        ssel = sidx.shape[1]
        sub = jnp.take_along_axis(sup, sidx[:, :, None], axis=1).reshape(b, ssel * 8)
        sub_idx = (
            sidx[:, :, None] * 8 + jnp.arange(8, dtype=sidx.dtype)[None, None, :]
        ).reshape(b, ssel * 8)
        # dtype-preserving negation: int32 composite keys are not f32-exact
        neg_top, pos = jax.lax.top_k(-sub, gsel)
        vals = -neg_top
        idx = jnp.take_along_axis(sub_idx, pos, axis=1)
    else:
        gsel = min(gsel, ng)
        neg_top, idx = jax.lax.top_k(-gmin, gsel)
        vals = -neg_top
    if check_c is None or gsel >= ng:
        return vals, idx, jnp.ones(b, bool)
    mc = vals[:, min(check_c, gsel) - 1]
    ok = jnp.sum((gmin <= mc[:, None]).astype(jnp.int32), axis=1) <= gsel
    return vals, idx, ok


def _level(key, slots, c, group):
    """One group-min descent level. ``key`` [B, M] ascending-is-better with
    +inf padding, ``slots`` [B, M] int32 global slot per position (-1 pad).
    Returns (key' [B, C'·group], slots', ok) where C' = min(c+SLACK, M/group).
    """
    b, m = key.shape
    ng = m // group
    kg = key.reshape(b, ng, group)
    gmin = jnp.min(kg, axis=2)
    gsel = min(c + SLACK, ng)
    gtop, gidx, ok = group_topk(gmin, gsel, check_c=c)
    key2 = jnp.take_along_axis(kg, gidx[:, :, None], axis=1).reshape(b, gsel * group)
    slots2 = jnp.take_along_axis(
        slots.reshape(b, ng, group), gidx[:, :, None], axis=1
    ).reshape(b, gsel * group)
    return key2, slots2, ok


@functools.partial(jax.jit, static_argnames=("c",))
def exact_top_c_unique_int(key, *, c: int):
    """Exact batched top-C for DISTINCT int32 keys (``_BIG32`` = invalid).

    The adaptive pipelines' integer stages (Hamming) are massively tied at
    scale — at 1M clustered rows ~97% of queries spill the float path's tie
    slack and would fall back to the host oracle. Composite keys
    ``(stage_value << slot_bits) | slot`` make every valid key distinct, so
    group minima are distinct elements, the order-statistic selection bound
    is always tight, and the (rank, id) tie-break (search.rs:23-29) is the
    key order itself. Returns ``(slots [B, C] i32, keys [B, C] i32)``
    ascending; surplus positions carry ``_BIG32`` key and slot -1. No ``ok``
    flag: the selection is unconditionally exact.
    """
    b, n = key.shape
    c_eff = min(c, n)
    slots = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (b, n))
    cur_key, cur_slots = key, slots
    while True:
        m = cur_key.shape[1]
        for group in (64, 8):
            shrunk = min(c_eff + SLACK, m // group) * group
            if m % group == 0 and shrunk < m and m // group > c_eff:
                cur_key, cur_slots, _ok = _level(cur_key, cur_slots, c_eff, group)
                break
        else:
            break
    key_s, slot_s = jax.lax.sort((cur_key, cur_slots), num_keys=1, dimension=1)
    out_k = key_s[:, :c_eff]
    out_s = jnp.where(out_k < _BIG32, slot_s[:, :c_eff], -1)
    if c_eff < c:
        pad = c - c_eff
        out_k = jnp.pad(out_k, ((0, 0), (0, pad)), constant_values=_BIG32)
        out_s = jnp.pad(out_s, ((0, 0), (0, pad)), constant_values=-1)
    return out_s, out_k


def _descend_and_sort(key, slots, lex_rank, c, c_eff):
    """Shared tail of the float top-C selections: group-min descent while a
    level still shrinks the problem, then the exact (key, lex) sort over the
    survivors. Returns (slots [B, C], keys [B, C], ok [B])."""
    b = key.shape[0]
    ok = jnp.ones(b, bool)
    cur_key, cur_slots = key, slots
    while True:
        m = cur_key.shape[1]
        for group in (64, 8):
            shrunk = min(c_eff + SLACK, m // group) * group
            if m % group == 0 and shrunk < m and m // group > c_eff:
                cur_key, cur_slots, lvl_ok = _level(cur_key, cur_slots, c_eff, group)
                ok = ok & lvl_ok
                break
        else:
            break
    # exact (key, lex) order over the survivors; lex_rank None means slot
    # order IS id order (lex-sorted blocks)
    if lex_rank is None:
        lex = cur_slots
    else:
        lex = jnp.where(cur_slots >= 0, lex_rank[jnp.maximum(cur_slots, 0)], _BIG32)
    lex = jnp.where(jnp.isfinite(cur_key), lex, _BIG32)
    key_s, _, slot_s = jax.lax.sort((cur_key, lex, cur_slots), num_keys=2, dimension=1)
    out_k = key_s[:, :c_eff]
    out_s = jnp.where(jnp.isfinite(out_k), slot_s[:, :c_eff], -1)
    if c_eff < c:
        pad = c - c_eff
        out_k = jnp.pad(out_k, ((0, 0), (0, pad)), constant_values=jnp.inf)
        out_s = jnp.pad(out_s, ((0, 0), (0, pad)), constant_values=-1)
    return out_s, out_k, ok


@functools.partial(jax.jit, static_argnames=("c",))
def exact_top_c(key, lex_rank, *, c: int):
    """Exact batched top-C: ``key`` [B, N] f32 ascending-is-better (+inf =
    invalid), ``lex_rank`` [N] int32 id ranks. Returns
    ``(slots [B, C] i32, keys [B, C] f32, ok [B] bool)`` ordered by
    (key, lex id); surplus positions carry +inf key and slot -1. ``ok[b]``
    False = a tie spill exceeded the slack for that query — caller must use
    an exact fallback for it."""
    b, n = key.shape
    slots = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (b, n))
    return _descend_and_sort(key, slots, lex_rank, c, min(c, n))
