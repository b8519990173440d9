"""Deterministic top-k selection with (rank, id) tie-breaking.

The reference keeps a bounded max-heap ordered by ``(rank, external_id)``
(flat.rs:34-40, search.rs:23-29) so equal-rank hits always come back in
lexicographic id order, independent of insertion order. On device we get the same
guarantee without a heap:

* the host maintains ``lex_order`` — a permutation of slots sorted by external
  id (invalid/padded slots at the end);
* ranks are gathered into lex order, then ``lax.top_k`` selects the best
  ``limit``. XLA's TopK is stable (ties resolve to the lowest index), so ties
  resolve to the lexicographically smallest id.

``topk_exact`` (full multi-key sort) is the differential oracle used in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def bucket_limit(limit: int, n: int) -> int:
    """Rounds ``limit`` up to a power-of-two bucket (capped at ``n``) so jit
    compiles once per bucket instead of once per distinct limit."""
    if limit >= n:
        return n
    b = 1
    while b < limit:
        b <<= 1
    return min(b, n)


@functools.partial(jax.jit, static_argnames=("limit",))
def topk_slots(rank, lex_order, *, limit: int):
    """Selects the ``limit`` slots with smallest rank, ties by id order.

    ``rank``: [N] float32 ascending-is-better; invalid slots must be +inf.
    ``lex_order``: [N] int32 permutation, slots sorted by external id with
    invalid slots last. Returns (slots [limit] int32, ranks [limit] f32),
    best first; surplus positions carry rank +inf.
    """
    lex_ranked = rank[lex_order]
    neg_top, pos = jax.lax.top_k(-lex_ranked, limit)
    return lex_order[pos], -neg_top


@functools.partial(jax.jit, static_argnames=("limit",))
def topk_exact(rank, lex_rank, *, limit: int):
    """Oracle: full multi-key sort by (rank, lex_rank); returns slots [limit]."""
    slots = jnp.arange(rank.shape[0], dtype=jnp.int32)
    r, _, s = jax.lax.sort((rank, lex_rank, slots), num_keys=2)
    return s[:limit], r[:limit]


