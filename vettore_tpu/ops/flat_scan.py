"""Exact flat scan: pass-1 group minima, candidate-group rescore, exact top-k.

Replaces the reference's per-row SIMD metric loop with a bounded heap
(/root/reference/native/vettore/src/flat.rs:96-124) by a batched device
program over the whole ``[N, d]`` block:

* **pass 1**: per query, the minimum rank of every 64-row group
  (``[B, N/64]``). With bf16 storage on the GPU this is a Pallas kernel
  through Triton (``_gmin_scan``): each block runs the tile's matmul over a
  K loop, converts dots to ranks and reduces 64-row groups in registers, so
  the ``[B, N]`` f32 rank matrix never reaches device memory (at 512 x 1M it
  is 2 GB written and read back, more than the 1.5 GB corpus the scan must
  read). Everywhere else XLA's plain formulation serves
  (``_fused_xla_search``: one matmul, the rank matrix, its group minima);
  :func:`pass1_impl` makes the choice from the platform and the shapes.
* **group selection**: ``top_k`` of ``k + slack`` groups per query, exact by
  the order-statistic bound — the k smallest group-mins are k distinct
  elements, so any group whose min exceeds the k-th smallest group-min
  cannot contain a top-k element. Ties at the boundary deeper than the slack
  raise the ``ok`` flag (host-oracle fallback).
* **pass 2** (``_rescore``): gathers the selected 64-row groups and scores
  them as a multiply-and-sum in exact f32 arithmetic; XLA fuses the gather
  into the reduction.
* **final selection**: ``top_k(k + tie pad)`` by rank, then a small
  (rank, lex id) sort — reference (rank, id) tie-break, flat.rs:34-40. A
  rank tie straddling the pad boundary sets ``ok`` False (lex order not
  provable without the full candidate sort), falling back to the host
  oracle like overflow does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from . import select

#: rows per selection group (divides every block capacity >= 64 produced by
#: the flat index's sizing)
GROUP = 64

#: extra groups gathered beyond k — absorbs cross-group ties at the k-th
#: group-min boundary (ties deeper than this raise the fallback flag)
GROUP_SLACK = 8

#: extra winners taken beyond k in the final by-rank top_k — absorbs exact
#: rank ties at the k-th boundary so the (rank, lex) sort stays provably
#: complete (deeper ties raise the fallback flag)
TIE_PAD = 16

#: largest supported k
MAX_FUSED_K = 128

FUSED_METRICS = ("cosine", "inner_product", "negative_inner_product", "l2", "l2_squared")

_BIG32 = 2**31 - 1

#: pass-1 kernel tiles: rows per block (four selection groups for 16-bit
#: storage; two for f32, whose tiles cost twice the registers, or when the
#: block size only divides by 128), the K step over ``d`` (largest that
#: divides it), and the query-tile bounds (Triton blocks are powers of two;
#: a dot operand needs at least 16 rows). Chosen by a tile sweep on one
#: H100 at 1M x 768 bf16, batches 1, 64 and 512
_TILE_ROWS = (256, 128)
_TILE_K = (64, 32, 16)
_MIN_QUERY_TILE = 16
_MAX_QUERY_TILE = 128


class Tiles(NamedTuple):
    """One pass-1 kernel configuration: rows and queries per block, the K
    step, and Triton's warps and pipeline stages."""

    rows: int
    queries: int
    k: int
    warps: int
    stages: int


def _tiles(n: int, b: int, d: int, itemsize: int = 2) -> Tiles:
    tb = _query_tile(b)
    rows = next((r for r in _TILE_ROWS if n % r == 0 and r * itemsize <= 512),
                _TILE_ROWS[-1])
    return Tiles(rows, tb, _tile_k(d), 8 if tb >= 128 else 4, 3)


def supports(metric: str, cap: int, k: int) -> bool:
    """Whether the group-min scan handles this configuration."""
    return metric in FUSED_METRICS and cap % GROUP == 0 and 0 < k <= MAX_FUSED_K


def _tile_k(d: int):
    return next((t for t in _TILE_K if d % t == 0), None)


def pass1_impl(platform: str, dtype, n: int, d: int) -> str:
    """Pass-1 route for an ``[n, d]`` block of ``dtype`` on ``platform``:
    ``"triton"`` (the Pallas group-min kernel) or ``"xla"``.

    The kernel serves bf16 storage on the GPU, where it skips the rank
    matrix's round trip through device memory. f32 storage ranks at
    ``HIGHEST``: a true-f32 product has no tensor-core form, cuBLAS's SGEMM
    is the faster route and dwarfs the rank-matrix traffic, so XLA keeps it.
    Other platforms have no compiled kernel and take XLA."""
    if (
        platform == "gpu"
        and jnp.dtype(dtype) == jnp.bfloat16
        and n % _TILE_ROWS[-1] == 0
        and _tile_k(d) is not None
    ):
        return "triton"
    return "xla"


def _query_tile(b: int) -> int:
    return min(_MAX_QUERY_TILE, max(_MIN_QUERY_TILE, pl.next_power_of_2(b)))


# ---------------------------------------------------------------------------
# pass 1: matmul + group-min (Pallas through Triton)
# ---------------------------------------------------------------------------


def _gmin_body(x_ref, xsq_ref, bias_ref, q_ref, qsq_ref, gmin_ref, *,
               metric, tile_k, precision):
    tb, tr = q_ref.shape[0], x_ref.shape[0]

    def k_step(i, acc):
        cols = pl.ds(pl.multiple_of(i * tile_k, tile_k), tile_k)
        return acc + pl.dot(q_ref[:, cols], x_ref[:, cols], trans_b=True,
                            precision=precision)

    dots = jax.lax.fori_loop(0, x_ref.shape[1] // tile_k, k_step,
                             jnp.zeros((tb, tr), jnp.float32))  # [TB, TR]
    if metric in ("cosine", "inner_product", "negative_inner_product"):
        # shared rank key: -dot (cosine's 1-dot offset applied at the end)
        rank = -dots
    else:  # l2 / l2_squared on squared distance (monotonic in true rank)
        rank = xsq_ref[...][None, :] - 2.0 * dots + qsq_ref[...][:, None]
    # no per-element finiteness pass: the wrapper proves every rank finite
    # (Cauchy-Schwarz bound in _gmin_scan); invalid rows reach +inf through
    # the bias (dead slots are zeroed, so their dot is 0 and +inf survives)
    rank = rank + bias_ref[...][None, :]
    gmin_ref[...] = jnp.min(rank.reshape(tb, tr // GROUP, GROUP), axis=2)


#: overflow-proof bound: per-term cap so |xsq| + 2|dot| + |qsq| stays under
#: f32 max with margin for bf16 rounding and accumulation-order effects
_SAFE_LIM = 4e37
_SAFE_LOG = 86.0  # log(2.2e37) >= log(|dot|) bound via Cauchy-Schwarz


def _gmin_scan(x, xsq, bias, q, *, metric, interpret=False):
    """Group minima of the rank matrix: ``[B, N/GROUP]`` f32 plus a scalar
    ``bounded`` flag — the full ``[B, N]`` never leaves the kernel's
    registers.

    Each block scores ``tiles.rows`` rows against one query tile, walking
    ``d`` in ``tiles.k`` steps with bf16 operands and f32 accumulation. The
    grid's first axis is the query tile, so the blocks that share a row tile
    run back to back and read it from L2. :func:`_tiles` picks the tiles.

    The kernel epilogue carries no finiteness checks; instead this wrapper
    proves per batch that no rank can overflow: every partial sum of
    ``x_row . q`` is bounded by ``|x_row| * |q|`` (Cauchy-Schwarz holds for
    every prefix), so when ``max_row_norm * max_query_norm`` and the
    squared-norm terms sit well under f32 max, every intermediate is finite.
    A batch that fails the bound returns ``bounded=False`` → caller's ok=False
    → f64 host oracle."""
    n, d = x.shape
    b = q.shape[0]
    xsq = xsq.reshape(-1)
    bias = bias.reshape(-1)
    t = _tiles(n, b, d, x.dtype.itemsize)
    if n % t.rows or t.k is None:
        raise ValueError(f"pass-1 kernel needs n % {t.rows} == 0 and "
                         f"d % {_TILE_K[-1]} == 0, got {x.shape}")
    qf = q.astype(jnp.float32)
    qsq = jnp.sum(qf * qf, axis=1)  # [B]
    xsq_max = jnp.max(xsq)
    qlog = 0.5 * jnp.log(jnp.maximum(qsq, 1e-30))
    xlog = 0.5 * jnp.log(jnp.maximum(xsq_max, 1e-30))
    bounded = jnp.all(
        (qsq < _SAFE_LIM) & (xsq_max < _SAFE_LIM) & (qlog + xlog < _SAFE_LOG))
    tb = t.queries
    bp = -(-b // tb) * tb
    # zero pad queries rank every row finitely; their rows are sliced off
    qk = jnp.pad(qf, ((0, bp - b), (0, 0))).astype(x.dtype)
    qsq_p = jnp.pad(qsq, (0, bp - b))
    fast = x.dtype == jnp.bfloat16
    kernel = functools.partial(
        _gmin_body, metric=metric, tile_k=t.k,
        precision=None if fast else jax.lax.Precision.HIGHEST)
    gmin = pl.pallas_call(
        kernel,
        grid=(bp // tb, n // t.rows),
        in_specs=[
            pl.BlockSpec((t.rows, d), lambda j, i: (i, 0)),
            pl.BlockSpec((t.rows,), lambda j, i: (i,)),
            pl.BlockSpec((t.rows,), lambda j, i: (i,)),
            pl.BlockSpec((tb, d), lambda j, i: (j, 0)),
            pl.BlockSpec((tb,), lambda j, i: (j,)),
        ],
        out_specs=pl.BlockSpec((tb, t.rows // GROUP), lambda j, i: (j, i)),
        out_shape=jax.ShapeDtypeStruct((bp, n // GROUP), jnp.float32),
        compiler_params=plt.CompilerParams(num_warps=t.warps, num_stages=t.stages),
        backend="triton",
        interpret=interpret,
        name="flat_gmin_scan",
        cost_estimate=pl.CostEstimate(
            flops=2 * n * d * bp,
            bytes_accessed=n * d * x.dtype.itemsize + bp * d * x.dtype.itemsize
            + bp * (n // GROUP) * 4,
            transcendentals=0,
        ),
    )(x, xsq, bias, qk, qsq_p)
    return gmin[:b], bounded


# ---------------------------------------------------------------------------
# pass 2: candidate-group rescore (XLA gather + multiply-and-sum)
# ---------------------------------------------------------------------------


def _rescore(x, xsq, bias, q, gidx, *, metric):
    """Ranks of every row of the selected groups: ``[B, gsel, GROUP]`` f32.
    Each query reads only its ``gsel`` groups (cost independent of N). The
    multiply-and-sum keeps the f32 products exact, with no matmul precision
    mode in play."""
    n, d = x.shape
    rows = x.reshape(n // GROUP, GROUP, d)[gidx].astype(jnp.float32)
    qf = q.astype(jnp.float32)
    dots = jnp.sum(rows * qf[:, None, None, :], axis=-1)  # [B, gsel, GROUP]
    if metric in ("cosine", "inner_product", "negative_inner_product"):
        rank = -dots
    else:
        qsq = jnp.sum(qf * qf, axis=1)[:, None, None]
        rank = xsq.reshape(-1, GROUP)[gidx] - 2.0 * dots + qsq
    rank = rank + bias.reshape(-1, GROUP)[gidx]
    return jnp.where(jnp.isfinite(rank), rank, jnp.inf)


# ---------------------------------------------------------------------------
# end-to-end search
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("metric", "k", "impl", "interpret"))
def fused_flat_search(x, xsq, bias, lex_rank, q, *, metric, k, impl=None,
                      interpret=False):
    """Exact batched top-k over a device block.

    ``x`` [N, d] (f32 or bf16 storage), ``xsq`` [N, 1] f32 squared norms,
    ``bias`` [N, 1] f32 (0 valid / +inf invalid), ``lex_rank`` [N] int32
    lexicographic id ranks, ``q`` [B, d] f32 queries. Invalid rows of ``x``
    must be all-zero (the flat index zeroes dead slots) so their rank is
    exactly the +inf bias.

    ``impl`` picks pass 1 (``"triton"`` or ``"xla"``; None = :func:`pass1_impl`
    for this platform and block). ``interpret`` runs the Triton kernel in the
    Pallas interpreter — for tests on machines without a GPU.

    Returns ``(slots [B, k] i32, raws [B, k] f32, ranks [B, k] f32, ok)``
    best-first with (rank, lex id) tie-break; ``ok`` False means the batch
    failed the overflow-safety norm bound (see ``_gmin_scan``) or a tie
    spill — caller must re-run on the host oracle.
    """
    n, d = x.shape
    b = q.shape[0]
    xsq = xsq.reshape(-1)
    bias = bias.reshape(-1)
    if impl is None:
        impl = pass1_impl(jax.default_backend(), x.dtype, n, d)
    if impl == "xla":
        return _fused_xla_search(x, xsq, bias, lex_rank, q, metric=metric, k=k)
    if impl != "triton":
        raise ValueError(f"unknown pass-1 impl {impl!r}")

    gmin, bounded = _gmin_scan(x, xsq, bias, q, metric=metric,
                               interpret=interpret)
    ng = n // GROUP
    gsel = min(k + GROUP_SLACK, ng)
    # tie spill check at the K boundary: every group with min <= m_k must be
    # selected (GROUP_SLACK absorbs up to 8 tied groups past it)
    _gtop, gidx, g_ok = select.group_topk(gmin, gsel, check_c=k)
    spill_ok = jnp.all(g_ok)

    cand = _rescore(x, xsq, bias, q, gidx, metric=metric).reshape(
        b, gsel * GROUP)
    cand_slots = (
        gidx[:, :, None] * GROUP + jnp.arange(GROUP, dtype=jnp.int32)[None, None, :]
    ).reshape(b, gsel * GROUP)

    sel = min(k + TIE_PAD, gsel * GROUP)
    neg_sel, pos = jax.lax.top_k(-cand, sel)
    sel_rank = -neg_sel
    sel_slots = jnp.take_along_axis(cand_slots, pos, axis=1)
    sel_lex = jnp.where(jnp.isfinite(sel_rank), lex_rank[sel_slots], _BIG32)
    rank_s, _, slot_s = jax.lax.sort(
        (sel_rank, sel_lex, sel_slots), num_keys=2, dimension=1)
    # a rank tie crossing the pad boundary means lex-smaller ids may sit
    # outside the selected pad — not provably exact, flag it
    tie_ok = jnp.all(
        jnp.logical_or(rank_s[:, k - 1] < sel_rank[:, sel - 1],
                       jnp.logical_not(jnp.isfinite(sel_rank[:, sel - 1]))))
    top_rank = rank_s[:, :k]
    top_slot = slot_s[:, :k]
    top_slot, raw, top_rank = _finalize(x, q, top_slot, top_rank, metric=metric)
    return top_slot, raw, top_rank, bounded & spill_ok & tie_ok


def _finalize(x, q, top_slot, top_rank, *, metric):
    """Re-scores the k winners at HIGHEST precision (raw values must be
    f32-exact regardless of the storage/selection dtype)."""
    if metric in ("l2", "l2_squared"):
        # selection ranked via the xsq - 2qx + qsq expansion (monotonic, one
        # matmul); winners re-score DIRECTLY — the expansion cancels
        # catastrophically near zero (distances.rs computes (a-b)^2 directly)
        rows = x[top_slot].astype(jnp.float32)
        diff = rows - q.astype(jnp.float32)[:, None, :]
        sq = jnp.sum(diff * diff, axis=-1)
        raw = jnp.sqrt(sq) if metric == "l2" else sq
        top_rank = jnp.where(jnp.isfinite(top_rank), raw, jnp.inf)
    else:
        rows = x[top_slot].astype(jnp.float32)
        rdots = jnp.einsum(
            "bkd,bd->bk", rows, q.astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
        )
        raw = -rdots if metric == "negative_inner_product" else rdots
        if metric == "cosine":
            top_rank = 1.0 + top_rank  # rank key was -dot
    return top_slot, raw, top_rank


def _fused_xla_search(x, xsq, bias, lex_rank, q, *, metric, k):
    """XLA pass 1: one whole-block matmul + group-min selection with the
    full-candidate (rank, lex) sort. Exact for arbitrary tie depths (no tie
    pad), at the cost of materializing the [B, N] rank matrix in device
    memory."""
    n, d = x.shape
    b = q.shape[0]
    fast = x.dtype == jnp.bfloat16
    qd = q.astype(jnp.bfloat16) if fast else q
    dots = jnp.dot(
        qd, x.T,
        preferred_element_type=jnp.float32,
        precision=None if fast else jax.lax.Precision.HIGHEST,
    )  # [B, N]
    if metric in ("cosine", "inner_product", "negative_inner_product"):
        rank = -dots
    else:
        qsq = jnp.sum(q.astype(jnp.float32) ** 2, axis=1, keepdims=True)  # [B, 1]
        rank = xsq.reshape(1, -1) - 2.0 * dots + qsq
    valid = bias.reshape(1, -1) == 0.0
    all_finite = jnp.all(jnp.isfinite(rank) | ~valid)
    rank = rank + bias.reshape(1, -1)
    rank = jnp.where(jnp.isfinite(rank), rank, jnp.inf)

    ng = n // GROUP
    rank_g = rank.reshape(b, ng, GROUP)
    gmin = jnp.min(rank_g, axis=2)  # [B, NG]
    gsel = min(k + GROUP_SLACK, ng)
    gtop, gidx, g_ok = select.group_topk(gmin, gsel, check_c=k)
    spill_ok = jnp.all(g_ok)

    cand = jnp.take_along_axis(rank_g, gidx[:, :, None], axis=1).reshape(b, gsel * GROUP)
    cand_slots = (
        gidx[:, :, None] * GROUP + jnp.arange(GROUP, dtype=jnp.int32)[None, None, :]
    ).reshape(b, gsel * GROUP)
    cand_lex = jnp.where(jnp.isfinite(cand), lex_rank[cand_slots], _BIG32)
    rank_s, _, slot_s = jax.lax.sort((cand, cand_lex, cand_slots), num_keys=2, dimension=1)
    top_rank = rank_s[:, :k]
    top_slot = slot_s[:, :k]
    top_slot, raw, top_rank = _finalize(x, q, top_slot, top_rank, metric=metric)
    return top_slot, raw, top_rank, all_finite & spill_ok
