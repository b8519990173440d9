"""Exact flat index: device-resident vector shard + fused scan/top-k.

Accelerator redesign of the reference's Rust flat index
(/root/reference/native/vettore/src/flat.rs): instead of a HashMap walk with a
bounded heap per query (flat.rs:96-124), vectors live in one device-resident
``[cap, d]`` float32 block with a validity mask; a search is a single jitted
XLA program — matmul-based scoring, rank conversion, and a
deterministic top-k with the reference's (rank, id) tie-break
(flat.rs:34-40) via a host-maintained lexicographic slot permutation.

Mutations update a host mirror (the index stays rebuildable and cheap to
mutate); the device copy refreshes lazily on the next search.
"""

from __future__ import annotations

import functools
import math
from typing import Iterable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import (
    DimensionMismatch,
    InvalidFlatOptions,
    InvalidVector,
    UnsupportedFlatMetric,
)
from ..metrics import METRICS, normalize_metric, rank_value
from ..ops.distance import batched_raw_scores, rank_from_raw, validate_vector
from ..ops.topk import bucket_limit, topk_slots
from ..ops.transport import put_f32_matrix
from .base import Index

_MIN_CAP = 8
_ROW_TILE = 1024


def _cap_for(needed: int) -> int:
    """Capacity for ``needed`` rows. Small blocks round to a power of two
    (they sit below the fused-kernel threshold anyway); larger ones round up
    to the next ``_ROW_TILE`` multiple, so a bulk-ingested block carries
    <0.1% padding. The reference scans exactly ``n`` rows per query
    (flat.rs:96-124); pow2 rounding scanned up to 2x phantom rows."""
    if needed <= _ROW_TILE:
        return max(_MIN_CAP, 1 << max(0, math.ceil(math.log2(max(needed, 1)))))
    return -(-needed // _ROW_TILE) * _ROW_TILE


@functools.partial(jax.jit, static_argnames=("metric", "limit", "use_true_cosine"))
def _search_kernel(x, valid, lex_order, q, scale=None, *, metric, limit,
                   use_true_cosine=False):
    if scale is not None:
        # int8 storage on a non-fused config: dequantize through the XLA
        # path (fused into the scan read — no [N, d] f32 materialization);
        # raw quality matches the fused int8 path's storage-noise posture
        x = x.astype(jnp.float32) * scale.reshape(-1, 1)
    raw = batched_raw_scores(x, q, metric=metric, use_true_cosine=use_true_cosine)
    rank = rank_from_raw(raw, metric=metric)
    rank = jnp.where(valid, rank, jnp.inf)
    all_finite = jnp.all(jnp.isfinite(raw) | ~valid)
    slots, ranks = topk_slots(rank, lex_order, limit=limit)
    return slots, raw[slots], ranks, all_finite


@jax.jit
def _pack_hits(slots, raws, all_finite):
    """Packs (slots, raws, finite) into ONE int32 array so results cross to
    the host in a single transfer.

    Integer transport keeps the slot ids exact: small int32 slot values
    bitcast to f32 are denormals, which a flush-to-zero path would erase.
    """
    r = jax.lax.bitcast_convert_type(raws, jnp.int32)
    flag = jnp.broadcast_to(
        all_finite.astype(jnp.int32).reshape((1, 1)), (slots.shape[0], 1)
    )
    return jnp.concatenate([slots, r, flag], axis=1)


def _unpack_hits(packed: np.ndarray, k: int):
    slots = packed[:, :k]
    raws = np.ascontiguousarray(packed[:, k : 2 * k]).view(np.float32)
    all_finite = bool(packed[0, -1] > 0) if packed.size else True
    return slots, raws, all_finite


@functools.partial(jax.jit, static_argnames=("metric", "limit", "use_true_cosine"))
def _search_kernel_batch(x, valid, lex_order, queries, scale=None, *, metric,
                         limit, use_true_cosine=False):
    """Batched variant: ``queries`` [B, d] → per-query top-k in ONE dispatch.

    Query batching is the accelerator analog of the reference's concurrent
    ETS readers (SURVEY §2.3): one fused [B, d] x [d, N] matmul amortizes
    dispatch and host round-trips across the whole batch.
    """

    def one(q):
        return _search_kernel(
            x, valid, lex_order, q, scale, metric=metric, limit=limit,
            use_true_cosine=use_true_cosine
        )

    return jax.vmap(one)(queries)


def _to_f64_array(vector) -> np.ndarray:
    try:
        arr = np.asarray(vector, dtype=np.float64)
    except (ValueError, TypeError) as exc:
        raise InvalidVector("vector must be numeric") from exc
    if arr.ndim != 1:
        raise InvalidVector("vector must be one-dimensional")
    return arr


def _validate_row(vector, expected_dim):
    if len(vector) == 0:
        raise InvalidVector("vector must not be empty")
    if expected_dim is not None and len(vector) != expected_dim:
        raise DimensionMismatch("dimension mismatch")
    validate_vector(vector)


@jax.jit
def _row_sq_norms(x):
    """[cap, 1] f32 row squared norms computed on device (adopt path)."""
    xf = x.astype(jnp.float32)
    return jnp.sum(xf * xf, axis=1, keepdims=True)


@jax.jit
def _quantize_int8(x):
    """Per-row symmetric int8 quantization of a device f32 block:
    returns (x8 [N, d] int8, scale [N] f32 dequant factors)."""
    xf = x.astype(jnp.float32)
    absmax = jnp.maximum(jnp.max(jnp.abs(xf), axis=1), 1e-30)
    scale = (absmax / 127.0).astype(jnp.float32)
    x8 = jnp.clip(jnp.round(xf / scale[:, None]), -127, 127).astype(jnp.int8)
    return x8, scale


class FlatIndex(Index):
    """Exact scan over all stored vectors for one ranking metric."""

    def __init__(self, metric: str, options=None, *, storage: str = "f32"):
        if options not in (None, {}, []):
            raise InvalidFlatOptions("flat index accepts no options")
        metric = normalize_metric(metric)
        if metric not in METRICS:
            raise UnsupportedFlatMetric(metric)
        if storage not in ("f32", "bf16", "int8"):
            raise InvalidFlatOptions(f"unknown storage mode: {storage!r}")
        #: "bf16" stores the device block in bfloat16 and scans with bf16
        #: tensor-core products — half the device memory; selection carries
        #: bf16 noise, while the winners' raw values re-score exactly against
        #: the stored rows. "int8" stores per-row symmetric-quantized values
        #: + f32 scales — quarter the device memory; every search
        #: dequantizes through the XLA scan (raw values approximate to
        #: ~1e-2..1e-1). bf16 keeps a bf16 host mirror (half the
        #: host RAM; the mirror holds exactly what the device block scores);
        #: int8 keeps an f32 mirror as the dequant reference.
        self.storage = storage
        self._int8_scale = None
        self.metric = metric
        self._dim: int | None = None
        self._cap = 0
        self._host_x: np.ndarray | None = None
        self._valid: np.ndarray | None = None
        self._ids: list = []
        self._slot_of: dict[str, int] = {}
        self._free: list[int] = []
        self._device = None
        self._device_scan = None
        self._dirty = True

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._slot_of)

    @property
    def dimension(self):
        return self._dim

    # -- mutation -----------------------------------------------------------

    def put(self, id: str, vector) -> None:
        self.put_many([(id, vector)])

    def put_many(self, pairs: Iterable[Tuple[str, list]]) -> None:
        """Insert-or-replace a batch. The whole batch is validated before any
        mutation (flat.rs:69-85). Rectangular batches take a vectorized path
        (single matrix validate + bulk slot assignment) — the row loop only
        handles ragged/replacing edge cases."""
        pairs = list(pairs)
        if not pairs:
            return
        ids = [str(id) for id, _ in pairs]
        matrix = None
        try:
            with np.errstate(over="ignore"):
                rows = [v for _, v in pairs]
                if rows and all(
                    isinstance(v, np.ndarray) and v.ndim == 1 and v.shape == rows[0].shape
                    for v in rows
                ):
                    # ~10x faster than stacking 1M separate array objects
                    matrix = np.concatenate(rows, dtype=np.float32).reshape(len(rows), -1)
                else:
                    matrix = np.stack([np.asarray(v, dtype=np.float32) for v in rows])
        except (TypeError, ValueError):
            matrix = None
        if (
            matrix is not None
            and matrix.ndim == 2
            and matrix.shape[1] > 0
            and len(set(ids)) == len(ids)
        ):
            expected = self._dim if self._dim is not None else matrix.shape[1]
            if matrix.shape[1] != expected:
                raise DimensionMismatch("dimension mismatch")
            with np.errstate(invalid="ignore"):
                if not np.isfinite(matrix).all():
                    raise InvalidVector("vector contains a non-finite value")
            new_ids = [id for id in ids if id not in self._slot_of]
            self._reserve(len(self._slot_of) + len(new_ids), expected)
            slots = np.empty(len(ids), dtype=np.int64)
            for i, id in enumerate(ids):
                slot = self._slot_of.get(id)
                if slot is None:
                    slot = self._free.pop()
                    self._slot_of[id] = slot
                    self._ids[slot] = id
                slots[i] = slot
            self._host_x[slots] = matrix
            self._valid[slots] = True
            if self._dim is None:
                self._dim = expected
            self._dirty = True
            return

        # slow path: ragged rows / duplicate ids within the batch (replace
        # semantics: last occurrence wins) / precise per-row errors
        batch = [(str(id), _to_f64_array(v)) for id, v in pairs]
        expected = self._dim
        if expected is None and batch:
            expected = len(batch[0][1])
        for _, v in batch:
            _validate_row(v, expected)
        new_count = sum(1 for id, _ in batch if id not in self._slot_of)
        self._reserve(len(self._slot_of) + new_count, expected)
        for id, v in batch:
            slot = self._slot_of.get(id)
            if slot is None:
                slot = self._free.pop()
                self._slot_of[id] = slot
                self._ids[slot] = id
            self._host_x[slot, :] = v.astype(np.float32)
            self._valid[slot] = True
        if self._dim is None:
            self._dim = expected
        self._dirty = True

    def put_matrix(self, ids, matrix) -> None:
        """Bulk insert from an [n, d] f32 matrix with one row per id —
        the zero-copy ingest path for million-row corpora (no per-row Python
        objects; the reference's batched ``put_many`` analog at matrix
        granularity, flat.rs:59-85). Ids must be unique and not yet present;
        mixed insert-or-replace batches go through :meth:`put_many`."""
        matrix = np.ascontiguousarray(matrix, dtype=np.float32)
        if matrix.ndim != 2 or matrix.shape[1] == 0:
            raise InvalidVector("matrix must be [n, d] with d > 0")
        if len(ids) != matrix.shape[0]:
            raise InvalidVector("ids and matrix row count differ")
        expected = self._dim if self._dim is not None else matrix.shape[1]
        if matrix.shape[1] != expected:
            raise DimensionMismatch("dimension mismatch")
        with np.errstate(invalid="ignore"):
            if not np.isfinite(matrix).all():
                raise InvalidVector("vector contains a non-finite value")
        ids = [str(i) for i in ids]
        if len(set(ids)) != len(ids):
            raise InvalidVector("duplicate ids in matrix batch")
        if any(i in self._slot_of for i in ids):
            raise InvalidVector("put_matrix ids must not already exist")
        self._reserve(len(self._slot_of) + len(ids), expected)
        # fresh ids take the tail of the free list in one vectorized strip
        slots = np.array([self._free.pop() for _ in ids], dtype=np.int64)
        for id, slot in zip(ids, slots):
            self._slot_of[id] = int(slot)
            self._ids[int(slot)] = id
        self._host_x[slots] = matrix
        self._valid[slots] = True
        if self._dim is None:
            self._dim = expected
        self._dirty = True

    def delete(self, id: str) -> None:
        slot = self._slot_of.pop(id, None)
        if slot is None:
            return
        # zero the dead row: the fused scan encodes overflow as -inf group
        # minima, so invalid slots must never rank nonfinite — all-zero rows
        # (like never-used capacity) rank finite under every fused metric
        self._host_x[slot, :] = 0.0
        self._valid[slot] = False
        self._ids[slot] = None
        self._free.append(slot)
        if not self._slot_of:
            # Empty index forgets its dimension (flat.rs:88-93).
            self._dim = None
            self._cap = 0
            self._host_x = None
            self._valid = None
            self._ids = []
            self._free = []
        self._dirty = True

    def _mirror_dtype(self):
        """Host-mirror dtype: bf16 storage keeps bf16 halves on the host too
        (half the canonical-RAM; numpy rounds on assignment and widens on
        read, so every consumer sees exactly the values the device block
        scores). int8 keeps an f32 mirror — it is the dequant reference."""
        if self.storage == "bf16":
            import ml_dtypes

            return ml_dtypes.bfloat16
        return np.float32

    def _reserve(self, needed: int, dim: int):
        if self._host_x is None:
            cap = _cap_for(needed)
            self._cap = cap
            self._host_x = np.zeros((cap, dim), dtype=self._mirror_dtype())
            self._valid = np.zeros(cap, dtype=bool)
            self._ids = [None] * cap
            self._free = list(range(cap - 1, -1, -1))
            return
        if needed <= self._cap:
            return
        # ~1.25x geometric growth amortizes incremental inserts; a one-shot
        # bulk ingest into a fresh/small index still reserves near-exact-fit
        cap = _cap_for(max(needed, self._cap + (self._cap >> 2)))
        grown_x = np.zeros((cap, self._host_x.shape[1]), dtype=self._host_x.dtype)
        grown_x[: self._cap] = self._host_x
        grown_valid = np.zeros(cap, dtype=bool)
        grown_valid[: self._cap] = self._valid
        self._ids.extend([None] * (cap - self._cap))
        self._free.extend(range(cap - 1, self._cap - 1, -1))
        self._host_x = grown_x
        self._valid = grown_valid
        self._cap = cap

    def storage_view(self, storage: str) -> "FlatIndex":
        """A read-only view of this index under a different storage mode —
        the device block converts on device (no host→device re-transfer).
        Mutating either index afterwards is undefined; intended for
        benchmarking / serving-time storage experiments."""
        if storage not in ("f32", "bf16", "int8"):
            raise InvalidFlatOptions(f"unknown storage mode: {storage!r}")
        view = FlatIndex(self.metric, storage=storage)
        view._dim = self._dim
        view._cap = self._cap
        view._host_x = self._host_x
        view._valid = self._valid
        view._ids = self._ids
        view._slot_of = self._slot_of
        view._free = self._free
        self._sync_device()
        x, valid, lex_order = self._device
        if storage == "int8":
            if x.dtype == jnp.int8:
                view._int8_scale = self._int8_scale
            else:
                x, view._int8_scale = _quantize_int8(x)
        elif x.dtype == jnp.int8:
            # widening views of an int8 parent cannot recover precision from
            # the quantized block — rebuild from the canonical host mirror
            view._dirty = True
            return view
        elif storage == "bf16" and x.dtype != jnp.bfloat16:
            x = x.astype(jnp.bfloat16)
        elif storage == "f32" and x.dtype != jnp.float32:
            x = x.astype(jnp.float32)
        view._device = (x, valid, lex_order)
        view._device_scan = self._device_scan
        view._dirty = False
        return view

    # -- search -------------------------------------------------------------

    def adopt_device_block(self, x_dev, *, sample: int = 64, seed: int = 0) -> None:
        """Adopts an already-resident ``[n, d]`` (or ``[cap, d]``) f32 device
        block as this index's scan copy, skipping the host→device upload.

        The canonical data ALWAYS lives in the host mirror (the reference's
        store-vs-acceleration invariant, README.md:410-415); the block is
        only accepted after ``sample`` deterministic rows are fetched and
        verified bit-identical to the mirror. Intended for callers that can
        regenerate the corpus on device (deterministic generators, e.g.
        ``vettore_tpu.synth``) or share another index's block — the upload
        of a large corpus costs far more than the verification. ``sample >= n`` verifies every row. Raises
        ``InvalidVector`` on any mismatch; on success the index is clean
        (no pending upload)."""
        if self._host_x is None:
            raise InvalidFlatOptions("adopt_device_block needs ingested rows")
        if x_dev.ndim != 2 or int(x_dev.shape[1]) != self._host_x.shape[1]:
            raise DimensionMismatch("device block shape mismatch")
        n_rows = int(x_dev.shape[0])
        if n_rows > self._cap:
            raise InvalidVector("device block has more rows than capacity")
        if x_dev.dtype != jnp.float32:
            raise InvalidVector("device block must be float32")
        if n_rows < self._cap:
            x_dev = jnp.concatenate(
                [x_dev, jnp.zeros((self._cap - n_rows, x_dev.shape[1]),
                                  jnp.float32)])
        if sample >= n_rows:  # full verification on request
            probe = np.arange(max(n_rows, 1))
        else:
            rng = np.random.default_rng(seed)
            probe = np.unique(rng.integers(0, max(n_rows, 1), size=sample))
        got = np.asarray(x_dev[jnp.asarray(probe.astype(np.int32))])
        want = self._host_x[probe].astype(np.float32)
        if got.shape != want.shape or (
                got.view(np.uint32) != want.view(np.uint32)).any():
            raise InvalidVector(
                "device block does not match the canonical host mirror")
        self._sync_device(adopt=x_dev)

    def _sync_device(self, adopt=None):
        if adopt is None and not self._dirty and self._device is not None:
            return
        live = np.flatnonzero(self._valid)
        id_arr = np.array([self._ids[s] for s in live], dtype=str)
        order = live[np.argsort(id_arr, kind="stable")] if live.size else live
        invalid = np.flatnonzero(~self._valid)
        lex_order = np.concatenate([order, invalid]).astype(np.int32)
        # cached for consumers that need live slots in id order without
        # re-sorting a million id strings (IvfIndex.rebuild)
        self._lex_order_np = lex_order
        self._live_count = int(live.size)
        lex_rank = np.zeros(self._cap, dtype=np.int32)
        lex_rank[lex_order] = np.arange(self._cap, dtype=np.int32)
        bias = np.where(self._valid[:, None], np.float32(0.0), np.float32(np.inf))
        from ..ops.transport import put_f32_matrix

        # ships 16-bit halves when the block is bf16-exact (bit-identical
        # reconstruction) — half the host-to-device bytes. A bf16 host
        # mirror widens to bf16-exact f32, so it ships halves.
        # ``adopt`` (adopt_device_block) supplies a pre-verified resident
        # block instead, skipping the upload AND the host xsq pass (the
        # squared norms come off the resident block; ulp-level summation-
        # order differences only move raw scores by float noise).
        if adopt is not None:
            device_x = adopt
            xsq_dev = _row_sq_norms(device_x)
        else:
            device_x = put_f32_matrix(self._host_x.astype(np.float32))
            xsq = np.sum(
                self._host_x.astype(np.float32) ** 2, axis=1, keepdims=True,
                dtype=np.float32,
            )
            xsq_dev = jnp.asarray(xsq)
        if self.storage == "bf16":
            device_x = device_x.astype(jnp.bfloat16)
        elif self.storage == "int8":
            device_x, self._int8_scale = _quantize_int8(device_x)
        self._device = (
            device_x,
            jnp.asarray(self._valid),
            jnp.asarray(lex_order),
        )
        self._device_scan = (
            xsq_dev,
            jnp.asarray(bias.astype(np.float32)),
            jnp.asarray(lex_rank),
        )
        self._dirty = False

    def _fused_eligible(self, k: int) -> bool:
        """Whether the group-min scan (ops/flat_scan.py) handles this
        search; small blocks, exotic metrics and int8 storage take the
        elementwise XLA path (group selection only pays off past a few row
        tiles; int8 dequantizes inside that scan)."""
        from ..ops import flat_scan

        return (self.storage != "int8" and self._cap >= 1024
                and flat_scan.supports(self.metric, self._cap, k))

    def _fused_dispatch(self, queries_device, k: int):
        """Runs the group-min scan. Returns (slots, raws, ranks, ok) device
        arrays."""
        x, _valid, _lex_order = self._device
        xsq, bias, lex_rank = self._device_scan
        from ..ops.flat_scan import fused_flat_search

        return fused_flat_search(x, xsq, bias, lex_rank, queries_device,
                                 metric=self.metric, k=k)

    def _xla_scale(self):
        """Dequant scales for the XLA fallback kernels (None unless int8):
        every metric/limit stays servable on int8 storage — the fallback
        dequantizes inside the scan instead of refusing (flat.rs:96-124
        serves every metric regardless of storage)."""
        return self._int8_scale if self.storage == "int8" else None

    def search(self, query, limit: int) -> list:
        """Returns up to ``limit`` ``(id, raw)`` hits, best-first with
        deterministic (rank, id) tie-break."""
        if limit == 0:
            return []
        q = _to_f64_array(query)
        _validate_row(q, self._dim)
        if not self._slot_of:
            return []
        self._sync_device()
        x, valid, lex_order = self._device
        k = bucket_limit(min(limit, len(self._slot_of)), self._cap)
        if self._fused_eligible(k):
            d_slots, d_raws, _d_ranks, d_fin = self._fused_dispatch(
                jnp.asarray(q, dtype=jnp.float32)[None, :], k)
            packed = np.asarray(_pack_hits(d_slots, d_raws, d_fin))
            slots_b, raws_b, all_finite = _unpack_hits(packed, k)
            slots, raws = slots_b[0], raws_b[0]
        else:
            d_slots, d_raws, _d_ranks, d_fin = _search_kernel(
                x, valid, lex_order, jnp.asarray(q, dtype=jnp.float32),
                self._xla_scale(), metric=self.metric, limit=k,
            )
            # One host round-trip for all outputs.
            packed = np.asarray(_pack_hits(d_slots[None, :], d_raws[None, :], d_fin))
            slots_b, raws_b, all_finite = _unpack_hits(packed, k)
            slots, raws = slots_b[0], raws_b[0]
        if not bool(all_finite):
            return self._host_search(q, limit)
        n = min(limit, len(self._slot_of))
        return [(self._ids[int(s)], float(r)) for s, r in zip(slots[:n], raws[:n])]

    def search_batch(self, queries, limit: int) -> list:
        """Scores a whole query batch in one device dispatch; returns one
        ``[(id, raw)]`` hit list per query."""
        if limit == 0:
            return [[] for _ in range(len(queries))]
        try:
            qs = np.asarray(queries, dtype=np.float64)
        except (TypeError, ValueError) as exc:
            raise InvalidVector("queries must be numeric") from exc
        if qs.ndim != 2:
            raise InvalidVector("queries must be a [batch, dims] matrix")
        if qs.shape[0] == 0:
            return []
        if qs.shape[1] == 0:
            raise InvalidVector("vector must not be empty")
        if self._dim is not None and qs.shape[1] != self._dim:
            raise DimensionMismatch("dimension mismatch")
        from ..metrics import F32_MAX

        if qs.size and (not np.isfinite(qs).all() or (np.abs(qs) > F32_MAX).any()):
            raise InvalidVector("vector contains a non-finite value")
        if not self._slot_of:
            return [[] for _ in range(qs.shape[0])]
        self._sync_device()
        x, valid, lex_order = self._device
        k = bucket_limit(min(limit, len(self._slot_of)), self._cap)
        if self._fused_eligible(k):
            d_slots, d_raws, _d_ranks, d_fin = self._fused_dispatch(
                put_f32_matrix(qs.astype(np.float32)), k)
            packed = np.asarray(_pack_hits(d_slots, d_raws, d_fin))
            slots, raws, fin = _unpack_hits(packed, k)
            all_finite = np.repeat(fin, qs.shape[0])
        else:
            d_slots, d_raws, _d_ranks, d_fin_rows = _search_kernel_batch(
                x, valid, lex_order, put_f32_matrix(qs.astype(np.float32)),
                self._xla_scale(), metric=self.metric, limit=k,
            )
            packed = np.asarray(_pack_hits(d_slots, d_raws, jnp.all(d_fin_rows)))
            slots, raws, fin = _unpack_hits(packed, k)
            if fin:
                all_finite = np.repeat(True, qs.shape[0])
            else:
                all_finite = np.asarray(jax.device_get(d_fin_rows))
        n = min(limit, len(self._slot_of))
        results = []
        for b in range(qs.shape[0]):
            if not bool(all_finite[b]):
                results.append(self._host_search(qs[b], limit))
            else:
                results.append(
                    [(self._ids[int(s)], float(r)) for s, r in zip(slots[b, :n], raws[b, :n])]
                )
        return results

    def search_batch_device(self, queries_device, limit: int):
        """Device-to-device search: takes a resident [B, d] f32 query block,
        returns (slots, raws) device arrays with no host transfer. This is the
        serving/pipelining path — callers own staging and result fetch."""
        self._sync_device()
        x, valid, lex_order = self._device
        k = bucket_limit(min(limit, max(len(self._slot_of), 1)), self._cap)
        if self._fused_eligible(k):
            slots, raws, _ranks, _fin = self._fused_dispatch(queries_device, k)
            return slots, raws
        slots, raws, _ranks, _fin = _search_kernel_batch(
            x, valid, lex_order, queries_device, self._xla_scale(),
            metric=self.metric, limit=k
        )
        return slots, raws

    def candidate_slots_device(self, queries_device, count: int):
        """Hybrid-generator path: returns device ``(slots [B, k], ok [B, k])``
        where ``ok`` masks pad/invalid rows (rank +inf). Slots index this
        index's internal slot order."""
        self._sync_device()
        x, valid, lex_order = self._device
        k = bucket_limit(min(count, max(len(self._slot_of), 1)), self._cap)
        if self._fused_eligible(k):
            slots, _raws, ranks, _fin = self._fused_dispatch(queries_device, k)
        else:
            slots, _raws, ranks, _fin = _search_kernel_batch(
                x, valid, lex_order, queries_device, self._xla_scale(),
                metric=self.metric, limit=k
            )
        return slots, jnp.isfinite(ranks)

    def _host_search(self, q: np.ndarray, limit: int) -> list:
        """float64 fallback when f32 scoring overflowed — the analog of the
        reference's per-pair f64 recovery (distances.rs:59-98). Raises
        MetricOverflow when a value is genuinely unrepresentable."""
        from ..ops.distance import _check_f32, _raw_f64

        hits = []
        for id, slot in self._slot_of.items():
            row = self._host_x[slot].astype(np.float64)
            value = _raw_f64(self.metric, q, row)
            if self.metric not in ("hamming", "jaccard"):
                value = _check_f32(value)
            hits.append((rank_value(self.metric, value), id, value))
        hits.sort(key=lambda h: (h[0], h[1]))
        return [(id, raw) for _, id, raw in hits[:limit]]
